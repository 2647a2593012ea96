"""The INT8 kernels on the card: Q1 (``csrc/int8_quant.cu``, its flat and
its channels-last form) and Q2's variants (``csrc/int8_conv_wgmma.cu`` and
its split-K epilogue, ``csrc/int8_conv.cu``, the gather variant) against
their plain versions on the same CUDA tensors (codes, ranges and int32
sums bit for bit; the f32 epilogue bit for bit), on .5 ties, K tails
(3 x 7 x 7 = 147), padding, stride, dilation, groups 2 and depthwise, each
launch counted; the wgmma variant at every tile and with K split and not,
at small and ResNet-50 shapes, from channels-last codes and through the
wrapper's copy of NCHW ones; dequantize, requantize, quantized_conv and
quantized_fully_connected on the card against the CPU, bit for bit; then
a small net calibrated and quantized on the card against the same net
quantized on the CPU with the card's ranges (bit for bit), and
chip_smoke.py's phase 25b (config #5 served). Marked ``cuda``; the tests
skip without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_int8.py
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as qz
from mxnet_tpu_torch.kernels import build
from mxnet_tpu_torch.kernels import int8 as kint8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_q1_and_q2_against_their_plain_versions(card):
    gen = torch.Generator(device=card).manual_seed(0)
    ties = torch.tensor([-300.0, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5,
                         127.5], device=card)
    for x, lohi, clip in (
            (ties, torch.tensor([-127.0, 127.0], device=card), False),
            (torch.randn(1001, 37, device=card, generator=gen),
             torch.tensor([-1.0, 1.5], device=card), True),
            (torch.randn(3, 5, device=card, generator=gen)[:, 1:],
             torch.tensor([-0.3, 0.2], device=card), False)):
        before = kint8.LAUNCHES_QUANT.value
        got = kint8.quantize(x, lohi, clip)
        want = kint8.quantize_reference(x, lohi, clip)
        assert kint8.LAUNCHES_QUANT.value == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for xs, ws, stride, pad, dil, groups in (
            ((2, 3, 23, 23), (8, 3, 7, 7), 2, 3, 1, 1),
            ((2, 16, 9, 9), (24, 16, 3, 3), 1, 2, 2, 1),
            ((2, 16, 9, 9), (24, 8, 3, 3), 2, 1, 1, 2),
            ((2, 32, 9, 9), (32, 1, 3, 3), 1, 1, 1, 32),
            ((5, 2048, 1, 1), (1000, 2048, 1, 1), 1, 0, 1, 1),
            ((3, 100, 6, 6), (70, 100, 1, 1), 2, 0, 1, 1)):
        xq = torch.randint(-127, 128, xs, device=card, generator=gen,
                           dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, ws, device=card, generator=gen,
                           dtype=torch.int32).to(torch.int8)
        args = (stride, pad, dil, groups)
        before = kint8.conv_launches()
        acc = kint8.conv(xq, wq, *args)
        assert kint8.conv_launches() == before + 1
        with torch.backends.cudnn.flags(enabled=False):
            want = kint8.conv_reference(xq, wq, *args)
        assert torch.equal(acc, want)
        xscale = torch.tensor([37.5], device=card)
        wscale = torch.rand(ws[0], device=card, generator=gen) * 100 + 1
        bias = torch.randn(ws[0], device=card, generator=gen)
        for b, relu in ((None, False), (bias, True)):
            y = kint8.conv(xq, wq, *args, xscale, wscale, b, relu)
            assert torch.equal(y, kint8._epilogue(want, xscale, wscale, b,
                                                  relu))


@pytest.mark.cuda
def test_q1_channels_last_against_its_plain_version(card):
    gen = torch.Generator(device=card).manual_seed(2)
    lohi = torch.tensor([-1.0, 1.5], device=card)
    for shape in ((2, 64, 56, 56), (3, 48, 7, 7), (1, 3, 9, 10),
                  (2, 130, 5, 3), (4, 2048, 1, 1)):
        x = torch.randn(shape, device=card, generator=gen)
        x.view(-1)[:6] = torch.tensor([-0.5, 0.5, 1.5, -1.5, 2.5, 0.0],
                                      device=card) / 84.666664
        want = kint8.quantize_reference(x, lohi, True)
        for src in (x, x.contiguous(memory_format=torch.channels_last)):
            before = kint8.LAUNCHES_QUANT.value
            codes, info = kint8.quantize(src, lohi, True,
                                         channels_last=True)
            assert kint8.LAUNCHES_QUANT.value == before + 1
            assert codes.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(codes, want[0]) and torch.equal(info, want[1])


#: (x shape, weight shape, stride, padding, dilation, groups): small
#: shapes with K tails, padding, dilation, groups and a partial last tile,
#: then ResNet-50 v1's at batch 8 (a 1x1, a strided 1x1, a 3x3 at each
#: stage's width, the Dense as a 1x1 over a 1x1 plane)
_Q2_SITES = (
    ((2, 16, 9, 9), (24, 16, 3, 3), 1, 2, 2, 1),
    ((3, 48, 11, 7), (40, 48, 3, 3), 2, 1, 1, 1),
    ((2, 64, 8, 8), (48, 32, 3, 3), 1, 1, 1, 2),
    ((5, 272, 5, 5), (200, 272, 1, 1), 1, 0, 1, 1),
    ((8, 64, 56, 56), (256, 64, 1, 1), 1, 0, 1, 1),
    ((8, 256, 56, 56), (128, 256, 1, 1), 2, 0, 1, 1),
    ((8, 128, 28, 28), (128, 128, 3, 3), 1, 1, 1, 1),
    ((8, 512, 7, 7), (512, 512, 3, 3), 1, 1, 1, 1),
    ((8, 2048, 1, 1), (1000, 2048, 1, 1), 1, 0, 1, 1),
)


@pytest.mark.cuda
def test_q2_wgmma_tiles_and_splits_bit_for_bit(card):
    gen = torch.Generator(device=card).manual_seed(3)
    for xs, ws, stride, pad, dil, groups in _Q2_SITES:
        xq = torch.randint(-127, 128, xs, device=card, generator=gen,
                           dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, ws, device=card, generator=gen,
                           dtype=torch.int32).to(torch.int8)
        args = (stride, pad, dil, groups)
        with torch.backends.cudnn.flags(enabled=False):
            want = kint8.conv_reference(xq, wq, *args)
        xscale = torch.tensor([41.25], device=card)
        wscale = torch.rand(ws[0], device=card, generator=gen) * 100 + 1
        bias = torch.randn(ws[0], device=card, generator=gen)
        want_y = kint8._epilogue(want, xscale, wscale, bias, True)
        xcl = xq.contiguous(memory_format=torch.channels_last)
        wcl = wq.contiguous(memory_format=torch.channels_last)
        steps = -(-ws[1] * ws[2] * ws[3] // 128)
        splits = sorted({1, min(steps, 3), steps if steps <= 16 else 16})
        plans = [kint8.ConvPlan("wgmma", bm, sp)
                 for bm in (64, 128) for sp in splits
                 if (sp - 1) * -(-steps // sp) < steps]
        plans += [kint8.plan_conv(xs, ws, *args),
                  kint8.ConvPlan("gather", 64, 1)]
        for plan in plans:
            counts = [c.value for c in (kint8.LAUNCHES_CONV_WGMMA,
                                        kint8.LAUNCHES_CONV_GATHER,
                                        kint8.LAUNCHES_CONV_SPLITK)]
            acc = kint8.conv(xcl, wcl, *args, plan=plan)
            # a contiguous NCHW input through the wrapper's explicit copy
            y = kint8.conv(xq, wq, *args, xscale, wscale, bias, True,
                           plan=plan)
            wgmma, split = plan.variant == "wgmma", plan.split > 1
            assert [c.value for c in (kint8.LAUNCHES_CONV_WGMMA,
                                      kint8.LAUNCHES_CONV_GATHER,
                                      kint8.LAUNCHES_CONV_SPLITK)] == [
                counts[0] + 2 * wgmma, counts[1] + 2 * (not wgmma),
                counts[2] + 2 * split], plan
            assert acc.is_contiguous() and y.is_contiguous()
            assert torch.equal(acc, want), (xs, ws, plan)
            assert torch.equal(y, want_y), (xs, ws, plan)
    with pytest.raises(ValueError):
        xq = torch.zeros((1, 8, 4, 4), dtype=torch.int8, device=card)
        kint8.conv(xq, torch.zeros((8, 8, 1, 1), dtype=torch.int8,
                                   device=card),
                   plan=kint8.ConvPlan("wgmma", 64, 1))


@pytest.mark.cuda
def test_dequantize_and_the_rescaling_ops_card_against_cpu(card):
    # each range's scale max(|lo|, |hi|) / 127 is the f32 quotient on both
    # devices (a multiply by the reciprocal moves about 5 % of them by an
    # ulp), so the ops agree bit for bit
    gen = torch.Generator().manual_seed(1)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int32).to(torch.int8)

    q, ranges = codes(64, 33), torch.rand(200, 2, generator=gen) * 50 - 25
    for lo, hi in ranges:
        assert torch.equal(qz._dequantize(q.to(card), lo.to(card),
                                          hi.to(card)).cpu(),
                           qz._dequantize(q, lo, hi))
    acc = torch.randint(-2 ** 30, 2 ** 30, (40, 7), generator=gen,
                        dtype=torch.int32)
    x, w, b = codes(2, 4, 6, 6), codes(5, 4, 3, 3), codes(5)
    xm, wm = codes(3, 36), codes(5, 36)
    r = [torch.tensor(v) for v in (-1.3, 2.1, -0.7, 0.9, -0.2, 0.3)]
    for fn, args, kw in (
            (qz._requantize, (acc, r[0], r[1]), {}),
            (qz._requantize, (acc, r[0], r[1]),
             dict(min_calib_range=-0.5, max_calib_range=0.8)),
            (qz._quantized_conv, (x, w, b, *r), dict(pad=(1, 1))),
            (qz._quantized_fully_connected, (xm, wm, b, *r), {})):
        got = fn(*[t.to(card) for t in args], **kw)
        want = fn(*args, **kw)
        for g, t in zip(got, want):
            assert torch.equal(g.cpu(), t)


@pytest.mark.cuda
def test_small_net_quantized_on_the_card_and_the_cpu(card):
    x = torch.rand(4, 3, 12, 12)

    def make(dev):
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Conv2D(8, 3, activation="relu"),
                mt.gluon.nn.MaxPool2D(2), mt.gluon.nn.Flatten(),
                mt.gluon.nn.Dense(16, activation="relu"),
                mt.gluon.nn.Dense(4))
        net.initialize(device=dev,
                       generator=torch.Generator().manual_seed(0))
        net(x.to(dev))
        return net

    for mode in ("naive", "entropy"):
        gq, cq = make(card), make(torch.device("cpu"))
        theirs = gq.collect_params()
        for name, p in cq.collect_params().items():
            p.set_data(theirs[name].data()._data.cpu())
        qz.quantize_net(gq, calib_data=[x.to(card)], calib_mode=mode)
        # the CPU net takes the card's calibrated ranges: every int8 layer
        # and the pool between are exact, so the two agree bit for bit
        qz._swap(qz._targets(cq, set()),
                 {name: m._out_range for name, m in gq._modules.items()
                  if isinstance(m, (qz.QuantizedConv2D, qz.QuantizedDense))})
        build.reset_counters()
        got = gq(x.to(card))
        assert kint8.LAUNCHES_QUANT.value == kint8.conv_launches() == 3
        assert torch.equal(got.cpu(), cq(x))


@pytest.mark.cuda
def test_config5_served_in_int8(card):  # noqa: ARG001
    out = chip_smoke.phase_int8_serving(torch, mt)
    launches = out["serving"]["launches"]
    assert launches["int8_conv_wgmma"] + launches["int8_conv_gather"] == \
        54 * out["serving"]["batches"]
    assert out["twin"]["top1_equal"]
