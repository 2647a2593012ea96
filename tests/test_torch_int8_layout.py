"""Q1's channels-last codes, the channels-last int8 weight, and Q2's plan
(``kernels/int8.py:plan_conv``) and K order on the CPU, held against the
JAX package (its 64-bit types on, as ``import mxnet_tpu`` sets them), with
inputs made from a numpy seed:

- Q1 with ``channels_last`` gives the reference's ``_q`` codes and scale
  bit for bit (.5 ties included), stored NHWC;
- a quantized convolution whose C/groups is a multiple of 16 holds its
  int8 weight OIHW logical and OHWI physical, with the reference's values;
  QuantizedConv2D and QuantizedDense on those buffers equal the
  reference's forward within 1e-6 of the largest output;
- the plan gives one variant, tile and split for each of ResNet-50 v1's
  54 quantized sites at batch 1, 8 and 32 and for chip_smoke.py phase
  25's three extra sites, the gather variant exactly where C/groups is not
  a multiple of 16 (the stem and the depthwise site);
- a numpy model of the wgmma variant's operand walk (a producer thread's
  16-code chunk of an operand row stepped over (r, s, c) by 128 codes a
  stage, c innermost; padded taps, pixels past M and K past its end as
  zeros; K cut into the plan's splits and their int32 sums added) gives
  the sums of ``conv_reference`` and of the reference's
  ``conv_general_dilated`` bit for bit.
"""
import numpy as onp
import pytest

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.kernels import int8 as kint8
import torch

import chip_smoke


def _pair(make, x, seed):
    """The same layer in both packages, initialized by the JAX package and
    carried to the port (a forward on ``x`` settles deferred shapes)."""
    jmx.seed(seed)
    jl = make(jmx)
    jl.initialize()
    jl(jmx.np.array(x))
    with mt.cpu():
        tl = make(mt)
        tl.initialize(device=mt.cpu())
        tl(mt.np.array(x))
    load_jax_params(tl, {k: p.data().asnumpy()
                         for k, p in jl.collect_params().items()})
    return tl, jl


def test_channels_last_codes_equal_the_reference():
    assert jax.config.jax_enable_x64
    rs = onp.random.RandomState(0)
    x = rs.uniform(-3, 3, (2, 32, 5, 7)).astype("f")
    # .5 ties of x * scale at scale 1 (the range's largest magnitude 127)
    x.reshape(-1)[:8] = [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, -126.5]
    for lo, hi, clip in ((-127.0, 127.0, False), (-1.3, 2.1, True)):
        xd = jnp.clip(jnp.asarray(x), lo, hi) if clip else jnp.asarray(x)
        jcodes, jscale = jq._q(xd, jnp.float32(lo), jnp.float32(hi))
        codes, info = kint8.quantize(torch.from_numpy(x),
                                     torch.tensor([lo, hi]), clip,
                                     channels_last=True)
        assert codes.is_contiguous(memory_format=torch.channels_last)
        assert codes.stride() == (32 * 35, 1, 7 * 32, 32)
        onp.testing.assert_array_equal(codes.numpy(), onp.asarray(jcodes))
        assert info[2].item() == float(jscale)
        amax = onp.float32(127.0) / onp.float32(jscale)
        assert info.tolist() == [-float(amax), float(amax), float(jscale)]
    with pytest.raises(ValueError):
        kint8.quantize(torch.zeros(4, 16), torch.tensor([-1.0, 1.0]),
                       channels_last=True)


#: (in channels, channels, kernel, strides, padding, dilation, groups,
#:  bias, activation, calibrated range or None for dynamic)
_CONVS = (
    (16, 24, 3, 1, 1, 1, 1, True, "relu", (-0.9, 0.9)),
    (32, 8, 1, 2, 0, 1, 1, False, None, None),
    (32, 16, 3, 1, 2, 2, 2, True, "tanh", (-1.2, 1.2)),
)


def test_conv_and_dense_on_channels_last_buffers_against_the_reference():
    rs = onp.random.RandomState(2)
    worst = 0.0
    for cin, ch, k, s, p, d, g, bias, act, rng in _CONVS:
        x = rs.uniform(-1, 1, (2, cin, 9, 9)).astype("f")

        def make(m, cin=cin, ch=ch, k=k, s=s, p=p, d=d, g=g, bias=bias,
                 act=act):
            return m.gluon.nn.Conv2D(ch, k, strides=s, padding=p,
                                     dilation=d, groups=g, use_bias=bias,
                                     activation=act, in_channels=cin,
                                     bias_initializer="normal")

        tl, jl = _pair(make, x, 4)
        tqz, jqz = tq.QuantizedConv2D(tl, rng), jq.QuantizedConv2D(jl, rng)
        # the int8 weight: OIHW logical, OHWI in memory, the same values
        w = tqz._wq
        assert tqz._channels_last and w.dtype == torch.int8
        assert w.is_contiguous(memory_format=torch.channels_last)
        assert w.permute(0, 2, 3, 1).is_contiguous()
        onp.testing.assert_array_equal(w.numpy(), jqz._wq)
        onp.testing.assert_array_equal(tqz._wscale.numpy(), jqz._wscale)
        with mt.cpu():
            got = tqz(mt.np.array(x)).asnumpy()
        want = onp.asarray(jqz(jmx.np.array(x)).asnumpy())
        assert got.shape == want.shape and got.dtype == want.dtype
        err = onp.abs(got - want).max() / onp.abs(want).max()
        assert err <= 1e-6
        worst = max(worst, err)
    for flatten, shape, rng in ((True, (3, 16, 2, 2), (-0.8, 0.8)),
                                (False, (2, 3, 32), None)):
        x = rs.uniform(-1, 1, shape).astype("f")

        def make(m, flatten=flatten):
            return m.gluon.nn.Dense(40, activation="relu", flatten=flatten,
                                    bias_initializer="normal")

        tl, jl = _pair(make, x, 5)
        tqz, jqz = tq.QuantizedDense(tl, rng), jq.QuantizedDense(jl, rng)
        assert not tqz._channels_last
        onp.testing.assert_array_equal(tqz._wq.numpy(), jqz._wq)
        with mt.cpu():
            got = tqz(mt.np.array(x)).asnumpy()
        want = onp.asarray(jqz(jmx.np.array(x)).asnumpy())
        assert got.shape == want.shape
        err = onp.abs(got - want).max() / onp.abs(want).max()
        assert err <= 1e-6
        worst = max(worst, err)
    assert worst <= 1e-6


def _check_plan(plan, site):
    xs, ws, stride, pad, dil, groups = site[:6]
    assert plan == kint8.plan_conv(xs, ws, stride, pad, dil, groups)
    if plan.variant == "gather":
        assert ws[1] % 16 and plan == kint8.ConvPlan("gather", 64, 1)
        return
    assert plan.variant == "wgmma" and ws[1] % 16 == 0
    assert plan.bm in (64, 128)
    steps = -(-ws[1] * ws[2] * ws[3] // 128)
    per = -(-steps // plan.split)
    assert 1 <= plan.split <= min(steps, 16)
    assert (plan.split - 1) * per < steps       # no split is empty


def test_plan_of_resnet50_and_the_extra_sites():
    by_batch = chip_smoke.int8_sites(torch, mt, vision, torch.device("cpu"),
                                     (1, 8, 32))
    for batch, sites in by_batch.items():
        assert sum(count for _, count in sites) == 54
        layers = {"wgmma": 0, "gather": 0}
        for site, count in sites:
            plan = kint8.plan_conv(*site[:6])
            _check_plan(plan, site)
            layers[plan.variant] += count
            if site[0][1] == 3:                    # the stem, C = 3
                assert plan.variant == "gather"
        assert layers == {"wgmma": 53, "gather": 1}, (batch, layers)
    # batch 1's few pixels: the plan splits K somewhere
    assert any(kint8.plan_conv(*s[:6]).split > 1 for s, _ in by_batch[1])
    # chip_smoke.py phase 25's extra sites: dilation 2, groups 2, depthwise
    variants = []
    for xs, ws, stride, pad, dil, groups in (
            ((2, 16, 28, 28), (32, 16, 3, 3), 1, 2, 2, 1),
            ((2, 16, 28, 28), (32, 8, 3, 3), 2, 1, 1, 2),
            ((2, 32, 28, 28), (32, 1, 3, 3), 1, 1, 1, 32)):
        plan = kint8.plan_conv(xs, ws, stride, pad, dil, groups)
        _check_plan(plan, (xs, ws, stride, pad, dil, groups))
        variants.append(plan.variant)
    assert variants == ["wgmma", "gather", "gather"]


def _operand_walk(xq, wq, stride, pad, dil, groups, plan):
    """The wgmma variant's sums as its threads walk K: x NHWC, w [O, K]
    with k = (r, s, c); each producer thread's chunk j of a 128-code stage
    starts at (r, s, c) of k = 16 j and steps by 128 codes, c innermost,
    a chunk at a padded tap, a pixel past M or a k past K all zeros; each
    split's int64 sums, added. Also checks that the stepped (r, s, c) is
    the chunk's k."""
    n, c, h, w = xq.shape
    o, cg, kh, kw = wq.shape
    _, _, oh, ow = kint8.conv_out_shape(xq.shape, wq.shape, stride, pad,
                                        dil)
    x = xq.permute(0, 2, 3, 1).numpy().astype(onp.int64)
    wk = wq.permute(0, 2, 3, 1).reshape(o, -1).numpy().astype(onp.int64)
    k, og, steps = cg * kh * kw, o // groups, -(-cg * kh * kw // 128)
    per = -(-steps // plan.split)
    nn, ohh, oww = onp.meshgrid(onp.arange(n), onp.arange(oh),
                                onp.arange(ow), indexing="ij")
    ih0 = (ohh * stride[0] - pad[0]).reshape(-1)
    iw0 = (oww * stride[1] - pad[1]).reshape(-1)
    nn = nn.reshape(-1)
    out = onp.zeros((n * oh * ow, o), onp.int64)
    for g in range(groups):
        for sp in range(plan.split):
            kt0 = sp * per
            nkt = min(steps, kt0 + per) - kt0
            a = onp.zeros((n * oh * ow, nkt * 128), onp.int64)
            for j in range(8):
                kk = kt0 * 128 + 16 * j
                tap, cc = divmod(kk, cg)
                r, s = divmod(tap, kw)
                for i in range(nkt):
                    at = (kt0 + i) * 128 + 16 * j
                    if r < kh:
                        assert (r * kw + s) * cg + cc == at < k
                        ih, iw = ih0 + r * dil[0], iw0 + s * dil[1]
                        ok = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
                        rows = x[nn, onp.clip(ih, 0, h - 1),
                                 onp.clip(iw, 0, w - 1),
                                 g * cg + cc:g * cg + cc + 16]
                        a[:, 128 * i + 16 * j:128 * i + 16 * j + 16] = \
                            onp.where(ok[:, None], rows, 0)
                    else:
                        assert at >= k
                    cc += 128
                    while cc >= cg and r < kh:
                        cc -= cg
                        s += 1
                        if s == kw:
                            s, r = 0, r + 1
            b = onp.zeros((og, nkt * 128), onp.int64)
            lo, hi = kt0 * 128, min(k, (kt0 + nkt) * 128)
            b[:, :hi - lo] = wk[g * og:(g + 1) * og, lo:hi]
            out[:, g * og:(g + 1) * og] += a @ b.T
    return torch.from_numpy(out.reshape(n, oh, ow, o)).permute(
        0, 3, 1, 2).to(torch.int32)


#: (x shape, weight shape, stride, padding, dilation, groups, splits)
_WALKS = (
    ((2, 64, 7, 7), (24, 64, 1, 1), 1, 0, 1, 1, (1,)),
    ((2, 64, 9, 9), (16, 64, 3, 3), 1, 1, 1, 1, (1, 2, 5)),
    ((1, 48, 9, 11), (20, 48, 3, 3), 2, 1, 1, 1, (1, 2, 4)),
    ((2, 16, 12, 12), (32, 16, 3, 3), 1, 2, 2, 1, (1, 2)),
    ((1, 64, 8, 8), (32, 32, 3, 3), 1, 1, 1, 2, (1, 3)),
    ((3, 272, 5, 5), (40, 272, 1, 1), 2, 0, 1, 1, (1, 2, 3)),
)


@pytest.mark.parametrize("case", range(len(_WALKS)))
def test_operand_walk_gives_the_reference_sums(case):
    xs, ws, stride, pad, dil, groups, splits = _WALKS[case]
    rs = onp.random.RandomState(10 + case)
    xq = torch.from_numpy(rs.randint(-127, 128, xs).astype(onp.int8))
    wq = torch.from_numpy(rs.randint(-127, 128, ws).astype(onp.int8))
    args = ((stride,) * 2, (pad,) * 2, (dil,) * 2, groups)
    want = kint8.conv_reference(xq, wq, *args)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), args[0],
        [(pad, pad)] * 2, rhs_dilation=args[2],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    onp.testing.assert_array_equal(want.numpy(), onp.asarray(ref))
    # the wrapper on the CPU: channels-last operands, NCHW sums
    got = kint8.conv(xq.contiguous(memory_format=torch.channels_last),
                     wq.contiguous(memory_format=torch.channels_last),
                     *args)
    assert got.is_contiguous() and torch.equal(got, want)
    for split in splits:
        plan = kint8.ConvPlan("wgmma", 64, split)
        assert torch.equal(_operand_walk(xq, wq, *args, plan), want)
