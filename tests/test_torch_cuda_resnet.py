"""The ResNet slice's CUDA kernels on the card: the BatchNorm-training
forward (K1) and backward (K2) kernels against their plain versions, and the
launch counts and gradients of one recorded step of a narrow ResNet. Marked
``cuda``; every test skips without a card. The file imports no JAX, so it
runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_resnet.py
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.kernels import build, dispatch, norm as knorm, opt as kopt
from mxnet_tpu_torch.tools.train_resnet import build_resnet_train

# (shape, axis, dtype, MXTPU_BN_COMPUTE, non-zero dmean/dvar, elements the
# tensors' views start into their storage)
BN_CASES = [
    ((8, 14, 14, 256), -1, torch.bfloat16, "f32", False, 0),  # NHWC, the path
    ((16, 7, 7, 2048), -1, torch.bfloat16, "bf16", True, 0),
    ((4, 40, 9, 11), 1, torch.float32, "f32", True, 0),       # NCHW
    ((3, 5, 7, 3), -1, torch.float32, "f32", False, 0),       # C = 3, ragged M
    ((5, 100, 3), 1, torch.bfloat16, "f32", True, 0),         # C = 100, NCW
    ((3, 7, 11, 8), -1, torch.bfloat16, "f32", True, 0),      # C = 8, ragged
    ((4, 9, 9, 64), -1, torch.bfloat16, "f32", True, 1),      # base off 16 B
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _offset_view(t, offset):
    """``t`` as a view ``offset`` elements into a storage of its own."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _operands(shape, axis, dtype, dev, seed=0, offset=0):
    r = onp.random.RandomState(seed)
    c = shape[axis]
    x = _offset_view(torch.from_numpy((r.standard_normal(shape) * 2.0 + 1.5)
                                      .astype("f")).to(dev).to(dtype), offset)
    gamma, beta = (torch.from_numpy(r.uniform(0.5, 1.5, c).astype("f"))
                   .to(dev) for _ in range(2))
    shift = torch.from_numpy((r.standard_normal(c) * 0.1 + 1.5)
                             .astype("f")).to(dev)
    dy = _offset_view(torch.from_numpy(r.standard_normal(shape).astype("f"))
                      .to(dev).to(dtype), offset)
    dmean, dvar = (torch.from_numpy(r.standard_normal(c).astype("f"))
                   .to(dev) for _ in range(2))
    return x, gamma, beta, shift, dy, dmean, dvar


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis,dtype,compute,cts,offset", BN_CASES)
def test_cuda_bn_kernels_match_plain(cuda_device, monkeypatch, shape, axis,
                                     dtype, compute, cts, offset):
    monkeypatch.setenv("MXTPU_BN_COMPUTE", compute)
    axis = axis % len(shape)
    x, gamma, beta, shift, dy, dmean, dvar = _operands(
        shape, axis, dtype, cuda_device, offset=offset)
    # the wrappers ask for the 16-byte kernels exactly where they can run
    # (channels last, whole 16-byte rows, bases on 16 bytes)
    vector = knorm.launch_geometry(shape, axis, x.element_size(), 132,
                                   x.data_ptr() % 16 == 0
                                   and dy.data_ptr() % 16 == 0
                                   ).regime == "vector"
    assert vector == (axis == len(shape) - 1
                      and shape[axis] * x.element_size() % 16 == 0
                      and offset == 0)
    if not cts:
        dmean, dvar = torch.zeros_like(dmean), torch.zeros_like(dvar)
    before = (knorm.LAUNCHES_FWD.value, knorm.LAUNCHES_BWD.value)
    got_f = knorm.bn_train_fwd(x, gamma, beta, shift, 1e-5, axis)
    want_f = knorm.bn_train_fwd_reference(x, gamma, beta, shift, 1e-5, axis)
    bwd_args = (x, gamma, shift, want_f[1], want_f[3], dy, dmean, dvar, axis)
    got_b = knorm.bn_train_bwd(*bwd_args)
    want_b = knorm.bn_train_bwd_reference(*bwd_args)
    again = knorm.bn_train_fwd(x, gamma, beta, shift, 1e-5, axis)
    again_b = knorm.bn_train_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert (knorm.LAUNCHES_FWD.value, knorm.LAUNCHES_BWD.value) == (
        before[0] + 2, before[1] + 2)
    # no atomics: the same inputs give the same bits
    assert all(torch.equal(a, b) for a, b in zip(got_f, again))
    assert all(torch.equal(a, b) for a, b in zip(got_b, again_b))
    # statistics: f32 sums in another order (1e-5 relative). out and dx:
    # one rounding of the result to x's dtype, and in bf16 elementwise
    # mode coefficients that may round to a neighbouring bf16 value
    low = dtype == torch.bfloat16
    tol = (dict(atol=6e-2, rtol=2e-2) if compute == "bf16" and low
           else dict(atol=2e-2, rtol=1e-2) if low
           else dict(atol=1e-4, rtol=1e-4))
    for a, w in zip(got_f[1:], want_f[1:]):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_f[0].float(), want_f[0].float(), **tol)
    torch.testing.assert_close(got_b[0].float(), want_b[0].float(), **tol)
    for a, w in zip(got_b[1:], want_b[1:]):
        scale = w.abs().max().item()
        torch.testing.assert_close(a, w, atol=1e-4 * scale, rtol=1e-4)
    assert got_f[0].dtype == dtype and got_b[0].dtype == dtype


@pytest.mark.cuda
def test_cuda_bn_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.ones(4, 8, device=cuda_device, dtype=torch.float16)
    v = torch.ones(8, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        knorm.bn_train(x, v, v, v, 1e-5, 1)
    with pytest.raises(ValueError, match="per-channel"):
        knorm.bn_train(x.float(), v.cpu(), v, v, 1e-5, 1)


def _narrow(layout):
    return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 32, 64, 128], classes=10, layout=layout,
                           stem_s2d=layout == "NHWC")


@pytest.mark.cuda
def test_cuda_resnet_step_launches_and_matches_cpu(cuda_device):
    """One f32 step of a narrow ResNet, NHWC with the s2d stem: 17 BN sites
    each launch K1 and K2 once, the 53 trainable tensors (one f32 bucket)
    K3 once, all 53 in that launch; loss,
    every gradient and every running stat equal the CPU run's (f32 on both
    sides, TF32 off; cuDNN and the kernels sum in another order)."""
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for where in (cuda_device, mt.cpu()):
        net, trainer, step = build_resnet_train(
            batch=4, dtype="float32", device=where, seed=3, image=64,
            classes=10, model=_narrow("NHWC"))
        build.reset_counters()
        kopt.TENSORS.reset()
        dispatch.reset_counts()
        loss = step().cpu()
        launches = {c.name: c.value for c in build.COUNTERS.values()}
        launches["opt_ladder_tensors"] = kopt.TENSORS.value
        params = {k: p._tensor().detach().float().cpu()
                  for k, p in net.collect_params().items()}
        grads = {k: p.grad().float().cpu()
                 for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        res[where.type] = (loss, params, grads, launches,
                           dict(dispatch.COUNTS))
    closs, cparams, cgrads, launches, outcomes = res["cuda"]
    ploss, pparams, pgrads, _, _ = res["cpu"]
    assert launches["bn_train_fwd"] == launches["bn_train_bwd"] == 17
    assert launches["opt_ladder"] == 1
    assert launches["opt_ladder_tensors"] == len(cgrads) == 53
    assert outcomes == {("bn_fwd", "kernel"): 17, ("bn_bwd", "kernel"): 17,
                        ("opt_sgd", "kernel"): 53}
    torch.testing.assert_close(closs, ploss, atol=1e-4, rtol=1e-4)
    big = max(g.abs().max().item() for g in pgrads.values())
    for k in pgrads:
        torch.testing.assert_close(cgrads[k], pgrads[k], atol=1e-3 * big,
                                   rtol=0, msg=k)
    for k in pparams:
        torch.testing.assert_close(cparams[k], pparams[k], atol=1e-4,
                                   rtol=1e-4, msg=k)
