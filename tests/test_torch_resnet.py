"""ResNet training in the PyTorch port against the JAX package, on the CPU,
through the entry points a user calls (``autograd.record()`` -> backward on
the per-sample loss -> ``Trainer.step``), from the same weights (carried
across by ``convert.load_jax_params``, running stats and NHWC conv weights
included) on the same batch.

Narrow nets: ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
classes=10)`` NHWC with the space-to-depth stem, and the same widths as
``ResNetV2(BottleneckV2, ...)`` NCHW; batch 4 of 32x32 images. On the CPU
both packages' BatchNorm take their plain versions. Also: ResNet-50's
parameter names and shapes, and mixed precision's f32 BatchNorm
parameters meeting bf16 weights in one Trainer.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

B, IMG, CLASSES = 4, 64, 10
WIDTHS = [8, 16, 32, 64, 128]
# lr 1e-3: from 1e-2 up, three momentum steps of so small a net amplify
# the frameworks' rounding differences (1e-5 of a gradient) to 1e-1
OPT = dict(learning_rate=1e-3, momentum=0.9, wd=1e-4, multi_precision=True)


def _narrow(pkg, version, layout):
    block = (pkg.BottleneckV1, pkg.BottleneckV2)[version - 1]
    net = (pkg.ResNetV1, pkg.ResNetV2)[version - 1]
    return net(block, [1, 1, 1, 1], WIDTHS, classes=CLASSES, layout=layout,
               stem_s2d=layout == "NHWC")


def _batch(layout, seed=5):
    r = onp.random.RandomState(seed)
    shape = (B, IMG, IMG, 3) if layout == "NHWC" else (B, 3, IMG, IMG)
    return (r.standard_normal(shape).astype("f"),
            r.randint(0, CLASSES, (B,)).astype("int32"))


def _jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _build_pair(version, layout, x, dtype=None):
    mx.seed(11)
    jnet = _narrow(jresnet, version, layout)
    jnet.initialize()
    jnet.hybridize()  # one jit program per mode: eager JAX is slow here
    jnet(mx.np.array(x))  # predict mode: the deferred shapes, no stats
    tnet = _narrow(tresnet, version, layout)
    tnet.initialize(device=mt.cpu())
    load_jax_params(tnet, _jax_params(jnet))
    if dtype is not None:
        jamp.convert_hybrid_block(jnet, dtype)
        mt.amp.convert_hybrid_block(tnet, dtype)
    return jnet, tnet


def _jax_step(jnet, jtr, x, y):
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        logits = jnet(mx.np.array(x))
        L = lf(logits.astype("float32"), mx.np.array(y))
    L.backward()
    grads = {k: p.grad().asnumpy().astype("f")
             for k, p in jnet.collect_params().items()
             if p.grad_req != "null"}
    jtr.step(B)
    return logits.asnumpy().astype("f"), L.asnumpy(), grads


def _torch_step(tnet, ttr, x, y):
    lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        logits = tnet(torch.from_numpy(x))
        L = lf(logits.float(), torch.from_numpy(y).long())
    mt.autograd.backward(L)
    grads = {k: p.grad().float().numpy().copy()
             for k, p in tnet.collect_params().items()
             if p.grad_req != "null"}
    ttr.step(B)
    return (logits.detach().float().numpy(), L.detach().numpy(), grads)


def _close(got, want, rtol, msg=""):
    """Within ``rtol`` of each element and ``rtol`` of the tensor's largest
    element (f32 errors grow with the scale of what was summed)."""
    want = onp.asarray(want, "f")
    onp.testing.assert_allclose(onp.asarray(got, "f"), want, rtol=rtol,
                                atol=rtol * onp.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("version,layout,steps", [(1, "NHWC", 3),
                                                   (2, "NCHW", 2)])
def test_narrow_resnet_training_matches_jax(version, layout, steps):
    """Logits, loss and every gradient of the first step, the running stats
    and the loss of every step, and every parameter after the last, within
    1e-4 relative (f32; the frameworks sum in other orders through 17
    BatchNorm sites). Gradients: 1e-4 of the largest gradient of the net,
    since a few (the stem's gamma) are 1e-5 of it and mostly cancellation."""
    x, y = _batch(layout)
    jnet, tnet = _build_pair(version, layout, x)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    for step in range(steps):
        jl, jloss, jg = _jax_step(jnet, jtr, x, y)
        tl, tloss, tg = _torch_step(tnet, ttr, x, y)
        _close(tloss, jloss, 1e-4, f"loss, step {step}")
        if step == 0:
            _close(tl, jl, 1e-4, "logits")
            assert sorted(tg) == sorted(jg)
            big = max(onp.abs(g).max() for g in jg.values())
            for k in jg:
                onp.testing.assert_allclose(tg[k], jg[k], rtol=1e-4,
                                            atol=1e-4 * big, err_msg=k)
        jp = _jax_params(jnet)
        for k, p in tnet.collect_params().items():
            if p.grad_req == "null" or step == steps - 1:
                # a parameter that starts at 0 (beta) is lr times its
                # gradients: held to 1e-4 of the largest gradient's step too
                onp.testing.assert_allclose(
                    p._tensor().detach().numpy(), jp[k], rtol=1e-4,
                    atol=max(1e-4 * onp.abs(jp[k]).max(),
                             1e-4 * OPT["learning_rate"] * steps * big),
                    err_msg=k)
    sites = sum(isinstance(m, mt.gluon.nn.BatchNorm) for m in tnet.modules())
    assert sites == (17 if version == 1 else 15)
    frozen = [k for k, p in tnet.collect_params().items()
              if p.grad_req == "null"]
    # V2's first BatchNorm has neither scale nor centre: gamma, beta frozen
    assert len(frozen) == 2 * sites + 2 * (version == 2)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == steps


def test_resnet50_v1_nhwc_parameters_match_jax():
    """resnet50_v1(layout="NHWC", stem_s2d=True): the same dotted names in
    the same order and, once a forward has settled the deferred input
    channels, the same shapes: 161 trainable tensors (25.6 M values) and
    106 running stats."""
    jnet = jresnet.resnet50_v1(layout="NHWC", stem_s2d=True)
    jnet.initialize()
    jnet(mx.np.ones((1, IMG, IMG, 3)))
    tnet = tresnet.resnet50_v1(layout="NHWC", stem_s2d=True)
    tnet.initialize(device=mt.cpu())
    with mt.autograd.pause():
        tnet(torch.ones(1, IMG, IMG, 3))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp) == list(jp)
    assert {k: tuple(p.shape) for k, p in tp.items()} == {
        k: tuple(p.shape) for k, p in jp.items()}
    assert tnet.trainable_param_names() == jnet.trainable_param_names()
    assert len(tnet.trainable_param_names()) == 161
    assert sum(p._tensor().numel() for k, p in tp.items()
               if p.grad_req != "null") == 25_557_032
    assert sum(p.grad_req == "null" for p in tp.values()) == 106


def test_bf16_mixed_precision_step_keeps_batchnorm_f32():
    """amp's offline cast leaves BatchNorm's gamma, beta and running stats
    f32 in both packages. One Trainer then updates the bf16 weights through
    f32 masters and the f32 gamma/beta directly, all with SGD momentum
    (each to 1e-6 of the rule applied to its own gradient), and leaves the
    running stats to the layers. The loss against the JAX package: 3e-2
    relative, since at this size bf16 rounding moves the gradients of
    either package by a third of their f32 values."""
    x, y = _batch("NHWC", seed=6)
    jnet, tnet = _build_pair(1, "NHWC", x, dtype="bfloat16")
    jd = {k: p.data().dtype.name for k, p in jnet.collect_params().items()}
    td = {k: str(p._tensor().dtype).replace("torch.", "")
          for k, p in tnet.collect_params().items()}
    assert td == jd
    assert {k.rsplit(".", 1)[1] for k, v in td.items() if v == "float32"} \
        == {"gamma", "beta", "running_mean", "running_var"}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    _, jloss, _ = _jax_step(jnet, jtr, x, y)
    before = {k: p._tensor().detach().float().clone()
              for k, p in tnet.collect_params().items()}
    _, tloss, grads = _torch_step(tnet, ttr, x, y)
    _close(tloss, jloss, 3e-2, "bf16 loss")
    lr, wd = OPT["learning_rate"], OPT["wd"]
    for name, state, p in zip(ttr._param_names, ttr._states, ttr._params):
        w0, w = before[name], p._tensor().detach()
        if p.grad_req == "null":  # running stats: the layer's update
            assert not torch.equal(w, w0), name
            continue
        mp = td[name] == "bfloat16"
        assert isinstance(state, tuple) == mp, name  # (master, momentum)
        master = state[0] if mp else w
        assert master.dtype == torch.float32
        step = -lr * (torch.from_numpy(grads[name]) / B + wd * w0)
        torch.testing.assert_close(master, w0 + step, atol=1e-6, rtol=1e-6,
                                   msg=name)
        if mp:
            assert torch.equal(w, master.to(torch.bfloat16)), name
