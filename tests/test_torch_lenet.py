"""LeNet-MNIST imperative (BASELINE config #1, ``bench.py:280-310``) in the
PyTorch port against the JAX package, on the CPU, through ``mx.np`` arrays
and the loop a user writes: ``autograd.record()`` -> ``L.backward()`` on
the per-sample loss NDArray -> ``trainer.step(batch)``. Weights cross from
the JAX net by ``convert.load_jax_params``; inputs and int32 labels are
numpy data made from a seed, handed to both.

Tolerance: 1e-4 relative (of each tensor's largest value) in float32 for
logits, losses, gradients and parameters over 3 SGD-momentum steps.
"""
import numpy as onp
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

BATCH = 16
OPT = {"learning_rate": 0.05, "momentum": 0.9}


def _batch(seed=4):
    r = onp.random.RandomState(seed)
    return (r.uniform(0, 1, (BATCH, 1, 28, 28)).astype("f"),
            r.randint(0, 10, (BATCH,)).astype("int32"))


def _pair(x):
    jmx.seed(2)
    jnet = jvision.lenet(classes=10)
    jnet.initialize()
    jnet(jmx.np.array(x))   # the deferred shapes
    tnet = tvision.lenet(classes=10)
    tnet.initialize(device=mt.cpu())
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _close(got, want, what):
    got = onp.asarray(got, dtype="f")
    want = onp.asarray(want, dtype="f")
    scale = max(float(onp.abs(want).max()), 1e-6)
    err = float(onp.abs(got - want).max())
    assert err <= 1e-4 * scale, f"{what}: {err:.3g} (scale {scale:.3g})"


def test_lenet_names_and_shapes_match_the_jax_lenet():
    x, _ = _batch()
    jnet, tnet = _pair(x)
    jshapes = {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    tshapes = {k: tuple(p.shape) for k, p in tnet.collect_params().items()}
    assert list(tshapes) == list(jshapes)
    assert tshapes == jshapes
    assert len(tshapes) == 10 and tshapes["features.5.weight"] == (120, 400)


def test_three_imperative_sgd_momentum_steps_match_the_jax_package():
    x, y = _batch()
    jnet, tnet = _pair(x)
    jlf = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tlf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    jx, jy = jmx.np.array(x), jmx.np.array(y)
    with mt.cpu():
        tx, ty = mt.np.array(x), mt.np.array(y)
    assert ty.dtype == onp.int32 and tx.dtype == onp.float32
    losses = []
    for step in range(3):
        with jmx.autograd.record():
            jout = jnet(jx)
            jl = jlf(jout, jy)
        jl.backward()
        jtr.step(BATCH)
        with mt.autograd.record():
            tout = tnet(tx)
            tl = tlf(tout, ty)
        assert isinstance(tout, mt.NDArray) and isinstance(tl, mt.NDArray)
        tl.backward()
        ttr.step(BATCH)
        _close(tout.asnumpy(), jout.asnumpy(), f"step {step} logits")
        _close(tl.asnumpy(), jl.asnumpy(), f"step {step} losses")
        jps, tps = jnet.collect_params(), tnet.collect_params()
        for k in jps:
            _close(tps[k].grad().numpy(), jps[k].grad().asnumpy(),
                   f"step {step} grad {k}")
            _close(tps[k]._tensor().detach().numpy(), jps[k].data().asnumpy(),
                   f"step {step} param {k}")
        losses.append(float(tl.mean()))
    assert losses[-1] < losses[0]


def test_get_model_lenet_and_raw_tensors_through_the_block_boundary():
    net = tvision.get_model("lenet", classes=7)
    assert isinstance(net, tvision.LeNet)
    net.initialize(device=mt.cpu())
    x, _ = _batch()
    out = net(torch.from_numpy(x))             # raw tensors stay tensors
    assert isinstance(out, torch.Tensor) and out.shape == (BATCH, 7)
    with mt.cpu():
        nd_out = net(mt.np.array(x))
    assert isinstance(nd_out, mt.NDArray)
    onp.testing.assert_array_equal(nd_out.asnumpy(), out.detach().numpy())
    assert not nd_out._data.requires_grad      # nothing recorded outside
