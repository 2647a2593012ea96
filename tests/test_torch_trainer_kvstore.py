"""The Trainer's store arguments (``kvstore=``, ``compression_params=``,
``update_on_kvstore=``) and ``allreduce_grads`` against the JAX package's
Trainer on the CPU (64-bit types on): three SGD-momentum steps of a
two-layer Dense net from the same weights with each kind of store, the
dispatch order of the per-parameter and list forms, stale gradients and
the write-back's version bump, and TrainStep's three store reasons in the
JAX package's words. Parameters within rtol 1e-5, atol 1e-6, as the
trainer's other parity tests."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn

OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-3)
RS = onp.random.RandomState(4)
DATA = [(RS.randn(6, 8).astype("f"), RS.randint(0, 4, (6,)).astype("int32"))
        for _ in range(3)]


def _pair(seed=2):
    mx.seed(seed)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
             mx.gluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    tnet = tnn.HybridSequential(tnn.Dense(16, activation="relu", in_units=8),
                                tnn.Dense(4, in_units=16))
    tnet.initialize(device=mt.cpu())
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _train(jnet, tnet, jtr, ttr, data=DATA):
    jlf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tlf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in data:
        with mx.autograd.record():
            jl = jlf(jnet(mx.np.array(x)), mx.np.array(y))
        jl.backward()
        jtr.step(len(x))
        with mt.autograd.record():
            tl = tlf(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        mt.autograd.backward(tl)
        ttr.step(len(x))
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    rtol=1e-5, atol=1e-6)
    for k, p in jnet.collect_params().items():
        onp.testing.assert_allclose(
            tnet.collect_params()[k]._tensor().detach().numpy(),
            p.data().asnumpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["local", "device", "tpu_dist", "p3"])
def test_three_steps_with_each_store(kind):
    """Each store kind trains as the JAX Trainer with the same store. The
    distributed stores pushpull every gradient (one list-form call), and
    each write-back is a new gradient version."""
    jnet, tnet = _pair()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT),
                           kvstore=kind)
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT),
                           kvstore=kind)
    assert type(ttr._kvstore).__name__ == type(jtr._kvstore).__name__
    versions = [p._grad_version for p in ttr._params]
    _train(jnet, tnet, jtr, ttr)
    # a backward and, from a store that pushpulls, a write-back a step
    bumps = 2 if kind in ("tpu_dist", "p3") else 1
    assert [p._grad_version - v for p, v in zip(ttr._params, versions)] \
        == [3 * bumps] * len(versions)


def test_compression_params_and_update_on_kvstore():
    """2-bit compression on the store's pushpull trains as the JAX
    package's (the residual carried over steps); with
    ``update_on_kvstore=True`` the store holds the optimizer and the
    Trainer still updates locally, in both packages."""
    comp = {"type": "2bit", "threshold": 0.01}
    jnet, tnet = _pair()
    _train(jnet, tnet,
           mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT),
                            kvstore="tpu_dist", compression_params=comp),
           mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT),
                            kvstore="tpu_dist", compression_params=comp))
    jnet, tnet = _pair()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT),
                           kvstore="local", update_on_kvstore=True)
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT),
                           kvstore="local", update_on_kvstore=True)
    assert ttr._update_on_kvstore and jtr._update_on_kvstore
    assert ttr._kvstore._optimizer is ttr.optimizer
    assert ttr._kvstore._updater is not None
    _train(jnet, tnet, jtr, ttr)
    # without a store the flag means nothing, as in the JAX package
    assert not mt.gluon.Trainer(tnet.collect_params(), "sgd",
                                update_on_kvstore=True)._update_on_kvstore


class _Recording(mt.kvstore.KVStoreBase):
    """A store that records its pushpull calls and writes each value back
    unchanged (as tests/test_kvstore.py's RecordingStore)."""

    def __init__(self):
        self.calls = []

    def broadcast(self, key, value, out, priority=0):
        pass

    def pushpull(self, key, value, out=None, priority=0):
        self.calls.append((key, priority))
        outs = out if isinstance(out, list) else [out]
        vals = value if isinstance(value, list) else [value]
        for o, v in zip(outs, vals):
            o = o[0] if isinstance(o, list) else o
            v = v[0] if isinstance(v, list) else v
            o._data = v._data

    def is_capable(self, capability):
        return capability == "pushpull"


@pytest.mark.parametrize("fused", ["0", "1"])
def test_dispatch_order(monkeypatch, fused):
    """MXTPU_FUSED_UPDATE=0: one pushpull a parameter, in descending
    priority -i (layer 0 first); on: one list-form call of every key."""
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", fused)
    _, tnet = _pair()
    store = _Recording()
    tr = mt.gluon.Trainer(tnet.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=store)
    x, y = DATA[0]
    with mt.autograd.record():
        loss = tnet(torch.from_numpy(x)).sum(dim=1)
    mt.autograd.backward(loss)
    tr.step(6)
    if fused == "0":
        assert store.calls == [(0, 0), (1, -1), (2, -2), (3, -3)]
    else:
        assert store.calls == [([0, 1, 2, 3], 0)]


def test_ignore_stale_grad_skips_and_version_bump():
    """A gradient untouched since its update is left out of the pushpull
    and the update under ``ignore_stale_grad``; the store's write-back
    makes a gradient fresh, so without the flag a stale one is reduced
    and applied again; both as in the JAX package."""
    jnet, tnet = _pair()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1, "wd": 0.1},
                           kvstore="tpu_dist")
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd",
                           {"learning_rate": 0.1, "wd": 0.1},
                           kvstore="tpu_dist")
    _train(jnet, tnet, jtr, ttr, DATA[:1])
    ones = onp.ones((2, 16), "f")
    with mx.autograd.record():
        jl = jnet[1](mx.np.array(ones)).sum(axis=1)
    jl.backward()
    with mt.autograd.record():
        tl = tnet[1](torch.from_numpy(ones)).sum(dim=1)
    mt.autograd.backward(tl)
    w0 = tnet[0].weight._tensor().detach().clone()
    v0 = tnet[0].weight._grad_version
    jtr.step(2, ignore_stale_grad=True)
    ttr.step(2, ignore_stale_grad=True)
    assert torch.equal(tnet[0].weight._tensor(), w0)
    assert tnet[0].weight._grad_version == v0      # not pushed either
    jtr.step(2)
    ttr.step(2)
    assert not torch.equal(tnet[0].weight._tensor(), w0)
    assert tnet[0].weight._grad_version == v0 + 1   # the write-back
    for k, p in jnet.collect_params().items():
        onp.testing.assert_allclose(
            tnet.collect_params()[k]._tensor().detach().numpy(),
            p.data().asnumpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_step_store_reasons():
    """TrainStep runs phased, with the JAX package's words, for a store
    that runs the optimizer, compresses, or has several workers; a
    single-process tpu_dist trainer stays eligible."""
    class Two:
        """Two workers in name; the sum over processes is the identity."""
        num_workers = 2

        def _all_reduce(self, t):          # the port's
            return t

        _cross_process_sum = _all_reduce   # the JAX package's

    x, y = DATA[0]
    y = onp.eye(4, dtype="f")[y]
    cases = [("update_on_kvstore", dict(kvstore="local",
                                        update_on_kvstore=True)),
             ("compression", dict(kvstore="tpu_dist", compression_params={
                 "type": "2bit", "threshold": 0.5})),
             ("workers", dict(kvstore="tpu_dist")),
             ("one process", dict(kvstore="tpu_dist"))]
    for label, kw in cases:
        jnet, tnet = _pair()
        jnet.hybridize()
        jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                               {"learning_rate": 0.1}, **kw)
        ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd",
                               {"learning_rate": 0.1}, **kw)
        if label == "workers":
            for tr in (jtr, ttr):
                tr._kvstore = type("TwoWorkers", (Two, type(tr._kvstore)),
                                   {})()
        js = mx.gluon.TrainStep(jnet, mx.gluon.loss.L2Loss(), jtr)
        ts = mt.gluon.TrainStep(tnet, mt.gluon.loss.L2Loss(), ttr)
        js(mx.np.array(x), mx.np.array(y))
        ts(torch.from_numpy(x), torch.from_numpy(y))
        assert ts.ineligible_reason() == js.ineligible_reason(), label
        if label == "one process":
            assert ts.ineligible_reason() is None
            assert ts.last_path == js.last_path == "whole_step"
        else:
            assert ts.ineligible_reason(), label
            assert ts.last_path == js.last_path == "phased", label
