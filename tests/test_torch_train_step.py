"""``gluon.TrainStep`` of the PyTorch port against the JAX package's, on
the CPU, where the port runs its step body eagerly (the CUDA graph is the
card's): a Dense stack (and one with BatchNorm) takes 3 steps in both
packages from the same weights and optimizer states, carried across before
each step by ``convert.load_jax_params`` / ``load_jax_trainer_states``.

Tolerances are those the port's tests already state: in f32, 1e-4 of each
tensor's largest value (tests/test_torch_optimizer.py,
tests/test_torch_trainer.py); in bf16 with f32 masters, as
tests/test_torch_train_bert.py holds them at lr 2e-5: the two frameworks
round the bf16 forward and backward at other points, so a gradient may
differ by a few bf16 ulps, and only the masters (within 1e-4) and the bf16
weights (within one bf16 ulp of the tensor's largest value, and each the
master rounded) are held to the JAX package's; the loss to 1e-2. In the
port the whole step and the phased step (record -> backward ->
Trainer.step) are bitwise equal, every state leaf included. The reasons
for running phased are the reference's strings.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import (load_jax_params,
                                     load_jax_trainer_states, to_tensor)
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.kernels import dispatch as kdispatch

BATCH, FEATS, OUT = 8, 12, 4


@pytest.fixture(autouse=True)
def _isolate_globals():
    """The JAX TrainStep and Trainer stamp process-global state (the
    flight identity, the world generation) that later suites assert
    pristine: snapshot and restore it, as tests/test_elastic.py does."""
    from mxnet_tpu.elastic import reentry
    from mxnet_tpu.observability import flight

    ident = dict(flight._identity)
    gen = reentry._generation[0]
    yield
    flight._identity.clear()
    flight._identity.update(ident)
    reentry._generation[0] = gen


def _nets(bn=False, dtype=None):
    mx.seed(0)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(16, activation="relu", in_units=FEATS))
    if bn:
        jnet.add(mx.gluon.nn.BatchNorm(in_channels=16))
    jnet.add(mx.gluon.nn.Dense(OUT, in_units=16))
    jnet.initialize()
    tnets = []
    for _ in range(2):       # the port's whole step, and its phased step
        tnet = tnn.HybridSequential(
            tnn.Dense(16, activation="relu", in_units=FEATS),
            *([tnn.BatchNorm(in_channels=16)] if bn else []),
            tnn.Dense(OUT, in_units=16))
        tnet.initialize(device=mt.cpu())
        tnets.append(tnet)
    if dtype:
        jnet.cast(dtype)
        for tnet in tnets:
            tnet.cast(dtype)
    jnet.hybridize()
    return jnet, tnets


def _data(steps, dtype=None):
    r = onp.random.RandomState(3)
    return [(r.standard_normal((BATCH, FEATS)).astype("float32"),
             r.standard_normal((BATCH, OUT)).astype("float32"))
            for _ in range(steps)]


def _np_state(s):
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(_np_state(x) for x in s)
    return s.asnumpy()


def _carry(jnet, jtr, tnet, ttr, names):
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    opt = jtr.optimizer
    load_jax_trainer_states(ttr, {
        "states": {n: _np_state(s) for n, s, made in zip(
            names, jtr._states, jtr._states_created) if made},
        "index_update_count": {names[i]: t for i, t in
                               opt._index_update_count.items()},
        "num_update": opt.num_update})


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, torch.Tensor):
        return [s]
    return [x for y in s for x in _leaves(y)]


def _run(opt, kw, dtype=None, bn=False, schedule=False, steps=3):
    """3 steps of the JAX TrainStep, the port's TrainStep and the port's
    phased step, each port net taking the JAX side's weights and states
    before each step. Returns the three sides' losses, parameters and
    states after each step, and the two TrainSteps."""
    jnet, (tnet, pnet) = _nets(bn, dtype)
    names = sorted(jnet.collect_params())
    mk = dict(kw)
    if dtype:
        mk["multi_precision"] = True
    jtr = mx.gluon.Trainer(jnet.collect_params(), opt, dict(mk))
    ttr = mt.gluon.Trainer(tnet.collect_params(), opt, dict(mk))
    ptr = mt.gluon.Trainer(pnet.collect_params(), opt, dict(mk))
    jstep = mx.gluon.TrainStep(jnet, mx.gluon.loss.L2Loss(), jtr)
    tstep = mt.gluon.TrainStep(tnet, mt.gluon.loss.L2Loss(), ttr)
    lf = mt.gluon.loss.L2Loss()
    out = []
    for k, (x, y) in enumerate(_data(steps)):
        if k:      # step 0 starts from the same weights and no states
            _carry(jnet, jtr, tnet, ttr, names)
            _carry(jnet, jtr, pnet, ptr, names)
        else:
            load_jax_params(tnet, {n: p.data().asnumpy() for n, p in
                                   jnet.collect_params().items()})
            load_jax_params(pnet, {n: p.data().asnumpy() for n, p in
                                   jnet.collect_params().items()})
        for tr in (jtr, ttr, ptr):
            if schedule:
                tr.set_learning_rate(kw["learning_rate"] / (k + 1))
        jx, jy = mx.np.array(x, dtype=dtype), mx.np.array(y, dtype=dtype)
        tx, ty = to_tensor(jx.asnumpy()), to_tensor(jy.asnumpy())
        if dtype:
            tx, ty = tx.to(torch.bfloat16), ty.to(torch.bfloat16)
        jl = jstep(jx, jy).asnumpy()
        tl = tstep(tx, ty)
        with mt.autograd.record():
            pl = lf(pnet(tx), ty)
        mt.autograd.backward(pl)
        ptr.step(BATCH)
        side = {}
        for label, net, tr, loss in (("jax", jnet, jtr, jl),
                                     ("whole", tnet, ttr, tl),
                                     ("phased", pnet, ptr, pl)):
            ps = net.collect_params()
            if label == "jax":
                params = {n: to_tensor(ps[n].data().asnumpy()) for n in names}
                states = [[to_tensor(a) for a in _flat(s)]
                          for s in jtr._states]
                counts = dict(tr.optimizer._index_update_count)
                loss = to_tensor(onp.asarray(loss))
            else:
                params = {n: ps[n]._tensor().detach().clone() for n in names}
                states = [[a.clone() for a in _leaves(s)]
                          for s in tr._states]
                counts = dict(tr.optimizer._index_update_count)
                loss = loss.detach().clone()
            side[label] = dict(loss=loss, params=params, states=states,
                               counts=counts)
        out.append(side)
    assert tstep.last_path == "whole_step", tstep.ineligible_reason()
    assert jstep.last_path == "whole_step", jstep.ineligible_reason()
    return out, jstep, tstep


def _flat(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for y in s for x in _flat(y)]
    return [s.asnumpy()]


def _close(a, b, rel=1e-4):
    a, b = a.float(), b.float()
    scale = max(b.abs().max().item(), 1e-6)
    assert (a - b).abs().max().item() <= rel * scale, \
        ((a - b).abs().max().item(), scale)


def _bf16_ulp_close(a, b):
    """|a - b| within one bf16 ulp of b's largest value (the rounding of a
    master that differs in its last f32 digits)."""
    a, b = a.float(), b.float()
    ulp = 2.0 ** (onp.floor(onp.log2(max(b.abs().max().item(), 1e-30))) - 7)
    assert (a - b).abs().max().item() <= ulp


def _check(out, bf16=False):
    for side in out:
        w, p, j = side["whole"], side["phased"], side["jax"]
        # the port's whole step is its phased step, bit for bit
        assert torch.equal(w["loss"], p["loss"])
        assert w["counts"] == p["counts"] == j["counts"]
        for n in w["params"]:
            assert torch.equal(w["params"][n], p["params"][n]), n
        for sw, sp in zip(w["states"], p["states"]):
            assert all(torch.equal(a, b) for a, b in zip(sw, sp))
        # and the JAX package's within the stated tolerance
        _close(w["loss"], j["loss"], 1e-2 if bf16 else 1e-4)
        for i, n in enumerate(sorted(w["params"])):   # trainer order
            if bf16 and w["params"][n].dtype == torch.bfloat16:
                _bf16_ulp_close(w["params"][n], j["params"][n])
                # the weight is its f32 master rounded, exactly
                assert torch.equal(w["params"][n],
                                   w["states"][i][0].to(torch.bfloat16)), n
            else:
                _close(w["params"][n], j["params"][n])
        for sw, sj in zip(w["states"], j["states"]):
            assert len(sw) == len(sj)
            if bf16:       # the f32 master, the first leaf
                assert (sw[0] - sj[0]).abs().max().item() <= 1e-4
                continue
            for a, b in zip(sw, sj):
                _close(a, b)


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.02}),
])
def test_train_step_f32_matches_jax(opt, kw):
    out, jstep, tstep = _run(opt, kw)
    _check(out)
    assert tstep.jit_trace_count() == jstep.jit_trace_count() == 1


def test_train_step_lr_schedule_builds_once():
    """An LR that changes every step: one step body in both packages (the
    zero-retrace proof), and the same updates."""
    out, jstep, tstep = _run("sgd", {"learning_rate": 0.05,
                                     "momentum": 0.9}, schedule=True)
    _check(out)
    assert tstep.jit_trace_count() == 1 and jstep.jit_trace_count() == 1


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_bf16_multi_precision_matches_jax(opt):
    kw = {"learning_rate": 2e-5}
    if opt == "sgd":
        kw["momentum"] = 0.9
    out, _, tstep = _run(opt, kw, dtype="bfloat16")
    _check(out, bf16=True)
    assert tstep.jit_trace_count() == 1


def test_train_step_batchnorm_running_stats_match_jax():
    """BatchNorm's running mean and variance move inside the step body in
    place: they equal the phased step's and the JAX package's."""
    out, _, _ = _run("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                     bn=True)
    _check(out)
    stats = {n: t for n, t in out[-1]["whole"]["params"].items()
             if "running" in n}
    assert len(stats) == 2
    for n, t in stats.items():     # moved from their zeros and ones
        assert not torch.equal(t, torch.full_like(
            t, 1.0 if "var" in n else 0.0)), n


def test_fallback_reasons_equal_the_reference(monkeypatch):
    """clip_global_norm, an optimizer that overrides update, grad_req
    'add' and a net that is no HybridBlock run phased in both packages for
    the same reason; MXTPU_WHOLE_STEP=0 runs phased; a mesh= that is no
    Mesh raises."""
    x = onp.random.RandomState(0).randn(BATCH, FEATS).astype("f")
    y = onp.random.RandomState(1).randn(BATCH, OUT).astype("f")

    class JCustom(mx.optimizer.SGD):
        def update(self, index, weight, grad, state):
            return super().update(index, weight, grad, state)

    class TCustom(mt.optimizer.SGD):
        def update(self, index, weight, grad, state):
            return super().update(index, weight, grad, state)
    JCustom.__name__ = TCustom.__name__ = "Custom"

    cases = {
        "clip": ({"learning_rate": 0.1, "clip_global_norm": 1.0}, None),
        "override": (None, (JCustom(learning_rate=0.1),
                            TCustom(learning_rate=0.1))),
        "add": ({"learning_rate": 0.1}, None),
    }
    for label, (kw, opts) in cases.items():
        jnet, (tnet, _) = _nets()
        if label == "add":
            jnet[0].weight.grad_req = "add"
            tnet[0].weight.grad_req = "add"
        jopt, topt = opts if opts else ("sgd", "sgd")
        jtr = mx.gluon.Trainer(jnet.collect_params(), jopt, kw)
        ttr = mt.gluon.Trainer(tnet.collect_params(), topt, kw)
        js = mx.gluon.TrainStep(jnet, mx.gluon.loss.L2Loss(), jtr)
        ts = mt.gluon.TrainStep(tnet, mt.gluon.loss.L2Loss(), ttr)
        js(mx.np.array(x), mx.np.array(y))
        ts(torch.from_numpy(x), torch.from_numpy(y))
        assert js.last_path == ts.last_path == "phased", label
        assert ts.ineligible_reason() == js.ineligible_reason(), label
        assert ts.ineligible_reason(), label
    # a Block that is no HybridBlock
    block = mt.gluon.Block()
    block.body = tnn.Dense(OUT, in_units=FEATS)
    block.forward = lambda z: block.body(z)
    block.initialize(device=mt.cpu())
    ts = mt.gluon.TrainStep(block, mt.gluon.loss.L2Loss(), mt.gluon.Trainer(
        block.collect_params(), "sgd", {"learning_rate": 0.1}))
    ts(torch.from_numpy(x), torch.from_numpy(y))
    assert ts.last_path == "phased"
    assert ts.ineligible_reason() == "net is not a HybridBlock"
    # MXTPU_WHOLE_STEP=0
    _, (tnet, _) = _nets()
    ts = mt.gluon.TrainStep(tnet, mt.gluon.loss.L2Loss(), mt.gluon.Trainer(
        tnet.collect_params(), "sgd", {"learning_rate": 0.1}))
    monkeypatch.setenv("MXTPU_WHOLE_STEP", "0")
    ts(torch.from_numpy(x), torch.from_numpy(y))
    assert ts.last_path == "phased" and ts.jit_trace_count() == 0
    assert ts.ineligible_reason() is None
    monkeypatch.delenv("MXTPU_WHOLE_STEP")
    ts(torch.from_numpy(x), torch.from_numpy(y))
    assert ts.last_path == "whole_step" and ts.jit_trace_count() == 1
    with pytest.raises(TypeError, match="mesh"):
        mt.gluon.TrainStep(tnet, None, ts._trainer, mesh=object())


def test_counter_deltas_follow_replays():
    """What a capture adds to the launch counters and dispatch counts goes
    to its tally (the capture ran nothing) while counts that do not belong
    to it (another stream's: here another thread's) keep counting, and the
    tally is added once per replay."""
    import threading

    a, b = kbuild.counter("test_delta_a"), kbuild.LaunchCounter("test_d_b")
    a.reset()
    b.reset()
    a.add(5)
    capturing = threading.current_thread()
    with kbuild.captured_counts(
            lambda: threading.current_thread() is capturing) as tally:
        a.add(3)                            # as a capture would
        b.add(2)
        kdispatch.record("test_delta", "kernel")
        other = threading.Thread(target=a.add, args=(10,))
        other.start()
        other.join()
        with pytest.raises(RuntimeError, match="already open"):
            with kbuild.captured_counts():
                pass
    assert kbuild.capture_tally() is None
    assert (a.value, b.value) == (15, 0)
    assert dict(tally) == {a: 3, b: 2}
    assert tally.decisions == {("test_delta", "kernel"): 1}
    assert ("test_delta", "kernel") not in kdispatch.COUNTS
    for _ in range(4):                      # four replays
        kbuild.add_deltas(tally)
    assert (a.value, b.value) == (27, 8)
    assert kdispatch.COUNTS[("test_delta", "kernel")] == 4
    del kdispatch.COUNTS[("test_delta", "kernel")]
    kbuild.COUNTERS.pop("test_delta_a")
