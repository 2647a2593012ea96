"""The states of the 14 optimizer rules through ``Trainer.save_states`` /
``load_states`` between the JAX package and the PyTorch port, and
``gluon.TrainStep`` with these rules against the port's phased step, on
the CPU.

After a load the states equal the saved ones bit for bit, in every case;
the port's loads copy into the states that exist (their tensors keep their
identity). The next step then agrees with the JAX package within the
tolerances of tests/test_torch_optimizer_rules.py: f32 leaves within rtol
2e-5 (the JAX side is one jitted program per bucket with float64
scalars), bf16 within one bf16 ulp, f32 masters within rtol 1e-4. The
port's TrainStep (one body: forward, backward and the update reading its
scalars, the update count t among them, from the scalar rows) equals the
phased ``Trainer.step`` loop bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dtype_codec as codec
from mxnet_tpu_torch.convert import to_tensor
from mxnet_tpu_torch.gluon import nn as tnn

TOL = dict(rtol=2e-5, atol=2e-6)
MASTER_TOL = dict(rtol=1e-4, atol=1e-6)
SHAPES = [(33, 5), (17, 3), (4, 6)]

#: (rule, constructor arguments, dtype, multi-precision)
CASES = [
    ("dcasgd", dict(learning_rate=0.05, momentum=0.0), "float32", False),
    ("dcasgd", dict(learning_rate=0.05, momentum=0.9), "bfloat16", False),
    ("rmsprop", dict(learning_rate=0.01, centered=True), "float32", False),
    ("rmsprop", dict(learning_rate=0.01), "bfloat16", True),
    ("groupadagrad", dict(learning_rate=0.1), "float32", False),
    ("groupadagrad", dict(learning_rate=0.1), "bfloat16", False),
    ("lamb", dict(learning_rate=0.01, wd=0.01), "bfloat16", True),
    ("lamb", dict(learning_rate=0.01, wd=0.01, bias_correction=False),
     "float32", False),
    ("lans", dict(learning_rate=0.01, wd=0.01), "float32", False),
    ("lars", dict(learning_rate=0.1, wd=1e-3), "float32", False),
    ("nadam", dict(learning_rate=0.01, wd=1e-3), "bfloat16", True),
    ("adabelief", dict(learning_rate=0.01), "float32", False),
    ("adamax", dict(learning_rate=0.01), "float32", False),
    ("ftml", dict(learning_rate=0.01), "float32", False),
    ("adagrad", dict(learning_rate=0.1), "bfloat16", False),
    ("adadelta", dict(learning_rate=1.0), "float32", False),
    ("ftrl", dict(learning_rate=0.1, wd=1e-3), "float32", False),
]


def _flat(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for y in s for x in _flat(y)]
    return [s]


def _nesting(s):
    """The shape of a state's nesting: None, a leaf, or a tuple of them."""
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(_nesting(x) for x in s)
    return "leaf"


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return onp.asarray(jnp.asarray(getattr(x, "_data", x), jnp.float32))


def _close(got, want, what, tol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for a, w in zip(got, want):
        a32, w32 = _f32(a), _f32(w)
        if str(getattr(w, "_data", w).dtype) == "bfloat16":
            ulp = onp.maximum(onp.abs(w32), 2.0 ** -126) * 2.0 ** -7
            assert (onp.abs(a32 - w32) <= ulp).all(), what
        else:
            onp.testing.assert_allclose(a32, w32, err_msg=what, **tol)


def _jstates(jtr):
    return [jax.tree_util.tree_map(lambda x: x._data, s,
                                   is_leaf=lambda x: hasattr(x, "_data"))
            for s in jtr._states]


def _pair(rule, kw, dt, mp):
    r = onp.random.RandomState(7)
    jps, tps = {}, {}
    for i, shape in enumerate(SHAPES):
        val = r.standard_normal(shape).astype("f")
        jp = jmx.gluon.Parameter(f"p{i}", shape=shape, dtype=dt)
        jp.initialize()
        jp.set_data(jmx.np.array(val).astype(dt))
        tp = mt.gluon.Parameter(f"p{i}", shape=shape, dtype=dt)
        tp.initialize(device=mt.cpu())
        tp.set_data(to_tensor(jp.data().asnumpy()))
        jps[f"p{i}"], tps[f"p{i}"] = jp, tp
    kw = dict(kw, multi_precision=mp)
    return (jps, tps, jmx.gluon.Trainer(jps, rule, dict(kw)),
            mt.gluon.Trainer(tps, rule, dict(kw)))


def _grads(jps, tps, seed):
    r = onp.random.RandomState(seed)
    for name in sorted(jps):
        jp, tp = jps[name], tps[name]
        g = r.standard_normal(jp.shape).astype("f")
        jg = jp.grad()
        jg._data = jnp.asarray(g).astype(jg._data.dtype)
        jg._version += 1
        tp._grad = to_tensor(onp.asarray(jg._data))
        tp._grad_version += 1


def _carry_weights(src, dst):
    for name, p in src.items():
        q = dst[name]
        if isinstance(p, mt.gluon.Parameter):
            value = p._tensor().detach().float().numpy().copy()
            q.set_data(jmx.np.array(value).astype(str(q.dtype)))
        else:
            q.set_data(to_tensor(p.data().asnumpy()))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rule_states_cross_both_ways(tmp_path, direction):
    """Step 1 in both packages; step 2 in one, which saves; the other
    loads (weights carried across) and the states equal bit for bit, with
    their nesting (DCASGD's ``(None, w)``, RMSProp's 3-tuple, GroupAdaGrad's
    ``(rows, 1)``, LAMB's ``(master, (m, v))``); step 3 in both agrees."""
    for rule, kw, dt, mp in CASES:
        what = f"{direction} {rule} {kw} {dt} mp={mp}"
        jps, tps, jtr, ttr = _pair(rule, kw, dt, mp)
        _grads(jps, tps, 1)
        jtr.step(4)
        ttr.step(4)
        before = [id(x) for s in ttr._states for x in _flat(s)]
        _grads(jps, tps, 2)
        path = str(tmp_path / f"{rule}_{dt}_{mp}.states")
        if direction == "jax_to_port":
            jtr.step(4)
            jtr.save_states(path)
            _carry_weights(jps, tps)
            ttr.load_states(path)
            # loaded in place: the same state tensors
            assert [id(x) for s in ttr._states for x in _flat(s)] == \
                before, what
        else:
            ttr.step(4)
            ttr.save_states(path)
            _carry_weights(tps, jps)
            jtr.load_states(path)
        for i, s in enumerate(_jstates(jtr)):
            assert _nesting(ttr._states[i]) == _nesting(s), what
            for a, w in zip(_flat(ttr._states[i]), _flat(s)):
                w = onp.asarray(w)
                assert codec.to_numpy(a)[0].tobytes() == w.tobytes(), what
        if rule == "groupadagrad":
            assert [tuple(s.shape) for s in ttr._states] == \
                [(r, 1) for r, _ in SHAPES]
        if rule == "dcasgd":
            assert (ttr._states[0][0] is None) == (kw["momentum"] == 0.0)
        _grads(jps, tps, 3)
        jtr.step(4)
        ttr.step(4)
        for name in sorted(jps):
            _close(tps[name]._tensor(), jps[name].data()._data,
                   f"{what} {name} weight", TOL)
        for i, s in enumerate(_jstates(jtr)):
            _close(ttr._states[i], s, f"{what} p{i} state",
                   MASTER_TOL if mp else TOL)
        assert ttr.optimizer.num_update == jtr.optimizer.num_update == 3


def _net(dtype, use_bias=True):
    net = tnn.HybridSequential(
        tnn.Dense(16, activation="relu", in_units=12, use_bias=use_bias),
        tnn.Dense(4, in_units=16, use_bias=use_bias))
    net.initialize(device=mt.cpu(),
                   generator=torch.Generator().manual_seed(1))
    if dtype == "bfloat16":
        mt.amp.convert_hybrid_block(net)
    return net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_with_each_rule_equals_the_phased_loop(dtype):
    """Each fused rule (bf16 with f32 masters in the second case) under a
    moving learning rate: 3 steps of TrainStep and of the phased loop from
    the same weights give the same losses, weights and states bit for
    bit; the whole step ran (it reads t from the scalar rows)."""
    rules = {c[0] for c in CASES}
    r = onp.random.RandomState(3)
    data = [(torch.from_numpy(r.standard_normal((8, 12)).astype("f")),
             torch.from_numpy(r.standard_normal((8, 4)).astype("f")))
            for _ in range(3)]
    lf = mt.gluon.loss.L2Loss()
    for rule in sorted(rules):
        kw = dict(next(c[1] for c in CASES if c[0] == rule),
                  multi_precision=dtype == "bfloat16")
        # GroupAdaGrad refuses 1-d weights: no biases for it
        bias = rule != "groupadagrad"
        wnet, pnet = _net(dtype, bias), _net(dtype, bias)
        wtr = mt.gluon.Trainer(wnet.collect_params(), rule, dict(kw))
        ptr = mt.gluon.Trainer(pnet.collect_params(), rule, dict(kw))
        step = mt.gluon.TrainStep(wnet, lf, wtr)
        for k, (x, y) in enumerate(data):
            if dtype == "bfloat16":
                x, y = x.bfloat16(), y.bfloat16()
            for tr in (wtr, ptr):
                tr.set_learning_rate(kw["learning_rate"] / (k + 1))
            wl = step(x, y)
            with mt.autograd.record():
                pl = lf(pnet(x), y)
            mt.autograd.backward(pl)
            ptr.step(8)
            what = f"{rule} {dtype} step {k}"
            assert step.last_path == "whole_step", (what,
                                                    step.ineligible_reason())
            assert torch.equal(wl, pl.detach()), what
            for (n, a), b in zip(wnet.collect_params().items(),
                                 pnet.collect_params().values()):
                assert torch.equal(a._tensor(), b._tensor()), (what, n)
            for sa, sb in zip(wtr._states, ptr._states):
                assert all(torch.equal(a, b) for a, b in
                           zip(_flat(sa), _flat(sb))), what
        assert step.jit_trace_count() == 1, rule
    # SGLD overrides update: TrainStep runs it phased, and says why
    net = _net("float32")
    step = mt.gluon.TrainStep(net, lf, mt.gluon.Trainer(
        net.collect_params(), "sgld", {"learning_rate": 0.01}))
    step(*data[0])
    assert step.last_path == "phased"
    assert "SGLD overrides update" in step.ineligible_reason()
