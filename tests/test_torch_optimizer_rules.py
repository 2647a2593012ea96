"""The 14 optimizer rules of the PyTorch port (SGLD, DCASGD, Nadam,
AdaBelief, Adamax, FTML, RMSProp, AdaGrad, AdaDelta, Ftrl, LAMB, LANS,
LARS, GroupAdaGrad) against the JAX package's, on the CPU, with the same
numpy operands on both sides (the JAX package runs with its 64-bit types
on, as it always does).

Tolerances, as in tests/test_torch_optimizer.py:
- op by op through ``_fused_param_step`` with the scalars typed f32 on
  both sides: f32 leaves within rtol 1e-6 (atol 1e-7), and within
  FUSED_TOL for a rule that raises a beta to the update count t > 1 (two
  ``pow`` implementations differ by an ulp, and ``1 - beta2 ** t`` cancels);
- three steps through ``Trainer.step`` (the fused list path) against the
  JAX Trainer, whose update is one jitted program per bucket with its
  scalars in float64: f32 leaves within FUSED_TOL (XLA reassociates
  products of scalars; ``1 - beta2 ** t`` in f32 differs from float64 by
  1.3e-5 relative); bf16 leaves within one bf16 ulp of the element;
  f32 masters beside bf16 weights within rtol 1e-4.
Each test loops over the rules and names the failing case in its message.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.optimizer import optimizer as jopt
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch.convert import to_tensor
from mxnet_tpu_torch.optimizer import optimizer as topt

FUSED_TOL = dict(rtol=2e-5, atol=2e-6)
MASTER_TOL = dict(rtol=1e-4, atol=1e-6)

#: the fused rules, each with the constructor arguments of these tests
RULES = {
    "DCASGD": dict(momentum=0.9, lamda=0.04),
    "Nadam": dict(),
    "AdaBelief": dict(),
    "Adamax": dict(),
    "FTML": dict(),
    "RMSProp": dict(),
    "AdaGrad": dict(),
    "AdaDelta": dict(),
    "Ftrl": dict(),
    "LAMB": dict(),
    "LANS": dict(),
    "LARS": dict(),
    "GroupAdaGrad": dict(),
}
#: rules that raise a beta to the update count
T_POWERS = {"Nadam", "AdaBelief", "Adamax", "FTML", "LAMB", "LANS"}
SHAPES = [(33, 5), (17,), (4, 4, 3)]
SHAPES_2D = [(33, 5), (17, 3), (12, 4)]   # GroupAdaGrad's rows


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat(s)]
    return [state]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = getattr(x, "_data", x)
    return onp.asarray(jnp.asarray(x, jnp.float32))


def _dtype(x):
    return str(getattr(x, "_data", x).dtype).replace("torch.", "")


def assert_close(got, want, what, rtol=1e-6, atol=1e-7):
    """Leaf by leaf: bf16 within one bf16 ulp of the element, f32 within
    rtol/atol; the nesting (None included) equal."""
    assert type(got) is type(want) or (
        isinstance(got, (tuple, list)) and isinstance(want, (tuple, list))) \
        or (got is None) == (want is None), what
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for a, w in zip(got, want):
        assert _dtype(a) == _dtype(w), f"{what}: {_dtype(a)} != {_dtype(w)}"
        a32, w32 = _f32(a), _f32(w)
        assert a32.shape == w32.shape, what
        if _dtype(w) == "bfloat16":
            ulp = onp.maximum(onp.abs(w32), 2.0 ** -126) * 2.0 ** -7
            bad = onp.abs(a32 - w32) > ulp
            assert not bad.any(), (
                f"{what}: {int(bad.sum())} elements beyond 1 bf16 ulp, "
                f"largest {onp.abs(a32 - w32).max()}")
        else:
            onp.testing.assert_allclose(a32, w32, rtol=rtol, atol=atol,
                                        err_msg=what)


def _jstates(jtr, i):
    return jax.tree_util.tree_map(lambda x: x._data, jtr._states[i],
                                  is_leaf=lambda x: hasattr(x, "_data"))


def _pair(rule, kwargs, dtype, shapes=SHAPES, sched=True, seed=7):
    """Three parameters of ``dtype`` in both packages from the same values
    (lr and wd multipliers on the second) and a Trainer over them in
    each."""
    r = onp.random.RandomState(seed)
    jps, tps = {}, {}
    for i, shape in enumerate(shapes):
        val = r.standard_normal(shape).astype("f")
        jp = mx.gluon.Parameter(f"p{i}", shape=shape, dtype=dtype)
        jp.initialize()
        jp.set_data(mx.np.array(val).astype(dtype))
        tp = mt.gluon.Parameter(f"p{i}", shape=shape, dtype=dtype)
        tp.initialize(device=mt.cpu())
        tp.set_data(to_tensor(jp.data().asnumpy()))
        if i == 1:
            jp.lr_mult = tp.lr_mult = 0.5
            jp.wd_mult = tp.wd_mult = 0.0
        jps[f"p{i}"], tps[f"p{i}"] = jp, tp
    jkw, tkw = dict(kwargs), dict(kwargs)
    if sched:
        jkw["lr_scheduler"] = mx.lr_scheduler.PolyScheduler(
            max_update=10, base_lr=0.05, pwr=1, warmup_steps=2)
        tkw["lr_scheduler"] = tsched.PolyScheduler(
            max_update=10, base_lr=0.05, pwr=1, warmup_steps=2)
    jtr = mx.gluon.Trainer(jps, rule.lower(), jkw)
    ttr = mt.gluon.Trainer(tps, rule.lower(), tkw)
    return jps, tps, jtr, ttr, r


def _set_grads(jps, tps, r):
    for name in jps:
        jp, tp = jps[name], tps[name]
        g = r.standard_normal(jp.shape).astype("f")
        jg = jp.grad()
        jg._data = jnp.asarray(g).astype(jg._data.dtype)
        jg._version += 1
        tp._grad = to_tensor(onp.asarray(jg._data))
        tp._grad_version += 1


def _steps(rule, kwargs, dtype, steps=3, shapes=SHAPES, mp=False,
           weight_tol=FUSED_TOL, state_tol=FUSED_TOL, sched=True):
    """``steps`` Trainer steps of ``rule`` in both packages, every weight
    and state compared after each."""
    kw = dict(kwargs, multi_precision=mp)
    jps, tps, jtr, ttr, r = _pair(rule, kw, dtype, shapes, sched)
    for step in range(steps):
        _set_grads(jps, tps, r)
        jtr.step(4)
        ttr.step(4)
        for i, name in enumerate(sorted(jps)):
            what = f"{rule} {dtype} mp={mp} step {step} {name}"
            assert_close(tps[name]._tensor(), jps[name].data()._data,
                         what + " weight", **weight_tol)
            assert_close(ttr._states[i], _jstates(jtr, i), what + " state",
                         **state_tol)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update
    return jps, tps, jtr, ttr


def _common(rule, wd=True):
    kw = dict(RULES[rule], clip_gradient=0.8, clip_global_norm=3.0)
    if wd and rule != "GroupAdaGrad":
        kw["wd"] = 0.01
    return kw


def test_create_every_name_and_alias():
    """Every name the JAX package registers creates the class of the same
    name; the optimizers module exports each class."""
    names = jopt._REG.list()
    assert len(names) == 19, names
    for name in names:
        for spelling in (name, name.upper()):
            jcls = type(jopt.create(spelling))
            tcls = type(mt.optimizer.create(spelling))
            assert tcls.__name__ == jcls.__name__, spelling
            assert getattr(mt.optimizer, tcls.__name__) is tcls, spelling
    with pytest.raises(ValueError, match="unknown optimizer"):
        mt.optimizer.create("nope")


def test_rules_op_by_op():
    """``_fused_param_step`` of each fused rule, f32 and bf16 + f32
    master, with and without the per-element clip and a global-norm
    scale, over 3 updates of the same tensors."""
    for rule in RULES:
        jcls, tcls = getattr(jopt, rule), getattr(topt, rule)
        kw = RULES[rule]
        for mp, clip, gn in ((False, None, False), (False, 0.5, True),
                             (True, None, False), (True, 0.5, True)):
            r = onp.random.RandomState(3)
            master = r.standard_normal((37, 15)).astype("f")
            wdt = jnp.bfloat16 if mp else jnp.float32
            jw = jnp.asarray(master).astype(wdt)
            jopt_obj = jcls(**kw)
            topt_obj = tcls(**kw)
            jst = jopt_obj.create_state(0, mx.np.array(master))
            jst = jax.tree_util.tree_map(lambda x: x._data, jst,
                                         is_leaf=lambda x: hasattr(x, "_data"))
            tst = topt_obj.create_state(0, torch.from_numpy(master.copy()))
            if mp:
                jst = (jnp.asarray(master), jst)
                tst = (torch.from_numpy(master.copy()), tst)
            tw = to_tensor(onp.asarray(jw))
            hyper = dict(jopt_obj._hyper(), rescale_grad=1.0 / 3)
            what = f"{rule} mp={mp} clip={clip} gn={gn}"

            def jstep(w, st, g, lr, wd, t, scale, hyper, clip=clip, gn=gn,
                      mp=mp, jcls=jcls):
                h = {k: jnp.float32(x) for k, x in hyper.items()}
                return jcls._fused_param_step(
                    jcls, clip, gn, mp, w, st, g, jnp.float32(lr),
                    jnp.float32(wd), jnp.int32(t), jnp.float32(scale), h)

            for t in (1, 2, 3):
                gt = r.standard_normal((37, 15)).astype("f")
                jg = jnp.asarray(gt).astype(wdt)
                tg = to_tensor(onp.asarray(jg))
                wd = 0.0 if rule == "GroupAdaGrad" else 1e-3
                args = (0.05 / t, wd, t, 0.25, hyper)
                jw, jst = jstep(jw, jst, jg, *args)
                rw, rst = tcls._fused_param_step(
                    tcls, clip, gn, mp, tw, tst, tg, *args)
                assert rw is tw and rst is tst, what     # in place
                tol = FUSED_TOL if rule in T_POWERS and t > 1 else {}
                assert_close(tw, jw, f"{what} t={t} weight", **tol)
                assert_close(tst, jst, f"{what} t={t} state", **tol)


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_masters"])
def test_rules_through_the_trainer(mode):
    """3 steps of each fused rule through ``Trainer.step`` with weight
    decay (none for GroupAdaGrad, which refuses it), the batch rescale,
    ``clip_gradient``, ``clip_global_norm`` and a warmup + polynomial LR
    schedule, lr and wd multipliers on one parameter."""
    dtype = "float32" if mode == "f32" else "bfloat16"
    mp = mode == "bf16_masters"
    for rule in RULES:
        shapes = SHAPES_2D if rule == "GroupAdaGrad" else SHAPES
        _, _, _, ttr = _steps(rule, _common(rule), dtype, shapes=shapes,
                              mp=mp, state_tol=MASTER_TOL if mp
                              else FUSED_TOL)
        if mp:   # (master, inner state) under multi-precision
            assert all(s[0].dtype == torch.float32 for s in ttr._states), \
                rule


def test_lamb_and_lans_bounds_and_bias_correction():
    """LAMB with ``lower_bound``/``upper_bound`` (one clamps the trust
    ratio each way) and ``bias_correction=False``; LANS with bounds; f32
    and bf16 without masters."""
    # the trust ratios here are near 1: a lower bound of 2 and an upper
    # bound of 0.5 each clamp every tensor's
    cases = [("LAMB", dict(lower_bound=2.0, upper_bound=4.0)),
             ("LAMB", dict(upper_bound=0.5)),
             ("LAMB", dict(bias_correction=False)),
             ("LANS", dict(lower_bound=2.0)),
             ("LANS", dict(lower_bound=0.1, upper_bound=0.5))]
    for rule, extra in cases:
        for dtype in ("float32", "bfloat16"):
            kw = dict(learning_rate=0.01, wd=0.01, **extra)
            _steps(rule, kw, dtype, sched=False)


def test_rmsprop_centered_and_dcasgd_momentum():
    """RMSProp's state is a 1-tuple, and a 3-tuple when centered; DCASGD's
    is (momentum or None, previous weight), momentum 0 and 0.9."""
    for rule, kw, nest in (
            ("RMSProp", dict(centered=False), 1),
            ("RMSProp", dict(centered=True, momentum=0.5), 3),
            ("DCASGD", dict(momentum=0.0), 2),
            ("DCASGD", dict(momentum=0.9), 2)):
        for dtype in ("float32", "bfloat16"):
            _, tps, _, ttr = _steps(rule, dict(kw, learning_rate=0.01,
                                               wd=1e-3), dtype, sched=False)
            for i, s in enumerate(ttr._states):
                assert isinstance(s, tuple) and len(s) == nest, (rule, kw)
            if rule == "DCASGD":
                mom, prev = ttr._states[0]
                assert (mom is None) == (kw["momentum"] == 0.0), kw
                assert torch.equal(prev, tps["p0"]._tensor().detach())


def test_groupadagrad_history_and_refusals():
    """A (rows, 1) history per weight, 3 steps against the JAX package;
    weight decay and 1-d weights raise, as in the JAX package."""
    _, _, jtr, ttr = _steps("GroupAdaGrad", dict(learning_rate=0.1),
                            "float32", shapes=SHAPES_2D, sched=False)
    for i, shape in enumerate(SHAPES_2D):
        assert tuple(ttr._states[i].shape) == (shape[0], 1)
        assert tuple(_jstates(jtr, i).shape) == (shape[0], 1)
    # a 3-d weight: the JAX package broadcasts its (rows, 1) history
    # against the (rows, 1, 1) mean, which computes only where the first two
    # dims are equal, and its history becomes (rows, d1, 1), each row's
    # value repeated; the port keeps (rows, 1) with the same values, and the
    # weights agree
    kw = dict(learning_rate=0.1, clip_gradient=0.8)
    jps, tps, jtr, ttr, r = _pair("GroupAdaGrad", kw, "float32",
                                  [(4, 4, 3), (6, 6, 2)], sched=False)
    for step in range(3):
        _set_grads(jps, tps, r)
        jtr.step(4)
        ttr.step(4)
        for i, name in enumerate(sorted(jps)):
            what = f"GroupAdaGrad 3-d+ step {step} {name}"
            assert_close(tps[name]._tensor(), jps[name].data()._data,
                         what, **FUSED_TOL)
            jh = onp.asarray(_jstates(jtr, i))
            rows = jh.reshape(jh.shape[0], -1)
            assert (rows == rows[:, :1]).all(), what
            assert_close(ttr._states[i], jnp.asarray(rows[:, :1]), what,
                         **FUSED_TOL)
    for pkg in (jopt, topt):
        with pytest.raises(ValueError, match="weight decay"):
            pkg.GroupAdaGrad(wd=0.1)
    with pytest.raises(ValueError, match="2-d"):
        jopt.GroupAdaGrad().create_state(0, mx.np.zeros((5,)))
    with pytest.raises(ValueError, match="2-d"):
        topt.GroupAdaGrad().create_state(0, torch.zeros(5))


def test_sgld_with_the_same_noise(monkeypatch):
    """SGLD overrides ``update`` (the per-parameter loop); with the noise
    draws replaced by the same standard normals in both packages (patched
    here, not in either package), 3 steps agree in f32, bf16 and bf16 +
    f32 masters."""
    assert not topt.SGLD()._supports_fused()
    draws = {}

    def jax_normal(key, shape, dtype=jnp.float32):  # noqa: ARG001
        return jnp.asarray(draws[tuple(shape)], dtype)

    def port_normal(weight):
        return torch.from_numpy(draws[tuple(weight.shape)].copy())

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(topt, "_sgld_normal", port_normal)
    for dtype, mp in (("float32", False), ("bfloat16", False),
                      ("bfloat16", True)):
        kw = dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.8,
                  multi_precision=mp)
        jps, tps, jtr, ttr, r = _pair("SGLD", kw, dtype)
        for step in range(3):
            nr = onp.random.RandomState(100 + step)
            for shape in SHAPES:
                draws[shape] = nr.standard_normal(shape).astype("f")
            _set_grads(jps, tps, r)
            jtr.step(4)
            ttr.step(4)
            for name in jps:
                assert_close(tps[name]._tensor(), jps[name].data()._data,
                             f"SGLD {dtype} mp={mp} step {step} {name}",
                             **FUSED_TOL)
