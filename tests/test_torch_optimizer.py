"""The PyTorch port's optimizers (mxnet_tpu_torch/optimizer) against the JAX
package's: the five ported rules through ``_fused_param_step`` (the plain
version of the CUDA ladder kernel) and through ``update_fused`` with a
learning-rate schedule and lr/wd multipliers.

Same numpy operands on both sides. Through ``_fused_param_step``, f32
leaves (weights, masters, states) within rtol 1e-6 (plus atol 1e-7 for
values near zero): both sides do the same f32 operations in the same order.
Through ``update_fused``, where the JAX side is one jitted program per
bucket, within FUSED_TOL (its reason stands beside it). bf16 weights within
1 bf16 ulp, since a small f32 difference in the master can round across a
bf16 boundary.
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

RULES = {
    "SGD": dict(momentum=0.9),
    "NAG": dict(momentum=0.9),
    "Signum": dict(momentum=0.9, wd_lh=0.01),
    "Adam": dict(beta1=0.9, beta2=0.999, eps=1e-8),
    "AdamW": dict(beta1=0.9, beta2=0.999, eps=1e-8),
}


def _operands(size, mp, n_state, seed):
    r = onp.random.RandomState(seed)
    master = r.standard_normal(size).astype("f")
    g = r.standard_normal(size).astype("f")
    # non-negative states: Adam's v is a running mean of g^2
    states = [(onp.abs(r.standard_normal(size)) * 0.01).astype("f")
              for _ in range(n_state)]
    return master, g, states


def _nest(leaves, n_state):
    if n_state == 0:
        return None
    return leaves[0] if n_state == 1 else tuple(leaves)


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat(s)]
    return [state]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return onp.asarray(jnp.asarray(x, jnp.float32))


def assert_leaves_close(got, want, what, rtol=1e-6, atol=1e-7):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for a, w in zip(got, want):
        a32, w32 = _f32(a), _f32(w)
        if str(w.dtype) == "bfloat16":
            assert a.dtype == torch.bfloat16, what
            ulp = onp.maximum(onp.abs(w32), 2.0 ** -126) * 2.0 ** -7
            assert (onp.abs(a32 - w32) <= ulp).all(), what
        else:
            assert a.dtype == torch.float32, what
            onp.testing.assert_allclose(a32, w32, rtol=rtol, atol=atol,
                                        err_msg=what)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_fused_param_step_matches_jax(rule):
    """With and without state, mp and non-mp, clip and global-norm scale,
    over 3 consecutive updates of the same tensors."""
    jcls, tcls = getattr(jopt, rule), getattr(topt, rule)
    adam = rule in ("Adam", "AdamW")
    variants = [(mp, stateless, clip, gn)
                for mp in (True, False)
                for stateless in ((False,) if adam else (False, True))
                for clip, gn in ((None, False), (0.5, True))]
    for mp, stateless, clip, gn in variants:
        n_state = 2 if adam else (0 if stateless else 1)
        master, g, states = _operands(515, mp, n_state, seed=3)
        hyper = dict(RULES[rule], rescale_grad=1.0 / 3)
        wdt = jnp.bfloat16 if mp else jnp.float32
        jw = jnp.asarray(master).astype(wdt)
        jst = _nest([jnp.asarray(s) for s in states], n_state)
        tw = to_tensor(onp.asarray(jw))
        tst = _nest([torch.from_numpy(s.copy()) for s in states], n_state)
        if mp:
            jst = (jnp.asarray(master), jst)
            tst = (torch.from_numpy(master.copy()), tst)
        what = f"{rule} mp={mp} stateless={stateless} clip={clip} gn={gn}"

        # the scalars typed as update_fused's jit sees them (weak-typed
        # f32 and int32 tracers), but op by op: called with Python numbers,
        # Python would fold 1 - beta1 and beta2 ** t in float64, and under
        # jit XLA reassociates the scalar products (see update_fused below)
        def jstep(w, st, g, lr, wd, t, scale, hyper, clip=clip, gn=gn,
                  mp=mp):
            h = {k: jnp.float32(x) for k, x in hyper.items()}
            return jcls._fused_param_step(
                jcls, clip, gn, mp, w, st, g, jnp.float32(lr),
                jnp.float32(wd), jnp.int32(t), jnp.float32(scale), h)

        for t in (1, 2, 3):
            gt = (g * (1 + 0.1 * t)).astype("f")
            jg = jnp.asarray(gt).astype(wdt)
            tg = to_tensor(onp.asarray(jg))
            args = (0.125 / t, 1e-4, t, 0.25, hyper)
            jw, jst = jstep(jw, jst, jg, *args)
            rw, rst = tcls._fused_param_step(tcls, clip, gn, mp, tw, tst, tg,
                                             *args)
            assert rw is tw and rst is tst            # in place
            # Adam's 1 - beta2 ** t cancels: one ulp between two powf
            # implementations is 2e-5 of 1 - 0.999 ** 3, and that factor
            # scales the whole step
            tol = FUSED_TOL if adam and t > 1 else {}
            assert_leaves_close(tw, jw, what + f" t={t} weight", **tol)
            assert_leaves_close(tst, jst, what + f" t={t} state", **tol)


# update_fused on the JAX side is one jitted program per bucket, in which
# XLA reassociates products of scalars ((1 - beta1) * (g * rescale) and the
# like) and contracts multiply-adds: a relative 1e-5 of the terms that are
# added, which near a cancellation is more than 1e-6 of the result
FUSED_TOL = dict(rtol=2e-5, atol=2e-6)


def _trainer_pair(opt_name, opt_kwargs, dtypes, sched=False):
    """Three parameters of the given dtypes in both packages, with a
    multiplier on the second, and one gradient each per step."""
    r = onp.random.RandomState(7)
    shapes = [(33, 5), (17,), (4, 4, 3)]
    jps, tps = {}, {}
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        val = r.standard_normal(shape).astype("f")
        jp = mx.gluon.Parameter(f"p{i}", shape=shape, dtype=dt)
        jp.initialize()
        jp.set_data(mx.np.array(val).astype(dt))
        tp = mt.gluon.Parameter(f"p{i}", shape=shape, dtype=dt)
        tp.initialize(device=mt.cpu())
        tp.set_data(to_tensor(jp.data().asnumpy()))
        if i == 1:
            jp.lr_mult = tp.lr_mult = 0.5
            jp.wd_mult = tp.wd_mult = 0.0
        jps[f"p{i}"], tps[f"p{i}"] = jp, tp
    jkw, tkw = dict(opt_kwargs), dict(opt_kwargs)
    if sched:
        jkw["lr_scheduler"] = mx.lr_scheduler.PolyScheduler(
            max_update=10, base_lr=0.05, pwr=1, warmup_steps=2)
        tkw["lr_scheduler"] = tsched.PolyScheduler(
            max_update=10, base_lr=0.05, pwr=1, warmup_steps=2)
    jtr = mx.gluon.Trainer(jps, opt_name, jkw)
    ttr = mt.gluon.Trainer(tps, opt_name, tkw)
    return jps, tps, jtr, ttr, r


def _run_updates(jps, tps, jtr, ttr, r, steps=3):
    for step in range(steps):
        for name in jps:
            jp, tp = jps[name], tps[name]
            g = r.standard_normal(jp.shape).astype("f")
            jg = jp.grad()
            jg._data = jnp.asarray(g).astype(jg._data.dtype)
            jg._version += 1
            tp._grad = to_tensor(onp.asarray(jg._data))
            tp._grad_version += 1
        jtr.step(4)
        ttr.step(4)
        for i, name in enumerate(sorted(jps)):
            what = f"step {step} {name}"
            assert_leaves_close(tps[name]._tensor(), jps[name].data()._data,
                                what, **FUSED_TOL)
            jst = jtr._states[i]
            jst = jax.tree_util.tree_map(
                lambda x: x._data, jst,
                is_leaf=lambda x: hasattr(x, "_data"))
            assert_leaves_close(ttr._states[i], jst, what + " state",
                                **FUSED_TOL)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update
    assert ttr.learning_rate == jtr.learning_rate


def test_update_fused_adamw_multi_precision_schedule_and_mults():
    """bf16 and f32 parameters in one list: two buckets, f32 masters under
    multi_precision, a warmup + polynomial schedule, lr/wd multipliers, and
    the global-norm clip across both buckets."""
    pair = _trainer_pair(
        "adamw", dict(learning_rate=0.05, wd=0.01, multi_precision=True,
                      clip_global_norm=1.0),
        ["bfloat16", "float32", "bfloat16"], sched=True)
    _run_updates(*pair)
    ttr = pair[3]
    assert ttr._states[0][0].dtype == torch.float32   # (master, (m, v))
    assert len(ttr._states[1]) == 2 and ttr._states[1][0].dim() == 1


def test_update_fused_sgd_momentum_clip_gradient():
    pair = _trainer_pair(
        "sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                    clip_gradient=0.3), ["float32"] * 3)
    _run_updates(*pair)


def test_per_parameter_loop_matches_the_fused_path():
    """An optimizer that overrides ``update`` does not support the fused
    step: its list-form update loops over the parameters through
    update_multi_precision, and gives the same bits as the fused list."""
    class LoopNAG(topt.NAG):
        def update(self, index, weight, grad, state):
            return super().update(index, weight, grad, state)

    def run(make):
        kw = dict(learning_rate=0.1, momentum=0.9, multi_precision=True)
        jps, tps, _, ttr, r = _trainer_pair(
            "nag", kw, ["bfloat16", "float32", "float32"])
        opt = make(**kw)
        ttr = mt.gluon.Trainer(tps, opt)
        assert opt._supports_fused() == (make is topt.NAG)
        for _ in range(2):
            for tp in tps.values():
                tp._grad = torch.from_numpy(
                    r.standard_normal(tp.shape).astype("f")).to(tp.dtype)
                tp._grad_version += 1
            ttr.step(2)
        return [tp._tensor().detach().clone() for tp in tps.values()]

    for a, b in zip(run(topt.NAG), run(LoopNAG)):
        assert torch.equal(a, b)


def test_create_names_and_rules_that_wait():
    assert isinstance(mt.optimizer.create("AdamW"), topt.AdamW)
    opt = mt.optimizer.create("sgd", learning_rate=0.3)
    assert mt.optimizer.create(opt) is opt and opt.learning_rate == 0.3
    # the rules that once waited now create their classes
    for name, cls in (("lamb", topt.LAMB), ("rmsprop", topt.RMSProp),
                      ("LARS", topt.LARS), ("ftrl", topt.Ftrl)):
        assert type(mt.optimizer.create(name)) is cls, name
    with pytest.raises(ValueError, match="unknown optimizer"):
        mt.optimizer.create("nope")
    # the schedulers are the port's own copy and agree with the JAX package
    for name, kw in (("FactorScheduler", dict(step=3, factor=0.5)),
                     ("MultiFactorScheduler", dict(step=[2, 5], factor=0.1)),
                     ("PolyScheduler", dict(max_update=9, warmup_steps=2)),
                     ("CosineScheduler", dict(max_update=9))):
        js, ts = getattr(mx.lr_scheduler, name)(**kw), \
            getattr(tsched, name)(**kw)
        assert [ts(n) for n in range(12)] == [js(n) for n in range(12)]
