"""The optimizer ladder's dispatch in the PyTorch port
(mxnet_tpu_torch/kernels/opt.py, kernels/dispatch.py) on the CPU: which
decision each rule, dtype, size and device gets, counted by outcome under
the names the JAX package's tests/test_kernels.py expects of its own
dispatch, through the bucket entry point; the byte model against
mxnet_tpu/passes/memory.py; and the port's ladder against the JAX
package's Pallas ladder run in interpret mode
(MXTPU_KERNELS=force with MXTPU_KERNELS_INTERPRET=1 on the JAX side, as
tests/test_kernels.py runs it; that test passes on this jax version). The
port has no mode switch: device, rule and dtype alone decide. The CUDA
kernel itself runs only on the card (tests/test_torch_cuda_train.py,
tests/test_torch_cuda_opt.py); CPU tensors take the plain ladder, outcome
``platform``.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.kernels import opt as jkopt
from mxnet_tpu.optimizer import optimizer as jopt
from mxnet_tpu.passes import memory as jmemory
from mxnet_tpu_torch import env as tenv
from mxnet_tpu_torch.convert import to_tensor
from mxnet_tpu_torch.kernels import dispatch, opt as kopt
from mxnet_tpu_torch.optimizer import optimizer as topt

HYPER = {"rescale_grad": 1.0, "momentum": 0.9}


def _operands(size=2048, mp=True, n_state=1, seed=3):
    r = onp.random.RandomState(seed)
    master = r.standard_normal(size).astype("f")
    g = r.standard_normal(size).astype("f")
    states = [(onp.abs(r.standard_normal(size)) * 0.01).astype("f")
              for _ in range(n_state)]
    return master, g, states


def _torch_operands(size=2048, mp=True, n_state=1, seed=3):
    master, g, states = _operands(size, mp, n_state, seed)
    dt = torch.bfloat16 if mp else torch.float32
    w = torch.from_numpy(master.copy()).to(dt)
    inner = [torch.from_numpy(s.copy()) for s in states]
    inner = None if not inner else (inner[0] if n_state == 1
                                    else tuple(inner))
    st = (torch.from_numpy(master.copy()), inner) if mp else inner
    return w, st, torch.from_numpy(g).to(dt)


def _count(kernel, outcome):
    return dispatch.COUNTS.get((kernel, outcome), 0)


def _step(cls, w, st, g, mp=True, hyper=HYPER):
    return kopt.param_step(cls, None, False, mp, w, st, g, 0.1, 0.0, 1, 1.0,
                           hyper)


def test_no_mode_switch_device_rule_and_dtype_alone_decide(monkeypatch):
    """The JAX package's MXTPU_KERNELS is not registered in the port,
    MXTPU_FUSED_UPDATE only for the kvstore's allreduce (the Trainer's
    list-form pushpull), and setting them changes no decision."""
    for name in ("MXTPU_KERNELS", "MXTPU_KERNELS_INTERPRET",
                 "MXTPU_DONATE_UPDATE"):
        assert name not in tenv._REGISTRY
    assert "allreduce" in tenv._REGISTRY["MXTPU_FUSED_UPDATE"].help
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "0")
    assert not hasattr(dispatch, "mode")
    w, st, g = _torch_operands()
    for raw in (None, "off", "auto", "force"):
        if raw is None:
            monkeypatch.delenv("MXTPU_KERNELS", raising=False)
        else:
            monkeypatch.setenv("MXTPU_KERNELS", raw)
        assert kopt._decide(topt.SGD, True, w, st, g) == "platform"
    # tensors that pass the platform check (stubbed; nothing is launched
    # by asking for the decision): the kernel, at every size, mp or not
    monkeypatch.setattr(dispatch, "platform_ok", lambda *t: True)
    for size, mp in ((64, True), (768, True), (2048, False),
                     (1 << 17, True), (1 << 17, False)):
        w, st, g = _torch_operands(size=size, mp=mp)
        assert kopt._decide(topt.SGD, mp, w, st, g) == "kernel"


def test_cpu_tensors_take_the_plain_ladder_bit_for_bit():
    ref_w, ref_st, g = _torch_operands()
    topt.Optimizer._fused_param_step(topt.SGD, None, False, True, ref_w,
                                     ref_st, g, 0.1, 0.0, 1, 1.0, HYPER)
    w, st, g = _torch_operands()
    before, launches = _count("opt_sgd", "platform"), kopt.LAUNCHES.value
    rw, rst = _step(topt.SGD, w, st, g)
    assert _count("opt_sgd", "platform") == before + 1
    assert kopt.LAUNCHES.value == launches     # CPU: nothing launched
    assert rw is w and rst is st
    assert torch.equal(w, ref_w) and torch.equal(st[0], ref_st[0])
    assert torch.equal(st[1], ref_st[1])


def test_unsupported_rule_and_dtype_are_decided_before_the_platform():
    class Weird(topt.SGD):
        pass

    w, st, g = _torch_operands()
    before = _count("opt_weird", "unsupported_rule")
    _step(Weird, w, st, g)
    assert _count("opt_weird", "unsupported_rule") == before + 1
    # non-mp bf16 weights, an f16 weight under mp, an f64 state leaf
    cases = []
    w, st, g = _torch_operands(mp=False)
    cases.append((w.bfloat16(), st.bfloat16(), g.bfloat16(), False))
    w, st, g = _torch_operands()
    cases.append((w.half(), st, g.half(), True))
    cases.append((w, (st[0], st[1].double()), g, True))
    for w, st, g, mp in cases:
        before = _count("opt_sgd", "unsupported_dtype")
        _step(topt.SGD, w, st, g, mp=mp)
        assert _count("opt_sgd", "unsupported_dtype") == before + 1
    # the TPU's lane rule (size % 1024) is gone: a 64-element or a
    # 768-element parameter is supported and reaches the platform check
    for size in (64, 768):
        w, st, g = _torch_operands(size=size)
        assert kopt._supported(topt.SGD, True, w, st, g) is None
        before = _count("opt_sgd", "platform")
        _step(topt.SGD, w, st, g)
        assert _count("opt_sgd", "platform") == before + 1


def test_trainer_step_goes_through_param_step(monkeypatch):
    """``Trainer.step`` reaches the ladder through kernels/opt.py:
    bucket_step, one call per (dtype, multi-precision) bucket, and the
    single-parameter ``update`` through param_step, a bucket of one; so on
    the card they launch the kernel: every parameter's decision is
    counted."""
    import mxnet_tpu_torch as mt

    buckets = []
    real_bucket_step = kopt.bucket_step

    def spy(cls, clip, gn, mp, items, scale, hyper):
        buckets.append((mp, len(items)))
        return real_bucket_step(cls, clip, gn, mp, items, scale, hyper)

    monkeypatch.setattr(kopt, "bucket_step", spy)
    params = {}
    for i, dt in enumerate(("bfloat16", "float32", "float32")):
        p = mt.gluon.Parameter(f"p{i}", shape=(5, 3), dtype=dt)
        p.initialize(device=mt.cpu())
        p._grad = torch.ones((5, 3), dtype=p.dtype)
        p._grad_version += 1
        params[f"p{i}"] = p
    tr = mt.gluon.Trainer(params, "adamw", dict(learning_rate=0.1,
                                                multi_precision=True))
    before = _count("opt_adamw", "platform")
    tr.step(2)
    assert _count("opt_adamw", "platform") == before + 3
    assert buckets == [(True, 1), (False, 2)]
    opt = topt.SGD(learning_rate=0.1)
    before = _count("opt_sgd", "platform")
    w = torch.ones(7)
    opt.update(0, w, torch.ones(7), None)
    assert _count("opt_sgd", "platform") == before + 1
    assert buckets[-1] == (False, 1)
    assert torch.allclose(w, torch.full((7,), 0.9))


@pytest.mark.parametrize("mp", [True, False])
def test_byte_model_is_the_jax_packages(mp):
    for size in (768, 2048, 3072 * 768):
        for n_state in (0, 1, 2):
            wdt, isz = (jnp.bfloat16, 2) if mp else (jnp.float32, 4)
            assert dispatch.optimizer_region_bytes(size, isz, n_state, mp) \
                == jmemory.optimizer_region_bytes(size, wdt, n_state, mp)
    # AdamW under mp: 28 bytes per element through the kernel
    assert dispatch.optimizer_region_bytes(1000, 2, 2, True)[1] == 28000


@pytest.mark.parametrize("rule,n_state,hyper", [
    ("SGD", 1, {"rescale_grad": 1.0 / 8, "momentum": 0.9}),
    ("Adam", 2, {"rescale_grad": 1.0, "beta1": 0.9, "beta2": 0.999,
                 "eps": 1e-8}),
    ("AdamW", 2, {"rescale_grad": 1.0, "beta1": 0.9, "beta2": 0.999,
                  "eps": 1e-8}),
])
def test_ladder_matches_jax_pallas_ladder_in_interpret_mode(
        monkeypatch, rule, n_state, hyper):
    """The port's ladder (through param_step, which on the CPU decides
    ``platform``) against the JAX package's Pallas ladder kernel in
    interpret mode, mp and non-mp, with a clip: rtol and atol 1e-4 for f32
    leaves, 1e-2 for bf16, that package's own tolerances for its kernel
    against its XLA body (tests/test_kernels.py)."""
    monkeypatch.setenv("MXTPU_KERNELS", "force")         # the JAX side's
    monkeypatch.setenv("MXTPU_KERNELS_INTERPRET", "1")
    for mp in (True, False):
        master, g, states = _operands(mp=mp, n_state=n_state)
        wdt = jnp.bfloat16 if mp else jnp.float32
        jw = jnp.asarray(master).astype(wdt)
        jinner = tuple(jnp.asarray(s) for s in states)
        jinner = jinner[0] if n_state == 1 else jinner
        jst = (jnp.asarray(master), jinner) if mp else jinner
        jg = jnp.asarray(g).astype(wdt)
        args = (0.125, 1e-4, 3, 1.0, dict(hyper))
        jcls = getattr(jopt, rule)
        assert jkopt._decide(jcls, mp, jw, jst, jg)[1] == "kernel"
        want = jkopt.param_step(jcls, 0.5, False, mp, jw, jst, jg, *args)
        tw, tst, tg = _torch_operands(mp=mp, n_state=n_state)
        assert torch.equal(tw, to_tensor(onp.asarray(jw)))
        got = kopt.param_step(getattr(topt, rule), 0.5, False, mp, tw, tst,
                              tg, *args)
        want_l = jax.tree_util.tree_leaves(want)
        got_l = jax.tree_util.tree_leaves(got)
        assert len(want_l) == len(got_l)
        for wl, gl in zip(want_l, got_l):
            tol = 1e-4 if wl.dtype == jnp.float32 else 1e-2
            onp.testing.assert_allclose(
                gl.detach().float().numpy(),
                onp.asarray(wl.astype(jnp.float32)), rtol=tol, atol=tol)
