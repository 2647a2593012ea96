"""The optimizer ladder as one launch per bucket (mxnet_tpu_torch/kernels/
opt.py: ``bucket_step``, ``bucket_sqnorm`` and the table they launch with)
on the CPU.

The table and its chunk plan are built by pure functions that read only
addresses and sizes, so they are tested here on CPU tensors: every element
of every tensor lies in exactly one chunk, a bucket splits into launches at
the table's capacity, and each tensor's scalars are what the first port's
per-parameter C entry point computed (libm's ``powf``, then f32 products),
within one f32 ulp of the plain ladder's own. On the CPU the bucket entry
points take the kernels' plain versions (``_fused_param_step`` and
``_fused_sqnorm`` over the bucket), held against the JAX package's
``update_fused`` (one jit per bucket) at tests/test_torch_optimizer.py's
tolerances: rtol 2e-5, atol 2e-6 for f32 leaves (XLA reassociates the
scalar products under jit), one bf16 ulp for bf16 weights. The kernels
themselves run on the card: tests/test_torch_cuda_opt.py.
"""
import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import to_tensor
from mxnet_tpu_torch.kernels import dispatch, opt as kopt
from mxnet_tpu_torch.optimizer import optimizer as topt

FUSED_TOL = dict(rtol=2e-5, atol=2e-6)
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=0.25)
_LIBM = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_LIBM.powf.argtypes = [ctypes.c_float, ctypes.c_float]
_LIBM.powf.restype = ctypes.c_float
F32 = onp.float32


def _member(n, mp, n_state, gen, offset=0):
    """(w, st, g) of one parameter on the CPU; ``offset`` elements into a
    larger buffer, to move its address off 16 bytes."""
    def buf(dt):
        return torch.randn(n + offset, generator=gen).to(dt)[offset:]

    dt = torch.bfloat16 if mp else torch.float32
    w, g = buf(dt), buf(dt)
    leaves = [buf(torch.float32).abs() * 1e-3 for _ in range(n_state)]
    inner = None if not leaves else (leaves[0] if n_state == 1
                                     else tuple(leaves))
    return w, ((buf(torch.float32), inner) if mp else inner), g


def _chunk_owner(table, c):
    """The entry that owns chunk c, by the kernel's binary search."""
    lo, hi = 0, len(table) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if table["chunk0"][mid] <= c:
            lo = mid
        else:
            hi = mid - 1
    return lo


def test_chunks_cover_every_element_of_every_tensor_once():
    """BERT's shapes (a 768 bias, a 30522 vector, a 3072 x 768 matrix), 3
    elements, a size one past a chunk, and a view 4 bytes off alignment:
    walking the launch's CTAs as the kernel does visits every element of
    every tensor exactly once; pointers, sizes and alignment flags are the
    tensors'."""
    gen = torch.Generator().manual_seed(0)
    sizes = [768, 3, 30522, 3072 * 768, kopt.CHUNK + 1, 1000]
    members = [_member(n, True, 2, gen, offset=2 if n == 1000 else 0)
               + (1e-3, 0.01, 1) for n in sizes]
    (table,) = kopt.ladder_tables(topt.AdamW, True, members, ADAM)
    assert list(table["n"]) == sizes
    n_chunks = int(table["chunk0"][-1]) + -(-sizes[-1] // kopt.CHUNK)
    assert n_chunks == sum(-(-n // kopt.CHUNK) for n in sizes)
    seen = [onp.zeros(n, dtype=onp.int64) for n in sizes]
    for c in range(n_chunks):
        k = _chunk_owner(table, c)
        base = (c - int(table["chunk0"][k])) * kopt.CHUNK
        assert 0 <= base < sizes[k]
        seen[k][base:base + kopt.CHUNK] += 1
    assert all((s == 1).all() for s in seen)
    for row, (w, st, g, *_) in zip(table, members):
        (m, v) = st[1]
        assert (row["w"], row["g"], row["s0"], row["s1"], row["w_lp"]) == (
            st[0].data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            w.data_ptr())
        ptrs = [w.data_ptr(), g.data_ptr(), st[0].data_ptr(),
                m.data_ptr(), v.data_ptr()]
        assert row["vec"] == int(all(p % 16 == 0 for p in ptrs))
    assert table["vec"][-1] == 0     # the view 4 bytes (2 bf16) off


def test_a_bucket_splits_into_launches_at_the_table_capacity():
    """1000 tiny tensors: ceil(1000 / capacity) launches, every tensor once
    and in order, each launch's chunks numbered from 0; the norm's tables
    split the same way."""
    gen = torch.Generator().manual_seed(1)
    members = [_member(1 + i % 5, False, 1, gen) + (0.1, 0.0, 1)
               for i in range(1000)]
    tables = kopt.ladder_tables(topt.SGD, False, members,
                                dict(momentum=0.9, rescale_grad=1.0))
    cap = kopt.TABLE_CAPACITY
    assert [len(t) for t in tables] == [cap] * (1000 // cap) + [1000 % cap]
    ptrs = [p for t in tables for p in t["w"]]
    assert ptrs == [m[0].data_ptr() for m in members]
    for t in tables:
        assert list(t["chunk0"]) == list(range(len(t)))   # < 1 chunk each
    assert [len(t) for t in kopt.ladder_tables(
        topt.SGD, False, members[:10], dict(momentum=0.9), capacity=4)] \
        == [4, 4, 2]
    norm = kopt.norm_tables([m[2] for m in members])
    assert [len(t) for t in norm] == [len(t) for t in tables]
    assert [p for t in norm for p in t["g"]] == [m[2].data_ptr()
                                                 for m in members]
    assert not any(t["w"].any() for t in norm)


def test_per_tensor_scalars_are_the_first_ports():
    """Per-tensor lr, wd and t that differ, for SGD, Signum, Adam and
    AdamW: each entry's ``b1c``, ``b2c``, ``lr_t`` and ``c1`` equal the
    first port's C entry point's formula (restated here with the same libm
    ``powf``), and lie within one f32 ulp (``lr_t``: two) of the plain
    ladder's own scalars (numpy's power)."""
    for rule, hyper in (("SGD", dict(momentum=0.9)),
                        ("Signum", dict(momentum=0.9, wd_lh=0.01)),
                        ("Adam", ADAM), ("AdamW", ADAM)):
        _check_scalars(rule, hyper)


def _check_scalars(rule, hyper):
    cls = getattr(topt, rule)
    gen = torch.Generator().manual_seed(2)
    n_state = 2 if rule.startswith("Adam") else 1
    scal = [(1e-3, 0.01, 1), (5e-4, 0.0, 7), (2e-3, 0.1, 3000)]
    members = [_member(64, False, n_state, gen) + s for s in scal]
    (table,) = kopt.ladder_tables(cls, False, members, hyper)
    keys = {"SGD": ("momentum",), "Signum": ("momentum", "wd_lh")}.get(
        rule, ("beta1", "beta2"))
    h = [F32(hyper[k]) for k in keys] + [F32(0)] * (2 - len(keys))
    for row, (lr, wd, t) in zip(table, scal):
        lr32 = F32(lr)
        b1c = F32(1) - F32(_LIBM.powf(h[0], t))
        b2c = F32(1) - F32(_LIBM.powf(h[1], t))
        want = dict(lr=lr32, wd=F32(wd), b1c=b1c, b2c=b2c,
                    lr_t=lr32 * onp.sqrt(b2c) / b1c,
                    c1=lr32 * h[1] if rule == "Signum" else F32(1) - h[1])
        for key, value in want.items():
            assert row[key] == value, (rule, t, key)
        if rule.startswith("Adam"):
            m, v, c1, c2 = topt._adam_moments(
                torch.zeros(1), (torch.zeros(1), torch.zeros(1)),
                dict(hyper, t=t))
            assert abs(row["b1c"] - c1) <= onp.spacing(c1)
            assert abs(row["b2c"] - c2) <= onp.spacing(c2)
            plain_lr_t = F32(lr32 * onp.sqrt(c2) / c1)
            assert abs(row["lr_t"] - plain_lr_t) <= 2 * onp.spacing(
                plain_lr_t)
        if rule == "Signum":
            assert row["c1"] == F32(F32(lr) * F32(hyper["wd_lh"]))


def _trainer_pair(opt_name, opt_kwargs, dtypes):
    """The same parameters in both packages, with an lr and a wd
    multiplier on the second."""
    r = onp.random.RandomState(17)
    shapes = [(33, 5), (17,), (4, 4, 3), (768,)][:len(dtypes)]
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
    return (jps, tps, mx.gluon.Trainer(jps, opt_name, dict(opt_kwargs)),
            mt.gluon.Trainer(tps, opt_name, dict(opt_kwargs)), r)


def _leaves_close(got, want, what):
    got = kopt._leaves(got)
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for a, w in zip(got, want):
        a32 = a.detach().float().numpy()
        w32 = onp.asarray(jnp.asarray(w, jnp.float32))
        if a.dtype == torch.bfloat16:
            ulp = onp.maximum(onp.abs(w32), 2.0 ** -126) * 2.0 ** -7
            assert (onp.abs(a32 - w32) <= ulp).all(), what
        else:
            onp.testing.assert_allclose(a32, w32, err_msg=what, **FUSED_TOL)


def _run_against_jax(opt_name, opt_kwargs, dtypes):
    """Three steps; the second skips p0's stale gradient, so the update
    counts t differ between tensors in the third."""
    jps, tps, jtr, ttr, r = _trainer_pair(opt_name, opt_kwargs, dtypes)
    for step in range(3):
        for name in jps:
            if step == 1 and name == "p0":
                continue
            jp, tp = jps[name], tps[name]
            g = r.standard_normal(jp.shape).astype("f")
            jg = jp.grad()
            jg._data = jnp.asarray(g).astype(jg._data.dtype)
            jg._version += 1
            tp._grad = to_tensor(onp.asarray(jg._data))
            tp._grad_version += 1
        jtr.step(4, ignore_stale_grad=True)
        ttr.step(4, ignore_stale_grad=True)
        for i, name in enumerate(sorted(jps)):
            what = f"{opt_name} step {step} {name}"
            _leaves_close(tps[name]._tensor(), jps[name].data()._data, what)
            jst = jax.tree_util.tree_map(
                lambda x: x._data, jtr._states[i],
                is_leaf=lambda x: hasattr(x, "_data"))
            _leaves_close(ttr._states[i], jst, what + " state")
    counts = ttr.optimizer._index_update_count
    assert sorted(counts.values()) == [2] + [3] * (len(dtypes) - 1)
    assert counts == jtr.optimizer._index_update_count


def test_plain_bucket_path_matches_jax_adamw_masters_global_norm():
    """AdamW with f32 masters beside f32 parameters (two buckets), the
    global-norm clip across both, multipliers and differing t."""
    _run_against_jax("adamw", dict(learning_rate=0.05, wd=0.01,
                                   multi_precision=True,
                                   clip_global_norm=1.0),
                     ["bfloat16", "float32", "bfloat16", "float32"])


def test_plain_bucket_path_matches_jax_sgd_momentum():
    _run_against_jax("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3),
                     ["float32"] * 4)


def _counting(monkeypatch):
    calls = {"bucket_step": [], "bucket_sqnorm": []}
    for name in calls:
        real = getattr(kopt, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name].append(a)
            return _real(*a, **kw)
        monkeypatch.setattr(kopt, name, spy)
    return calls


@pytest.mark.parametrize("clip_global_norm", [None, 1.0])
def test_trainer_step_makes_one_bucket_call_per_bucket(monkeypatch,
                                                       clip_global_norm):
    """``Trainer.step`` over bf16 (with masters) and f32 parameters: one
    ``bucket_step`` per bucket, and one ``bucket_sqnorm`` per bucket when
    clipping, each with the bucket's members in list order."""
    calls = _counting(monkeypatch)
    _, tps, _, ttr, r = _trainer_pair(
        "adamw", dict(learning_rate=0.01, multi_precision=True,
                      clip_global_norm=clip_global_norm),
        ["bfloat16", "float32", "bfloat16", "float32"])
    for tp in tps.values():
        tp._grad = torch.from_numpy(
            r.standard_normal(tp.shape).astype("f")).to(tp.dtype)
        tp._grad_version += 1
    before = dispatch.COUNTS.get(("opt_adamw", "platform"), 0)
    ttr.step(2)
    assert dispatch.COUNTS[("opt_adamw", "platform")] == before + 4
    steps = calls["bucket_step"]
    assert [(a[3], len(a[4])) for a in steps] == [(True, 2), (False, 2)]
    assert [it[0] for it in steps[0][4]] == [tps["p0"]._tensor(),
                                            tps["p2"]._tensor()]
    norms = calls["bucket_sqnorm"]
    assert len(norms) == (0 if clip_global_norm is None else 2)
    if norms:
        assert [len(a[0]) for a in norms] == [2, 2]


def test_cpu_buckets_are_the_plain_versions_bit_for_bit(monkeypatch):
    """On the CPU, ``update_fused`` through the bucket entry points gives
    the same bits as the first port's loop: one ``_fused_sqnorm`` read per
    bucket summed in float64, then ``_fused_param_step`` per member. A
    member the kernel cannot take (f16 under a bf16-shaped bucket) is
    counted as such and runs plain; nothing is launched or counted as a
    launch."""
    def run(loop):
        gen = torch.Generator().manual_seed(5)
        ws, sts, gs = [], [], []
        for n in (768, 3, 40):
            w, st, g = _member(n, True, 2, gen)
            ws.append(w)
            sts.append(st)
            gs.append(g)
        w, st, g = _member(17, False, 2, gen)
        ws.append(w)
        sts.append(st)
        gs.append(g)
        opt = topt.AdamW(learning_rate=0.01, wd=0.01, clip_global_norm=0.5,
                         rescale_grad=0.5)
        if loop:
            def bucket_step(cls, clip, gn, mp, items, scale, hyper):
                for w, st, g, lr, wd, t in items:
                    topt.Optimizer._fused_param_step(
                        cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper)

            def bucket_sqnorm(gs, rescale, out):
                out.copy_(topt.Optimizer._fused_sqnorm(gs, rescale))
            monkeypatch.setattr(kopt, "bucket_step", bucket_step)
            monkeypatch.setattr(kopt, "bucket_sqnorm", bucket_sqnorm)
        for _ in range(2):
            opt.update_multi_precision([0, 1, 2, 3], ws, gs, sts)
        monkeypatch.undo()
        return kopt._leaves((ws, sts))

    launches, tensors = kopt.LAUNCHES.value, kopt.TENSORS.value
    for a, b in zip(run(False), run(True)):
        assert torch.equal(a, b)
    assert (kopt.LAUNCHES.value, kopt.TENSORS.value) == (launches, tensors)
    gen = torch.Generator().manual_seed(6)
    w, st, g = _member(8, True, 2, gen)
    before = dispatch.COUNTS.get(("opt_adamw", "unsupported_dtype"), 0)
    kopt.bucket_step(topt.AdamW, None, False, True,
                     [(w.half(), st, g.half(), 0.1, 0.0, 1)], 1.0, ADAM)
    assert dispatch.COUNTS[("opt_adamw", "unsupported_dtype")] == before + 1
    assert kopt.LAUNCHES.value == launches
