"""The ``linalg_*`` la_op family and ``mx.np.linalg`` against the JAX
package's, on the CPU from the same numpy inputs: forward over the sweep
table's cases (factors defined up to sign compared by absolute value),
the reference's conventions (``gemm``'s alpha/beta/transposes, the
triangle and side of ``trsm``/``trmm``, ``syevd``'s ``(U, L)`` with
``A = U^T diag(L) U``, ``gelqf``'s ``(Q, L)``, ``svd``'s ``(UT, L, V)``)
and backward through the factorizations and solves.

Tolerance: f32 within 1e-5 relative (plus 1e-6 absolute); a rebuilt
matrix within 1e-4 of its input (three factors multiplied back).
"""
import numpy as onp
import pytest

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import np_linalg as jnp_linalg_conventions
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _sweep_cases as sc
from mxnet_tpu_torch.ops.registry import _OPS as TOPS
from test_torch_registry_coverage import (_split, grads_batch, jax_batch,
                                          mismatch, port_call)

DATA = sc.inputs(0)
RTOL, ATOL = 1e-5, 1e-6


def test_forward_over_the_sweep_cases():
    # the ops of the backward table are compared forward there
    cases = [c for c in sc.CASES if c.kind == "det"
             and c.key.startswith(("linalg_", "_npi_")) and c.key in TOPS
             and c.key not in {g[0] for g in _GRADS}]
    calls = [(c.key, *sc.materialize(c, DATA, lambda a: a)) for c in cases]
    bad = [err for c, call, j in zip(cases, calls, jax_batch(calls))
           if (err := mismatch(c.key, j, port_call(*call), check=c.check,
                               rtol=RTOL, atol=ATOL))]
    twins = [k for k in TOPS if k.startswith("_linalg_")]
    assert len(twins) == 35 and all(TOPS[k] is TOPS[k[1:]] for k in twins)
    assert not bad, bad


def _jax_np_linalg(name):
    """The pure function behind the JAX package's ``mx.np.linalg.<name>``
    (numpy/linalg.py: ``jnp.linalg``'s, with ``ops/np_linalg.py``'s
    reference conventions over it)."""
    return getattr(jnp_linalg_conventions, name, None) or getattr(
        jnp.linalg, name)


def test_np_linalg_over_the_sweep_cases():
    cases = [c for c in sc.CASES if c.key.startswith("np.linalg.")]
    splits = [_split(*sc.materialize(c, DATA, lambda a: a)) for c in cases]
    fns = [_jax_np_linalg(c.key.rsplit(".", 1)[1]) for c in cases]
    host = {i for i, c in enumerate(cases) if c.key == "np.linalg.lstsq"}

    def call(i, xs):
        args, kw = splits[i][1](xs)
        return fns[i](*args, **kw)

    flat = [[jnp.asarray(a) for a in arrays] for arrays, _ in splits]
    want = jax.jit(lambda flat: [None if i in host else call(i, xs)
                                 for i, xs in enumerate(flat)])(flat)
    for i in host:   # numpy's residuals are decided on the host
        want[i] = call(i, flat[i])
    bad = []
    for case, jout in zip(cases, want):
        args, kwargs = sc.materialize(
            case, DATA, lambda a: mt.np.array(a, dtype=a.dtype,
                                              device=mt.cpu()))
        err = mismatch(case.key, jout, sc.function_of(mt, case.key)(
            *args, **kwargs), check=case.check, rtol=RTOL, atol=ATOL)
        if err:
            bad.append(err)
    # the wrappers: one call through the JAX package's NDArray frontend
    a = DATA["spd"]
    assert mismatch("np.linalg.inv", jmx.np.linalg.inv(jmx.np.array(a)),
                    mt.np.linalg.inv(mt.np.array(a, device=mt.cpu())),
                    rtol=RTOL, atol=ATOL) is None
    assert not bad, bad


#: trsm's and trmm's triangle, side and transpose
_TRIANGULAR = [
    dict(), dict(transpose=True), dict(rightside=True, lower=False),
    dict(rightside=True, transpose=True, alpha=2.0), dict(lower=False)]


def test_triangular_conventions():
    tri, b = DATA["tri"], DATA["bmat"]
    upper = onp.ascontiguousarray(tri.transpose(0, 2, 1))
    calls = []
    for kw in _TRIANGULAR:
        a = upper if kw.get("lower") is False else tri
        rhs = onp.ascontiguousarray(b.transpose(0, 2, 1)) if kw.get(
            "rightside") else b
        calls += [(key, (a, rhs), kw) for key in ("linalg_trsm",
                                                  "linalg_trmm")]
    bad = [mismatch(f"{key} {kw}", want, port_call(key, args, kw),
                    rtol=RTOL, atol=ATOL)
           for (key, args, kw), want in zip(calls, jax_batch(calls))]
    assert not any(bad), [e for e in bad if e]


def test_factorization_conventions():
    """The port's factors rebuild their input the reference's way."""
    spd, bmat = DATA["spd"], DATA["bmat"]
    u, lam = (t.numpy() for t in port_call("linalg_syevd", (spd,), {}))
    assert onp.all(onp.diff(lam, axis=-1) > 0)
    rebuilt = u.transpose(0, 2, 1) @ (lam[..., None] * u)
    assert onp.allclose(rebuilt, spd, rtol=1e-4, atol=1e-4)
    q, low = (t.numpy() for t in port_call("linalg_gelqf", (bmat,), {}))
    assert onp.allclose(low @ q, bmat, atol=1e-5)
    assert onp.allclose(onp.triu(low, 1), 0)
    ut, s, v = (t.numpy() for t in port_call("linalg_svd", (bmat,), {}))
    assert onp.allclose(ut.transpose(0, 2, 1) @ (s[..., None] * v), bmat,
                        atol=1e-5)
    g = port_call("linalg_gemm", (bmat, DATA["gemm_b"], DATA["cmat"]),
                  dict(alpha=0.5, beta=-1.0))
    assert onp.allclose(g.numpy(), 0.5 * bmat @ DATA["gemm_b"]
                        - DATA["cmat"], atol=1e-5)


_GRADS = [
    ("linalg_potrf", ("spd",), {}),
    ("linalg_potri", ("tri",), {}),
    ("linalg_trsm", ("tri", "bmat"), dict(transpose=True, alpha=0.5)),
    ("linalg_trmm", ("tri", "bmat"), dict(lower=False)),
    ("linalg_gemm", ("bmat", "gemm_b", "cmat"), dict(alpha=2.0, beta=0.5)),
    ("linalg_syrk", ("bmat",), dict(transpose=True)),
    ("linalg_inverse", ("spd",), {}),
    ("linalg_det", ("spd",), {}),
    ("linalg_slogdet", ("spd",), {}),
    ("linalg_sumlogdiag", ("spd",), {}),
    ("linalg_makediag", ("vec3",), dict(offset=1)),
    ("linalg_extracttrian", ("spd",), dict(offset=-1)),
    ("linalg_maketrian", ("vec6",), dict(lower=False)),
    ("linalg_solve", ("spd", "cmat"), {}),
    ("linalg_norm", ("bmat",), dict(ord=2, axis=-1)),
    ("linalg_pinv", ("mat2",), {}),
    ("linalg_multi_dot", ("md1", "md2", "md3"), {}),
]


def test_backward_through_the_la_ops():
    bad = []
    results = grads_batch([(key, tuple(DATA[n] for n in names), kw,
                            tuple(range(len(names))))
                           for key, names, kw in _GRADS])
    for (key, names, _), (jout, jg, tout, tg) in zip(_GRADS, results):
        bad.append(mismatch(key, jout, tout, rtol=RTOL, atol=ATOL))
        bad += [mismatch(f"{key} d{n}", a, b, rtol=RTOL, atol=ATOL)
                for n, a, b in zip(names, jg, tg)]
    assert not any(bad), [b for b in bad if b]


def test_eig_has_no_gradient():
    """``np.linalg.eig``/``eigvals`` compute forward inside ``record()``
    and raise on backward, as the reference registers none."""
    with mt.cpu():
        a = mt.np.array(DATA["spd1"])
        a.attach_grad()
        with mt.autograd.record():
            w = mt.np.linalg.eigvals(a)
        assert w.shape == (3,) and w.dtype == onp.float32
        with pytest.raises(NotImplementedError):
            w.backward()
