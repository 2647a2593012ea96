"""``mx.nd.sparse`` (ndarray/sparse.py) against the JAX package on the CPU
(64-bit types on): construction, ``cast_storage`` both ways, ``retain``,
the merged elementwise ops of two row-sparse arrays, every ``dot`` form
with the gradient of its dense operand, CSR row slicing and ``tostype``.

The structure (``indices``, ``indptr``, shapes, stypes, dtypes) must be
equal exactly; values within 1e-6 relative + 1e-7 (a product sums in
another order). The JAX side of each ``dot`` table runs through one
``jax.jit`` (its pure function over the dense operand, as
``sparse.dot`` builds it)."""
import numpy as onp
import pytest

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

R = onp.random.RandomState(31)


def _dense(rows, cols, keep=0.3, zero_rows=(1,)):
    d = R.uniform(-2, 2, (rows, cols)).astype("float32")
    d *= R.uniform(0, 1, d.shape) < keep
    for r in zero_rows:
        d[r] = 0
    return d


D = _dense(6, 5)


def _pnd(a):
    with mt.cpu():
        return mt.np.array(a, dtype=a.dtype)


def _close(got, want, tag):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        tag, got.dtype, want.dtype, got.shape, want.shape)
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                err_msg=str(tag))


def _same_sparse(got, want, tag):
    assert type(got).__name__ == type(want).__name__, tag
    assert got.stype == want.stype and got.shape == want.shape, tag
    assert onp.dtype(got.dtype) == onp.dtype(want.dtype), tag
    onp.testing.assert_array_equal(got.indices.asnumpy(),
                                   onp.asarray(want.indices), err_msg=tag)
    if got.stype == "csr":
        onp.testing.assert_array_equal(got.indptr.asnumpy(),
                                       onp.asarray(want.indptr), err_msg=tag)
    _close(got.data.asnumpy(), onp.asarray(want.data), tag)
    _close(got.asnumpy(), _dense_of(want), tag)


def _dense_of(sp):
    """The dense value of a JAX-package sparse array, from its stored
    arrays in numpy (eager JAX compiles a scatter per shape)."""
    data, idx = onp.asarray(sp.data), onp.asarray(sp.indices)
    out = onp.zeros(sp.shape, data.dtype)
    if sp.stype == "csr":
        rows = onp.repeat(onp.arange(sp.shape[0]),
                          onp.diff(onp.asarray(sp.indptr)))
        onp.add.at(out, (rows, idx), data)
    else:
        onp.add.at(out, idx, data)
    return out


def test_construction_and_cast_storage():
    tsp, jsp = mt.nd.sparse, jmx.nd.sparse
    csr = jsp.csr_matrix(D)
    data, idx, ptr = (onp.asarray(csr.data), onp.asarray(csr.indices),
                      onp.asarray(csr.indptr))
    with mt.cpu():
        cases = [
            ("csr dense", tsp.csr_matrix(D), csr),
            ("csr triple", tsp.csr_matrix((data, idx, ptr), shape=D.shape),
             jsp.csr_matrix((data, idx, ptr), shape=D.shape)),
            ("csr f64", tsp.csr_matrix(D, dtype="float64"),
             jsp.csr_matrix(D, dtype="float64")),
            ("rsp dense", tsp.row_sparse_array(D), jsp.row_sparse_array(D)),
            ("rsp pair unsorted", tsp.row_sparse_array(
                (D[[4, 0, 2]], onp.array([4, 0, 2])), shape=D.shape),
             jsp.row_sparse_array((D[[4, 0, 2]], onp.array([4, 0, 2])),
                                  shape=D.shape)),
            ("cast csr", tsp.cast_storage(_pnd(D), "csr"),
             jsp.cast_storage(jmx.np.array(D), "csr")),
            ("cast rsp", tsp.cast_storage(_pnd(D), "row_sparse"),
             jsp.cast_storage(jmx.np.array(D), "row_sparse")),
            ("nd.cast_storage", mt.nd.cast_storage(_pnd(D), "row_sparse"),
             jsp.cast_storage(jmx.np.array(D), "row_sparse")),
            ("zeros csr", tsp.zeros("csr", (3, 4)), jsp.zeros("csr", (3, 4))),
            ("zeros rsp", tsp.empty("row_sparse", (3, 4, 2), dtype="float64"),
             jsp.empty("row_sparse", (3, 4, 2), dtype="float64")),
            ("astype", tsp.csr_matrix(D).astype("float64"),
             csr.astype("float64")),
        ]
        for tag, got, want in cases:
            _same_sparse(got, want, tag)
            assert got.device == mt.cpu()
        for stype in ("csr", "row_sparse"):
            s = tsp.cast_storage(_pnd(D), stype)
            back = tsp.cast_storage(s, "default")
            assert type(back) is mt.NDArray
            _close(back.asnumpy(), D, ("back", stype))
            assert s.tostype(stype) is s
            other = "row_sparse" if stype == "csr" else "csr"
            _same_sparse(s.tostype(other), jsp.cast_storage(
                jmx.np.array(D), other), ("tostype", stype))
        dense = tsp.zeros("default", (2, 3))
        assert type(dense) is mt.NDArray and dense.shape == (2, 3)
        arr = tsp.array(D)
        assert type(arr) is mt.NDArray and arr.dtype == onp.float32
        import scipy.sparse as sps

        _same_sparse(tsp.array(sps.csr_matrix(D)),
                     jsp.array(sps.csr_matrix(D)), "scipy")
        # the fluent surface densifies; stateful members refuse
        rsp = tsp.row_sparse_array(D)
        _close(rsp.sum(axis=0).asnumpy(), D.sum(0), "fluent sum")
        with pytest.raises(AttributeError):
            rsp.attach_grad()
        with pytest.raises(AttributeError):
            rsp.no_such_op()
        out = mt.np.zeros(D.shape)
        rsp.copyto(out)
        _close(out.asnumpy(), D, "copyto")


def test_retain_and_merged_elementwise():
    tsp, jsp = mt.nd.sparse, jmx.nd.sparse
    a = _dense(7, 3, keep=0.5, zero_rows=(1, 4))
    b = _dense(7, 3, keep=0.5, zero_rows=(0, 4, 6))
    with mt.cpu():
        ta, tb = tsp.row_sparse_array(a), tsp.row_sparse_array(b)
        ja, jb = jsp.row_sparse_array(a), jsp.row_sparse_array(b)
        for keep in ([0, 2, 5], onp.array([6, 3]), [1, 4]):
            _same_sparse(tsp.retain(ta, keep), jsp.retain(ja, keep),
                         ("retain", keep))
        _same_sparse(ta.retain([2, 3]), ja.retain([2, 3]), "method")
        _same_sparse(mt.nd._sparse_retain(ta, _pnd(onp.array([0, 5]))),
                     jsp.retain(ja, [0, 5]), "registry op")
        for name in ("add", "subtract"):
            _same_sparse(getattr(tsp, name)(ta, tb),
                         getattr(jsp, name)(ja, jb), name)
        for name in ("multiply", "divide", "add"):
            got = getattr(tsp, name)(ta, _pnd(b + 3))
            want = getattr(jsp, name)(ja, jmx.np.array(b + 3))
            assert type(got) is mt.NDArray, name
            _close(got.asnumpy(), want.asnumpy(), (name, "dense"))
        with pytest.raises(TypeError):
            tsp.retain(_pnd(a), [0])


def _jax_dot_table(cases):
    """The JAX package's dense results and dense-operand gradients of
    ``cases`` (``(lhs, rhs numpy, kwargs)``) in one ``jax.jit``: each
    ``sparse.dot`` is its pure function of the dense operand it hands to
    ``apply_op`` (the transposed one for a CSR ``transpose_b``: its
    gradient is transposed back here)."""
    pures, args = [], []
    orig = jmx.ndarray.sparse.apply_op
    for lhs, rhs, kw in cases:
        def capture(fn, arg, name=None):  # noqa: ARG001
            pures.append(fn)
            args.append(arg._data)

        jmx.ndarray.sparse.apply_op = capture
        try:
            jmx.nd.sparse.dot(lhs, jmx.np.array(rhs), **kw)
        finally:
            jmx.ndarray.sparse.apply_op = orig

    @jax.jit
    def run(xs, cots):
        outs = []
        for fn, d, c in zip(pures, xs, cots):
            out, vjp = jax.vjp(fn, d)
            outs.append((out, vjp(c)[0]))
        return outs

    cots = [R.uniform(-1, 1, jax.eval_shape(fn, d).shape).astype("float32")
            for fn, d in zip(pures, args)]
    outs = run(args, cots)
    outs = [(o, g.T if kw.get("transpose_b") and lhs.stype == "csr" else g)
            for (o, g), (lhs, _, kw) in zip(outs, cases)]
    return outs, cots


def test_every_dot_form_with_its_gradient():
    tsp, jsp = mt.nd.sparse, jmx.nd.sparse
    big = _dense(9, 6, keep=0.4, zero_rows=(0, 5))
    forms = [  # (name, lhs dense, stype, rhs, kwargs)
        ("csr·dense", big, "csr", R.uniform(-1, 1, (6, 4)), {}),
        ("csr·vec", big, "csr", R.uniform(-1, 1, (6,)), {}),
        ("csrT·dense", big, "csr", R.uniform(-1, 1, (9, 3)),
         dict(transpose_a=True)),
        ("csr·denseT", big, "csr", R.uniform(-1, 1, (2, 6)),
         dict(transpose_b=True)),
        ("rsp·dense", big, "row_sparse", R.uniform(-1, 1, (6, 5)), {}),
        ("rsp·denseT", big, "row_sparse", R.uniform(-1, 1, (4, 6)),
         dict(transpose_b=True)),
    ]
    forms = [(n, l, s, r.astype("float32"), k) for n, l, s, r, k in forms]
    jcases = [(jsp.cast_storage(jmx.np.array(l), s), r, k)
              for _, l, s, r, k in forms]
    wants, cots = _jax_dot_table(jcases)
    for (name, lhs, stype, rhs, kw), (out, grad), cot in zip(forms, wants,
                                                              cots):
        with mt.cpu():
            x = tsp.cast_storage(_pnd(lhs), stype)
            d = _pnd(rhs)
            d.attach_grad()
            with mt.autograd.record():
                y = tsp.dot(x, d, **kw)
            y.backward(_pnd(cot))
        _close(y.asnumpy(), out, (name, "out"))
        _close(d.grad.asnumpy(), grad, (name, "grad"))
        _close(y.asnumpy(), (lhs.T if kw.get("transpose_a") else lhs)
               @ (rhs.T if kw.get("transpose_b") else rhs), (name, "numpy"))
    with mt.cpu():
        # a host operand and a dense left operand
        x = tsp.csr_matrix(big)
        host = R.uniform(-1, 1, (6, 2)).astype("float32")
        _close(tsp.dot(x, host).asnumpy(), big @ host, "host rhs")
        left = R.uniform(-1, 1, (4, 9)).astype("float32")
        got = tsp.dot(_pnd(left), x)
        want = jsp.dot(jmx.np.array(left), jsp.csr_matrix(big))
        _close(got.asnumpy(), want.asnumpy(), "dense·csr")
        with pytest.raises(ValueError):
            tsp.dot(tsp.row_sparse_array(big), _pnd(host), transpose_a=True)


def test_csr_slicing():
    tsp, jsp = mt.nd.sparse, jmx.nd.sparse
    with mt.cpu():
        t = tsp.csr_matrix(D)
        j = jsp.csr_matrix(D)
        for key in (slice(1, 4), slice(-3, None)):
            _same_sparse(t[key], j[key], ("slice", key))
        assert t[3:1].shape == (0, D.shape[1]) and t.slice(2, 6).shape == (
            4, D.shape[1])
        with pytest.raises(TypeError):
            t[1]
