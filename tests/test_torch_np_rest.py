"""The rest of ``mx.np`` (ROADMAP queue 1 item 4): the 32 names the port's
``MISSING`` listed, the creation and dtype functions, the constants and
dtype groups, and every mode of ``pad``, each held against the JAX package
on the CPU (64-bit types on, as mxnet_tpu/__init__.py:34 sets them).

Both packages get the same numpy values; dtypes must be equal, ints and
bools exactly, floats within 1e-6 relative + 1e-7. Not compared: shapes
that do not broadcast in ``array_equiv`` (the JAX package raises where
numpy, and the port, answer False). ``real_if_close``,
which the JAX package lacks (jnp has none), is held against numpy, and so
are the nested ``block`` and the windows' values.
"""
import numpy as onp
import pytest

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

R = onp.random.RandomState(19)
F = R.uniform(-2, 2, (4, 6)).astype("float32")
V = onp.array([3.0, 1.0, 2.0, 5.0, 4.0, 2.0, 0.5], "float32")
I = onp.array([3, 1, 2, 5, 4, 2, 7], "int32")


def _to(pkg, v):
    """``v`` with its numpy arrays made arrays of ``pkg`` (lists and tuples
    too); anything else as it is."""
    if isinstance(v, onp.ndarray):
        if pkg is mt:
            with mt.cpu():
                return mt.np.array(v, dtype=v.dtype)
        return jmx.np.array(v, dtype=v.dtype)
    if isinstance(v, (list, tuple)):
        return type(v)(_to(pkg, x) for x in v)
    return v


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if hasattr(x, "asnumpy"):
        return onp.asarray(x.asnumpy())
    return onp.asarray(x)


def _same(got, want, tag):
    got, want = _host(got), _host(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), tag
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, (tag, k))
        return
    assert str(got.dtype) == str(want.dtype), (tag, got.dtype, want.dtype)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    if want.dtype.kind in "fc":
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                    equal_nan=True, err_msg=str(tag))
    else:
        onp.testing.assert_array_equal(got, want, err_msg=str(tag))


class _Slot:
    def __init__(self, i):
        self.i = i


def _jax_table(cases):
    """The JAX package's results of ``cases`` through one ``jax.jit``: its
    generated ``mx.np`` functions are ``jax.numpy``'s under an NDArray
    wrapper (multiarray.py:_wrap_jnp), so the table calls the wrapped
    functions on traced arrays (eager JAX compiles every primitive
    apart)."""
    leaves = []

    def lift(v):
        if isinstance(v, onp.ndarray):
            leaves.append(v)
            return _Slot(len(leaves) - 1)
        if isinstance(v, (list, tuple)):
            return type(v)(lift(x) for x in v)
        return v

    def fill(v, xs):
        if isinstance(v, _Slot):
            return xs[v.i]
        if isinstance(v, (list, tuple)):
            return type(v)(fill(x, xs) for x in v)
        return v

    specs = [(getattr(jmx.np, n).__wrapped__, lift(a), k)
             for n, a, k in cases]

    @jax.jit
    def run(*xs):
        return [fn(*fill(a, xs), **k) for fn, a, k in specs]

    return run(*[jnp.asarray(v) for v in leaves])


def _check(cases, jit=True):
    bad = []
    wants = _jax_table(cases) if jit else [
        getattr(jmx.np, name)(*_to(jmx, args), **kwargs)
        for name, args, kwargs in cases]
    for (name, args, kwargs), want in zip(cases, wants):
        try:
            with mt.cpu():
                got = getattr(mt.np, name)(*_to(mt, args), **kwargs)
            _same(got, want, (name, kwargs))
        except Exception as e:  # noqa: BLE001 - every case is reported
            bad.append((name, kwargs, f"{type(e).__name__}: {e}"[:300]))
    assert not bad, bad


def test_missing_is_empty_and_every_jax_name_exists():
    assert mt.np.MISSING == []
    lacks = [n for n in dir(jmx.np) if not n.startswith("_")
             and not hasattr(mt.np, n)]
    assert not lacks, lacks


def test_sorting_selection_and_indexing():
    b = onp.array([True, False, True, False, False, True, True])
    _check([
        ("partition", (V, 2), {}), ("partition", (F, 1), dict(axis=0)),
        ("argpartition", (V, 3), {}), ("argpartition", (I, 2), {}),
        ("lexsort", ([V, I],), {}),
        ("choose", (onp.array([0, 4, -1], "int32"), [V[:3], V[3:6]]),
         dict(mode="wrap")),
        ("choose", (onp.array([0, 4, -1], "int32"), [V[:3], V[3:6]]),
         dict(mode="clip")),
        ("delete", (V, 2), {}), ("delete", (F, slice(1, 3)), dict(axis=0)),
        ("insert", (V, 2, 9.0), {}),
        ("insert", (F, 1, onp.float32(3.0)), dict(axis=1)),
        ("ravel_multi_index", ((onp.array([1, 7], "int32"),
                                onp.array([-1, 5], "int32")), (4, 6)),
         dict(mode="wrap", order="F")),
        ("indices", ((2, 3),), {}), ("indices", ((3, 2),), dict(sparse=True)),
        ("select", ([V < 2, V > 3], [V, V * 2]), {}),
        ("select", ([F > 0], [F]), dict(default=-1.0)),
        ("array_equiv", (V, V), {}), ("array_equiv", (F[:1], F[:1] * 1), {}),
        ("resize", (V, (3, 4)), {}), ("resize", (F, 5), {}),
        ("fill_diagonal", (F[:, :4], 7.5), dict(inplace=False)),
        ("fill_diagonal", (F[:3, :3], onp.array([1.0, 2.0], "float32")),
         dict(inplace=False)),
    ])
    _check([
        ("insert", (V, onp.array([1, 5], "int32"),
                    onp.array([7.0, 8.0], "float32")), {}),
        ("insert", (I, slice(0, 4, 2), onp.array([11, 12], "int32")), {}),
        ("ravel_multi_index", ((onp.array([1, 0, 3], "int32"),
                                onp.array([2, 5, 1], "int32")), (4, 6)),
         dict(mode="clip")),
    ])
    # what needs concrete values: the JAX package's jnp functions in one
    # jit with the condition, the mask and the sizes as constants
    cb = jnp.asarray(b)
    wants = jax.jit(lambda v, i: [
        jnp.compress(cb, v, size=int(b.sum())), jnp.delete(v, b),
        tuple(jnp.unique_all(i, size=len(onp.unique(I))))])(V, I)
    for (name, args), want in zip(
            [("compress", (b, V)), ("delete", (V, b)), ("unique_all", (I,))],
            wants):
        with mt.cpu():
            got = getattr(mt.np, name)(*_to(mt, args))
        _same(got, list(want) if isinstance(want, tuple) else want, name)
    _check([("trim_zeros", (onp.array([0, 0, 1.5, 0, 2, 0], "float32"),),
             {})], jit=False)
    with mt.cpu(), pytest.raises(ValueError):
        mt.np.choose(mt.np.array(onp.array([0, 3], "int32")),
                     [mt.np.array(V[:2]), mt.np.array(V[2:4])])
    with mt.cpu(), pytest.raises(NotImplementedError):
        mt.np.fill_diagonal(mt.np.array(F), 1.0)


def test_signal_polynomials_and_histograms():
    _check([
        ("convolve", (V, V[:3]), {}),
        ("convolve", (I, I[:3]), dict(mode="same")),
        ("correlate", (V, V[:3]), {}), ("correlate", (V[:3], V), {}),
        ("gradient", (I, 2.0), {}),
        ("gradient", (F, 0.5), dict(axis=1)),
        ("gradient", (V, onp.cumsum(V + 1.0)), {}),
        ("interp", (V, onp.array([0.0, 1.5, 3.0, 4.5], "float32"),
                    onp.array([1.0, -1.0, 2.0, 0.0], "float32")), {}),
        ("interp", (F.ravel(), onp.array([-1.0, 0.0, 1.0], "float32"),
                    onp.array([0.0, 2.0, 1.0], "float32")), dict(period=2.0)),
        ("polyval", (onp.array([1.0, -2.0, 0.5], "float32"), V), {}),
        ("histogram", (F.ravel(),), dict(bins=5)),
        ("histogram", (V,), dict(bins=4, range=(0.0, 4.0), density=True)),
        ("histogram2d", (V, V[::-1].copy()), dict(bins=3)),
        ("cumulative_sum", (I,), {}),
        ("cumulative_sum", (F,), dict(axis=1, include_initial=True)),
        ("apply_along_axis", (lambda r: (r * 2).sum(), 1, F), {}),
        ("piecewise", (V, [V < 2, V > 3], [lambda x: x * 2, 7.0, 1.0]), {}),
        ("sort_complex", (V,), {}),
    ])
    # the JAX package wraps histogramdd's list of edges into one NDArray
    # (its asnumpy fails): compare the edges it holds
    with mt.cpu():
        hist, edges = mt.np.histogramdd(mt.np.array(F[:, :2]), bins=(2, 3))
    jhist, jedges = jmx.np.histogramdd(jmx.np.array(F[:, :2]), bins=(2, 3))
    _same(hist, jhist, "histogramdd")
    _same(list(edges), [onp.asarray(e) for e in jedges._data], "edges")
    # least squares in f32: LAPACK's gelsd and JAX's SVD round apart by
    # about the condition number times f32's epsilon (1.9e-6 and 1.4e-6
    # off the exact fit here)
    y = 3 * V * V - V + 1
    with mt.cpu():
        got = mt.np.polyfit(mt.np.array(V), mt.np.array(y), 2).asnumpy()
    want = jmx.np.polyfit(jmx.np.array(V), jmx.np.array(y), 2).asnumpy()
    assert got.dtype == want.dtype
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # roots come in LAPACK's order in both; compare as sorted values
    p = onp.array([0.0, 1.0, -6.0, 11.0, -6.0, 0.0], "float32")
    with mt.cpu():
        got = mt.np.roots(mt.np.array(p)).asnumpy()
    want = jmx.np.roots(jmx.np.array(p)).asnumpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    onp.testing.assert_allclose(onp.sort_complex(got),
                                onp.sort_complex(want), rtol=1e-5, atol=1e-5)
    for bits in (onp.array([1, 0, 1, 1, 0, 0, 0, 1, 1], "uint8"),
                 onp.array([[True, False, True], [False, True, True]])):
        _check([("packbits", (bits,), {}),
                ("packbits", (bits,), dict(axis=-1, bitorder="little"))])
    byte = onp.array([[177, 3], [0, 255]], "uint8")
    _check([("unpackbits", (byte,), {}),
            ("unpackbits", (byte,), dict(axis=1, count=11)),
            ("unpackbits", (byte,), dict(axis=0, count=5, bitorder="little"))])


def test_real_if_close_as_numpy():
    with mt.cpu():
        z = mt.np.array(onp.array([1 + 1e-9j, 2 - 1e-9j], "complex64"))
        real = mt.np.real_if_close(z)
        kept = mt.np.real_if_close(z * 1e9)
        plain = mt.np.real_if_close(mt.np.array(V))
    want = onp.real_if_close(onp.array([1 + 1e-9j, 2 - 1e-9j], "complex64"))
    assert real.dtype == want.dtype == onp.float32
    onp.testing.assert_array_equal(real.asnumpy(), want)
    assert kept.dtype == onp.complex64
    onp.testing.assert_array_equal(plain.asnumpy(), V)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_pad_in_every_mode(dtype):
    x = F[:3, :4].astype(dtype) if dtype == "float32" else \
        (F[:3, :4] * 10).astype(dtype)
    v = (V if dtype == "float32" else I)
    cases = [((2, 3), dict(mode="constant", constant_values=1)),
             ((1, 2), dict(mode="constant", constant_values=((4, 5),))),
             ((2, 1), dict(mode="edge")), ((5, 9), dict(mode="wrap")),
             ((9, 8), dict(mode="reflect")), ((9, 8), dict(mode="symmetric")),
             ((9, 8), dict(mode="reflect", reflect_type="odd")),
             ((6, 5), dict(mode="symmetric", reflect_type="odd")),
             ((2, 3), dict(mode="linear_ramp", end_values=(10, -3))),
             ((2, 3), dict(mode="maximum")), ((2, 3), dict(mode="minimum")),
             ((2, 3), dict(mode="mean", stat_length=2)),
             ((3, 1), dict(mode="median")), ((2, 1), dict(mode="empty"))]
    _check([("pad", (v, w), kw) for w, kw in cases]
           + [("pad", (x, ((1, 2), (2, 1))), kw) for _, kw in cases]
           + [("pad", (x, ((1, 2), (0, 3))),
               dict(mode="constant", constant_values=((4, 5), (6, 7))))])


def test_creation_windows_and_spaces():
    buf = onp.arange(6, dtype="float32").tobytes()
    _check([("row_stack", ([V, V],), {}), ("block", ([V[:2], V[2:5]],), {})])
    _check([
        ("logspace", (1.0, -1.0, 4), dict(endpoint=False, base=2.0)),
        ("geomspace", (-2.0, -50.0, 4), {}),
        ("geomspace", (3.0, 0.5, 6), dict(dtype="float64")),
        ("empty", ((2, 3),), {}), ("empty_like", (F,), {}),
        ("asarray", (V,), {}),
        ("copy", (F,), {}), ("astype", (I, "float32"), {}),
        ("frombuffer", (buf,), dict(dtype="float32")),
        ("hanning", (6,), {}), ("hamming", (5,), {}), ("blackman", (7,), {}),
        ("eye", (3,), {}), ("tri", (3, 4), {}),
        ("diag_indices_from", (F[:4, :4],), {}),
        ("tril_indices_from", (F,), dict(k=1)),
    ], jit=False)
    with mt.cpu():
        a, b = mt.np.array(F[:2, :2]), mt.np.array(F[2:, 4:])
        got = mt.np.block([[a, b], [b, a]])
        x = mt.np.array(V)
        assert mt.np.asarray(x) is x and mt.np.ascontiguousarray(x) is x
        assert mt.np.identity(2).dtype == onp.float32
        rows, cols = mt.np.triu_indices_from(mt.np.array(F[:4, :4]))
        want_r, want_c = onp.triu_indices_from(F[:4, :4])
        onp.testing.assert_array_equal(rows.asnumpy(), want_r)
        onp.testing.assert_array_equal(cols.asnumpy(), want_c)
        assert mt.np.shares_memory(x, x[1:]) and mt.np.may_share_memory(x, x)
        assert not mt.np.shares_memory(x, mt.np.copy(x))
        assert mt.np.from_dlpack(x)._data.data_ptr() == x._data.data_ptr()
    want = onp.block([[F[:2, :2], F[2:, 4:]], [F[2:, 4:], F[:2, :2]]])
    onp.testing.assert_array_equal(got.asnumpy(), want)
    j = jmx.np.array(V)
    for name in ("shape", "ndim", "size"):
        assert getattr(mt.np, name)(mt.np.array(V, device=mt.cpu())) == \
            getattr(jmx.np, name)(j), name
    assert mt.np.size(F, 1) == jmx.np.size(F, 1) == 6


def test_dtypes_constants_and_promotion():
    for name in ("bool", "uint16", "uint32", "uint64", "NAN", "NaN", "NINF",
                 "PINF", "NZERO", "PZERO", "boolean_dtypes",
                 "integer_dtypes", "floating_dtypes", "numeric_dtypes"):
        got, want = getattr(mt.np, name), getattr(jmx.np, name)
        if isinstance(want, float):
            assert str(got) == str(want), name
        else:
            assert got == want, name
    kinds = [onp.bool_, onp.int8, onp.uint8, onp.int16, onp.int32,
             onp.uint32, onp.int64, onp.uint64, onp.float16, onp.float32,
             onp.float64]
    for a in kinds:
        for b in kinds:
            assert onp.dtype(mt.np.promote_types(a, b)) == onp.dtype(
                jmx.np.promote_types(a, b)), (a, b)
            assert mt.np.can_cast(a, b) == jmx.np.can_cast(a, b), (a, b)
    for args in ((onp.int32, onp.float16), (onp.int32, 1.0),
                 (onp.float16, 1), (onp.bool_, 1), (onp.uint8, onp.int8, 2.0),
                 (onp.float32, onp.int64)):
        assert onp.dtype(mt.np.result_type(*args)) == onp.dtype(
            jmx.np.result_type(*args)), args
    for dt in ("float16", "float32", "float64"):
        assert mt.np.finfo(dt).eps == jmx.np.finfo(dt).eps, dt
        assert mt.np.finfo(dt).max == jmx.np.finfo(dt).max, dt
    for dt in ("int8", "int32", "uint16", "int64"):
        assert mt.np.iinfo(dt).max == jmx.np.iinfo(dt).max, dt
    assert mt.np.finfo(mt.np.bfloat16).eps == float(
        jmx.np.finfo(jmx.np.bfloat16).eps)
    with mt.cpu():
        assert mt.np.finfo(mt.np.array(V)).eps == onp.finfo("float32").eps
