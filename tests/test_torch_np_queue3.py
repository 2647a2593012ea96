"""The six ``mx.np`` faults of ROADMAP queue 3 (the re-anchor before
slice 11), each held against the JAX package on the CPU.

The JAX package runs with 64-bit types on (mxnet_tpu/__init__.py:34). Both
packages get the same numpy values; dtypes must be equal, ints and bools
exactly, floats to 1e-6 relative (cov and corrcoef sum in another order).
Inputs cover float32, int32 and bool where a function takes them. Index
arrays are built as int32: the JAX package's ``take`` refuses the float32
that ``mx.np.array([5, -1])`` gives by default.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

VALUES = {"float32": [1.5, -2.25, 3.0, 0.5], "int32": [1, 15, -25, 4],
          "bool": [True, False, True, True]}


def _pair(values, dtype):
    values = onp.asarray(values).astype(dtype)
    with mt.cpu():
        t = mt.np.array(values, dtype=dtype)
    return t, jmx.np.array(values, dtype=dtype)


def _same(got, want, tag):
    assert str(got.dtype) == str(want.dtype), (tag, got.dtype, want.dtype)
    g, w = onp.asarray(got.asnumpy()), onp.asarray(want.asnumpy())
    assert g.shape == w.shape, (tag, g.shape, w.shape)
    if w.dtype.kind == "f":
        onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                    equal_nan=True, err_msg=str(tag))
    else:
        onp.testing.assert_array_equal(g, w, err_msg=str(tag))


def _both(name, *operands, **kwargs):
    """``mx.np.<name>`` of each package; an operand given as ``(values,
    dtype)`` becomes an array of each."""
    t_args, j_args = [], []
    for a in operands:
        t, j = _pair(*a) if isinstance(a, tuple) else (a, a)
        t_args.append(t)
        j_args.append(j)
    return (getattr(mt.np, name)(*t_args, **kwargs),
            getattr(jmx.np, name)(*j_args, **kwargs))


def test_concat_fix_and_round__are_exported():
    """Item 1: the three aliases were defined but left out of ``__all__``,
    so ``mx.np.concat`` raised AttributeError."""
    for name in ("concat", "fix", "round_"):
        assert name in mt.np.__all__ and hasattr(mt.np, name), name
    for dtype in VALUES:
        x = (VALUES[dtype], dtype)
        t, j = _pair(*x)
        _same(mt.np.concat([t, t]), jmx.np.concat([j, j]), ("concat", dtype))
        _same(*_both("fix", x), ("fix", dtype))
    _same(*_both("round_", (VALUES["float32"], "float32")), "round_")


def test_round_of_an_integer_array():
    """Item 2: ``round``/``around`` of int32 returned torch's
    NotImplementedError; the JAX package returns the array for decimals
    >= 0 and raises for decimals < 0."""
    x = (VALUES["int32"], "int32")
    for name in ("round", "around", "round_"):
        for decimals in (0, 1, 2):
            _same(*_both(name, x, decimals), (name, decimals))
    t, j = _pair(*x)
    for fn in (mt.np.round, jmx.np.round):
        with pytest.raises(NotImplementedError):
            fn(t if fn is mt.np.round else j, -1)
    _same(*_both("round", (VALUES["float32"], "float32"), 1), "round f32")


def test_products_of_bools():
    """Item 3: dot, inner, vdot, matmul and tensordot of two bool arrays
    give a bool, True where any pair of Trues meets."""
    rng = onp.random.default_rng(11)
    a = rng.random((3, 4)) < 0.4
    b = rng.random((4, 5)) < 0.4
    v = [True, False, True]
    cases = [("dot", (v, "bool"), (v, "bool")),
             ("inner", (v, "bool"), (v, "bool")),
             ("vdot", (v, "bool"), (v, "bool")),
             ("dot", (a, "bool"), (b, "bool")),
             ("matmul", (a, "bool"), (b, "bool")),
             ("inner", (a, "bool"), (b.T, "bool")),
             ("tensordot", (a, "bool"), (b, "bool"))]
    for dtype in ("float32", "int32"):
        cases += [(name, (a, dtype), (b, dtype))
                  for name in ("dot", "matmul")]
    for name, x, y in cases:
        kwargs = {"axes": 1} if name == "tensordot" else {}
        _same(*_both(name, x, y, **kwargs), (name, x[1]))
    got, _ = _both("inner", (v, "bool"), (v, "bool"))
    assert got.asnumpy().tolist() is True
    assert str(_both("dot", (a[0], "bool"), (b[:, 0] & False, "bool"))[0]
               .asnumpy()) == "False"


def test_set_functions_of_bools():
    """Item 3: isin, in1d, intersect1d, setdiff1d and setxor1d of bool
    raised torch's RuntimeError."""
    cases = {"bool": ([True, True, False, True], [True, True]),
             "int32": ([3, 1, 4, 1, 5], [1, 5, 9]),
             "float32": ([0.5, 1.5, 2.5], [1.5, 7.0])}
    for dtype, (x, y) in cases.items():
        for name in ("isin", "in1d", "intersect1d", "setdiff1d",
                     "setxor1d"):
            _same(*_both(name, (x, dtype), (y, dtype)), (name, dtype))
        _same(*_both("isin", (x, dtype), (y, dtype), invert=True),
              ("isin invert", dtype))
    _same(*_both("isin", ([True, False], "bool"), ([1, 2], "int32")),
          "isin bool in int32")


def test_statistics_of_bools():
    """Item 3: cov, corrcoef and trapezoid of bool raised; the JAX package
    computes them in float32, as it does for int32."""
    m = [[1, 0, 1, 1, 0], [0, 0, 1, 0, 1], [1, 1, 1, 0, 0]]
    for dtype in ("bool", "int32", "float32"):
        x = (m, dtype)
        _same(*_both("cov", x), ("cov", dtype))
        _same(*_both("corrcoef", x), ("corrcoef", dtype))
        _same(*_both("trapezoid", x), ("trapezoid", dtype))
        _same(*_both("trapezoid", x, x), ("trapezoid x", dtype))
    _same(*_both("trapezoid", ([True, False, True], "bool"), dx=0.5),
          "trapezoid dx")
    _same(*_both("cov", ([True, False, True], "bool"),
                 ([0.5, 2.0, -1.0], "float32")), "cov bool with f32")


def test_clip_without_bounds():
    """Item 4: ``clip(x)`` and ``clip(x, None, None)`` raised (torch.clamp
    refuses two Nones); the JAX package returns x."""
    for dtype in ("float32", "int32"):
        x = (VALUES[dtype], dtype)
        _same(*_both("clip", x), ("clip", dtype))
        _same(*_both("clip", x, None, None), ("clip None None", dtype))
        _same(*_both("clip", x, 2, None), ("clip low", dtype))


def test_angle_of_negative_zero():
    """Item 5: ``angle(-0.0)`` was 0; numpy and the JAX package take
    arctan2(0, -0.0), which is pi."""
    x = ([-0.0, 0.0, -1.0, 2.5, float("nan")], "float32")
    got, want = _both("angle", x)
    _same(got, want, "angle f32")
    assert got.asnumpy()[0] == onp.float32(onp.pi)
    for dtype in ("int32", "bool"):
        _same(*_both("angle", (VALUES[dtype], dtype)), ("angle", dtype))


def test_take_honours_mode():
    """Item 6: ``take`` ignored ``mode`` and raised IndexError on an index
    out of range. 'fill' (the default) puts NaN (float), the smallest int
    (signed) or True (bool) there, the values ``jnp.take`` fills, probed
    from the JAX package; 'clip' clamps; 'wrap' wraps; 'raise' raises
    NotImplementedError in both."""
    fill = {"float32": onp.nan, "int32": -2147483648, "bool": True}
    idx = (onp.array([5, -1]), "int32")
    for dtype in ("float32", "int32", "bool"):
        a = (onp.arange(4), dtype)
        a2 = (onp.arange(8).reshape(2, 4), dtype)
        for mode in (None, "fill", "clip", "wrap"):
            kw = {} if mode is None else {"mode": mode}
            _same(*_both("take", a, idx, **kw), ("take", dtype, mode))
            _same(*_both("take", a2, idx, axis=1, **kw),
                  ("take axis 1", dtype, mode))
        got = _both("take", a, idx)[0].asnumpy()
        want = onp.array([fill[dtype], 3]).astype(dtype)
        onp.testing.assert_array_equal(got, want)
        t, j = _pair(*a)
        ti, ji = _pair(*idx)
        with pytest.raises(NotImplementedError):
            mt.np.take(t, ti, mode="raise")
        with pytest.raises(NotImplementedError):
            jmx.np.take(j, ji, mode="raise")
    _same(*_both("take", (onp.arange(4), "float32"), (onp.array(
        [[0, 3], [-4, 4]]), "int32")), "take 2-d index")
