"""The last dtype faults of ROADMAP queue 3, held against the JAX package
on the CPU: ``mx.nd.relu`` of bool, ``mx.np.fmod`` of two bools, and the
four calls the JAX package refuses (``sign`` of bool in ``mx.np`` and
``mx.nd``, ``rsqrt`` and ``sigmoid`` of ints, ``log_sigmoid`` of bool).

The JAX package runs with 64-bit types on (mxnet_tpu/__init__.py:34). Each
test feeds both packages the same numpy values and asserts equal dtypes and
values (ints exactly, floats to 1e-12 relative; ``log_sigmoid`` of ints to
1e-6, since the two packages compute it by other formulas in float32), or
that both raise ``TypeError`` and the port's message names the dtype.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

BOOLS = [True, False, True, False]
INT32 = [1, 4, -3, 0]


def _arrays(ns, values, dtype):
    with mt.cpu():
        t = getattr(mt, ns).array(values, dtype=dtype)
    return t, getattr(jmx, ns).array(values, dtype=dtype)


def _same(got, want):
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    g, w = onp.asarray(got.asnumpy()), onp.asarray(want.asnumpy())
    assert g.shape == w.shape
    if w.dtype.kind == "f":
        onp.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    else:
        onp.testing.assert_array_equal(g, w)


def _both_raise(ns, name, values, dtype):
    t, j = _arrays(ns, values, dtype)
    with pytest.raises(TypeError):
        getattr(getattr(jmx, ns), name)(j)
    with pytest.raises(TypeError, match=f"dtype {dtype}"):
        getattr(getattr(mt, ns), name)(t)


def test_nd_relu_of_bool_is_int64():
    """``jax.nn.relu`` is ``maximum(x, 0)`` with a weak 0: int64 for bool;
    ints and floats keep their dtype."""
    for values, dtype in ((BOOLS, "bool"), (INT32, "int32"),
                          ([-1.5, 0.0, 2.25, -0.0], "float32")):
        t, j = _arrays("nd", values, dtype)
        _same(mt.nd.relu(t), jmx.nd.relu(j))
    t, _ = _arrays("nd", BOOLS, "bool")
    assert str(mt.nd.relu(t).dtype) == "int64"


def test_np_fmod_of_two_bools_keeps_the_dividend_by_false():
    """``fmod(True, False)`` is 1 (lax.rem's ``x % 0``), with the Python
    bool on either side and two arrays; int arrays by zero keep 0, and
    ``mod`` of two bools keeps the integer form."""
    tb, jb = _arrays("np", BOOLS, "bool")
    tc, jc = _arrays("np", [False, False, True, True], "bool")
    _same(mt.np.fmod(True, tb), jmx.np.fmod(True, jb))
    _same(mt.np.fmod(tb, False), jmx.np.fmod(jb, False))
    _same(mt.np.fmod(tb, tc), jmx.np.fmod(jb, jc))
    assert mt.np.fmod(True, tb).asnumpy().tolist() == [0, 1, 0, 1]
    ti, ji = _arrays("np", INT32, "int32")
    tz, jz = _arrays("np", [0, 0, 2, 0], "int32")
    _same(mt.np.fmod(ti, tz), jmx.np.fmod(ji, jz))
    _same(mt.np.mod(tb, tc), jmx.np.mod(jb, jc))


@pytest.mark.parametrize("ns", ["np", "nd"])
def test_sign_of_bool_raises(ns):
    _both_raise(ns, "sign", BOOLS, "bool")
    t, j = _arrays(ns, INT32, "int32")
    _same(getattr(mt, ns).sign(t), getattr(jmx, ns).sign(j))


def test_nd_rsqrt_of_ints_raises():
    for dtype, values in (("int32", INT32), ("int64", INT32),
                          ("bool", BOOLS)):
        _both_raise("nd", "rsqrt", values, dtype)
    t, j = _arrays("nd", [0.25, 4.0], "float32")
    _same(mt.nd.rsqrt(t), jmx.nd.rsqrt(j))


def test_nd_sigmoid_of_ints_raises():
    for dtype, values in (("int32", INT32), ("bool", BOOLS)):
        _both_raise("nd", "sigmoid", values, dtype)
    t, j = _arrays("nd", [-2.0, 0.0, 3.0], "float64")
    _same(mt.nd.sigmoid(t), jmx.nd.sigmoid(j))


def test_nd_log_sigmoid_of_bool_raises():
    """bool raises (the JAX package negates it); ints still return, in
    float32 from int32 and float64 from int64."""
    _both_raise("nd", "log_sigmoid", BOOLS, "bool")
    for dtype in ("int32", "int64"):
        t, j = _arrays("nd", INT32, dtype)
        got, want = mt.nd.log_sigmoid(t), jmx.nd.log_sigmoid(j)
        assert str(got.dtype) == str(want.dtype)
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=1e-6)
