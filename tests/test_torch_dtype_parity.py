"""The port's ``mx.np``, ``mx.nd`` and NDArray operators against the JAX
package on dtypes: the faults of ROADMAP queue 3 (items 1-6), held on the
CPU.

The JAX package runs with 64-bit types on (mxnet_tpu/__init__.py:34), so a
weak Python float meeting an int or bool array gives float64, a float
function of int64 gives float64, and bool counts as int32 where numbers are
needed. The port decides those dtypes in one place,
``mxnet_tpu_torch/ops/promote.py``. Each case feeds both packages the same
numpy values and asserts equal dtypes and values: ints and bools exactly,
floats to 1e-12 relative (the cases are chosen so that both sides compute
in float64 or exactly).
"""
import operator

import numpy as onp

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

INTS = {"int32": [1, 2, 3, 7], "int64": [1, -2, 3, 7], "int8": [1, -2, 3, 7],
        "uint8": [1, 2, 3, 7], "bool": [True, False, True, True]}


def _pair(values, dtype):
    with mt.cpu():
        t = mt.np.array(values, dtype=dtype)
    return t, jmx.np.array(values, dtype=dtype)


def _same(got, want, tag):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), tag
        for g, w in zip(got, want):
            _same(g, w, tag)
        return
    assert str(got.dtype) == str(want.dtype), (tag, got.dtype, want.dtype)
    g, w = onp.asarray(got.asnumpy()), onp.asarray(want.asnumpy())
    assert g.shape == w.shape, tag
    if w.dtype.kind == "f":
        onp.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                    equal_nan=True, err_msg=str(tag))
    else:
        onp.testing.assert_array_equal(g, w, err_msg=str(tag))


def _both(fn_name, *args, ns="np"):
    """``mx.<ns>.<fn_name>`` of each package on its own operands: an
    ``(values, dtype)`` pair becomes an array, anything else is passed."""
    t_args, j_args = [], []
    for a in args:
        if isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], str):
            t, j = _pair(*a)
        else:
            t = j = a
        t_args.append(t)
        j_args.append(j)
    t_fn = getattr(getattr(mt, ns), fn_name)
    j_fn = getattr(getattr(jmx, ns), fn_name)
    return t_fn(*t_args), j_fn(*j_args)


def test_heaviside_promotes_both_operands():
    """Item 1: x2 was cast to x1's dtype, so an int or bool x1 lost x2's
    value where x1 == 0 (0.5 became 0) and kept its int dtype."""
    cases = [(([0, 1, -2], "int32"), 0.5), (([True, False], "bool"),
                                             ([0.25, 0.75], "float32")),
             (([0.0, -1.0, 2.0], "float32"), 0.5),
             (([0, 3, -1], "int64"), ([7, 7, 7], "int32"))]
    for x1, x2 in cases:
        _same(*_both("heaviside", x1, x2), ("heaviside", x1, x2))
    got, _ = _both("heaviside", ([0, 1, -2], "int32"), 0.5)
    assert got.asnumpy().tolist() == [0.5, 1.0, 0.0]


PY_FLOAT_FNS = """add subtract multiply divide true_divide floor_divide divmod
mod remainder fmod power pow float_power maximum minimum fmax fmin arctan2
atan2 copysign hypot ldexp logaddexp logaddexp2 nextafter""".split()


def test_int_or_bool_array_with_a_python_float():
    """Item 2: the 25 binary functions of ``mx.np`` with an int or bool
    array and a Python float, on both sides, compute in float64."""
    for name, dtype in ((n, d) for n in PY_FLOAT_FNS
                        for d in ("int32", "int64", "bool")):
        arr = (INTS[dtype], dtype)
        for args in ((arr, 2.5), (2.5, arr)):
            got, want = _both(name, *args)
            _same(got, want, (name, args))
            first = got[0] if isinstance(got, tuple) else got
            if name != "ldexp" or args[0] is arr:
                assert str(first.dtype) == "float64", (name, args)


def test_unary_dtypes():
    """Item 3: ``fabs``, ``rint``, ``square``/``power`` of bool, ``angle``
    in ``mx.np`` and ``rint``, ``reciprocal``, ``hard_sigmoid``, ``norm`` in
    ``mx.nd``; and every float function of int64 in float64."""
    np_cases = [("fabs", d) for d in ("int32", "int64", "uint8", "bool")]
    np_cases += [("rint", d) for d in ("int32", "int64", "bool")]
    np_cases += [("square", "bool"), ("angle", "int32"), ("angle", "bool")]
    np_cases += [(n, "int64") for n in ("sqrt", "exp2", "log2", "cbrt",
                                        "reciprocal", "degrees", "mean",
                                        "var", "median")]
    for name, dtype in np_cases:
        _same(*_both(name, (INTS[dtype], dtype)), ("np", name, dtype))
    _same(*_both("power", (INTS["bool"], "bool"), 2), "np.power(bool, 2)")
    for name in ("rint", "reciprocal", "hard_sigmoid", "norm", "sqrt"):
        for dtype in ("int32", "int64"):
            _same(*_both(name, (INTS[dtype], dtype), ns="nd"),
                  ("nd", name, dtype))
    got, _ = _both("rint", (INTS["int32"], "int32"))
    assert str(got.dtype) == "float64"


def test_np_functions_that_raised_now_return():
    """Item 4, ``mx.np``: bool inputs of abs/ceil/floor/trunc/rint, the
    integer division family and shifts of two bools, subtract with a bool,
    hypot/logaddexp/logaddexp2/nextafter of ints, vecdot of ints or mixed
    dtypes, argmax/argmin/nanarg* of bool, nanmax/nanmin of ints."""
    b = (INTS["bool"], "bool")
    for name in ("abs", "absolute", "fabs", "ceil", "floor", "trunc",
                 "rint", "argmax", "argmin", "nanargmax", "nanargmin"):
        _same(*_both(name, b), (name, "bool"))
    for name in ("floor_divide", "mod", "remainder", "fmod", "power",
                 "left_shift", "right_shift"):
        _same(*_both(name, b, ([True, True, True, True], "bool")),
              (name, "bool", "bool"))
    for other in (("int32", INTS["int32"]), ("float32", [0.5, 1.5, 2, 3])):
        arr = (other[1], other[0])
        for args in ((b, arr), (arr, b), (b, 2), (2, b), (arr, True),
                     (True, arr)):
            _same(*_both("subtract", *args), ("subtract", args))
    for name in ("hypot", "logaddexp", "logaddexp2", "nextafter"):
        for d1, d2 in (("int64", "int64"), ("int64", "int32"),
                       ("bool", "int64")):
            _same(*_both(name, (INTS[d1], d1), (INTS[d2], d2)),
                  (name, d1, d2))
    _same(*_both("hypot", ([3, 0], "int32"), ([4, 5], "int32")),
          "hypot int32")
    for d1, d2 in (("int32", "int32"), ("int8", "int64"), ("bool", "bool"),
                   ("int32", "float32")):
        x1 = (INTS[d1], d1) if d1 != "float32" else ([0.5, 1, 2, 4], d1)
        x2 = (INTS[d2], d2) if d2 != "float32" else ([0.5, 1, 2, 4], d2)
        _same(*_both("vecdot", x1, x2), ("vecdot", d1, d2))
    for name in ("nanmax", "nanmin"):
        for dtype in ("int32", "int64", "uint8", "int8"):
            _same(*_both(name, (INTS[dtype], dtype)), (name, dtype))


def test_nd_functions_that_raised_now_return():
    """Item 4, ``mx.nd``: hypot, broadcast_hypot and log_sigmoid of ints;
    the bool forms of abs/ceil/floor/trunc/fix/square and a bool minus an
    int."""
    for name in ("hypot", "broadcast_hypot"):
        for d1, d2 in (("int64", "int64"), ("int32", "int64")):
            _same(*_both(name, (INTS[d1], d1), (INTS[d2], d2), ns="nd"),
                  (name, d1, d2))
        _same(*_both(name, ([3, 0], "int32"), ([4, 5], "int32"), ns="nd"),
              (name, "int32"))
    _same(*_both("log_sigmoid", (INTS["int64"], "int64"), ns="nd"),
          "log_sigmoid int64")
    for name in ("abs", "ceil", "floor", "trunc", "fix", "square"):
        _same(*_both(name, (INTS["bool"], "bool"), ns="nd"), (name, "bool"))
    for name in ("broadcast_sub", "elemwise_sub"):
        _same(*_both(name, (INTS["bool"], "bool"), (INTS["int32"], "int32"),
                     ns="nd"), (name, "bool", "int32"))


OPS = [operator.add, operator.sub, operator.mul, operator.truediv,
       operator.floordiv, operator.mod, operator.pow]


def test_ndarray_with_a_python_int_or_bool():
    """Item 5: the NDArray operators with a Python int or bool: int64/bool
    divided by an int is float64; a bool array to an int power is int32;
    int minus True, bool minus 2, bool // True and bool % True return; a
    float floor-divided by False is nan."""
    for dtype in ("int32", "int64", "uint8", "bool", "float32"):
        # no negative int exponent: XLA's integer power of one is not
        # numpy's (ROADMAP queue 3, not faults of the port)
        values = {"bool": INTS["bool"], "float32": [0.5, -1.5, 2.0, 7.0]}.get(
            dtype, [1, 2, 3, 7])
        a_t, a_j = _pair(values, dtype)
        for op in OPS:
            for scalar in (2, True):
                if dtype == "bool" and scalar is True and op is operator.sub:
                    continue  # bool - bool raises in both packages
                for side in ("left", "right"):
                    f = (lambda a, op=op, s=scalar: op(a, s)) \
                        if side == "left" else \
                        (lambda a, op=op, s=scalar: op(s, a))
                    if side == "right" and op in (operator.floordiv,
                                                  operator.mod,
                                                  operator.truediv) \
                            and dtype == "bool":
                        continue  # a zero divisor: item 6's test
                    _same(f(a_t), f(a_j), (dtype, op.__name__, scalar, side))
    b_t, _ = _pair(INTS["bool"], "bool")
    assert str((b_t ** 2).dtype) == str((b_t ** True).dtype) == "int32"
    assert str((b_t / 2).dtype) == "float64"
    f_t, f_j = _pair([2.5, -2.5, 0.0], "float32")
    _same(f_t // False, f_j // False, "f32 // False")
    assert onp.isnan(onp.asarray((f_t // False).asnumpy())).all()
    _same(2.5 // b_t, 2.5 // _pair(INTS["bool"], "bool")[1], "2.5 // bool")
    _same(*_both("floor_divide", ([2.5, -2.5], "float32"), False),
          "np.floor_divide(f32, False)")


def test_integer_division_by_zero_contract():
    """Item 6: integer ``//`` and ``%`` by a zero element return the JAX
    package's values and do not raise (the contract of
    ``mxnet_tpu_torch/ops/promote.py``): ``x // 0`` is -1 where x is 0 and
    -2 elsewhere for signed types, the largest value for unsigned ones;
    ``x % 0`` (mod, remainder, fmod) is 0."""
    for dtype in ("int32", "int64", "int8", "uint8"):
        _division_by_zero(dtype)


def _division_by_zero(dtype):
    x = [7, 200, 0, 5] if dtype == "uint8" else [7, -7, 0, 5]
    zeros = ([0, 0, 0, 0], dtype)
    signed = dtype != "uint8"
    want_q = [-2, -2, -1, -2] if signed else [255] * 4
    for name in ("floor_divide", "mod", "remainder", "fmod", "divmod"):
        for args in (((x, dtype), zeros), ((x, dtype), 0),
                     ((x, dtype), False)):
            got, want = _both(name, *args)
            _same(got, want, (name, args))
            q = got[0] if name == "divmod" else got
            r = got[1] if name == "divmod" else got
            if name in ("floor_divide", "divmod"):
                assert q.asnumpy().tolist() == want_q, (name, args)
            if name != "floor_divide":
                assert r.asnumpy().tolist() == [0] * 4, (name, args)
    a_t, a_j = _pair(x, dtype)
    for op in (operator.floordiv, operator.mod):
        _same(op(a_t, 0), op(a_j, 0), (op.__name__, "array, 0"))
        _same(op(2, a_t), op(2, a_j), (op.__name__, "2, array"))
    assert (a_t // 0).asnumpy().tolist() == want_q
