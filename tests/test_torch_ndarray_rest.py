"""``NDArray``'s methods of ROADMAP queue 1 item 4 (``norm``, ``split`` in
both spellings, ``take``, ``tostype``, ``__array_ufunc__``,
``__array_function__``, ``__dlpack__``, ``__dlpack_device__``), each held
against the JAX package's NDArray on the CPU (64-bit types on). Values
within 1e-6 relative + 1e-7, dtypes and shapes equal."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

R = onp.random.RandomState(23)
F = R.uniform(-2, 2, (4, 6)).astype("float32")


def _pair(a):
    with mt.cpu():
        t = mt.np.array(a, dtype=a.dtype)
    return t, jmx.np.array(a, dtype=a.dtype)


def _same(got, want, tag):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), tag
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, (tag, k))
        return
    assert type(got) is mt.NDArray, (tag, type(got))
    g, w = got.asnumpy(), onp.asarray(want.asnumpy())
    assert g.dtype == w.dtype and g.shape == w.shape, (tag, g.dtype, w.dtype,
                                                       g.shape, w.shape)
    onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=str(tag))


def test_norm_split_and_take():
    t, j = _pair(F)
    for kw in ({}, dict(ord=1, axis=0), dict(ord=2, axis=1, keepdims=True),
               dict(ord="fro"), dict(ord=onp.inf, axis=1)):
        _same(t.norm(**kw), j.norm(**kw), ("norm", kw))
    for args, kw in (((2,), {}), (([1, 4],), dict(axis=1)), ((3,), dict(
            axis=1)), ((), dict(num_outputs=3)), ((), dict(
                num_outputs=2, axis=0)), ((), dict(num_outputs=6,
                                                  squeeze_axis=True))):
        _same(t.split(*args, **kw), j.split(*args, **kw), ("split", kw))
    with pytest.raises(TypeError):
        t.split(2, squeeze_axis=True)
    idx = onp.array([[0, 5], [7, -1]], "int32")
    ti, ji = _pair(idx)
    fi, fj = _pair(onp.array([0.0, 2.7, 30.0], "float32"))
    for (a, b), kw in (((ti, ji), {}), ((ti, ji), dict(axis=1)),
                       ((ti, ji), dict(axis=1, mode="wrap")),
                       ((fi, fj), dict(axis=0)), ((ti, ji), dict(
                           axis=0, mode="fill"))):
        _same(t.take(a, **kw), j.take(b, **kw), ("take", kw))


def test_tostype_round_trips():
    dense = F * (R.uniform(0, 1, F.shape) > 0.6)
    dense[2] = 0
    t, j = _pair(dense.astype("float32"))
    assert t.tostype("default") is t
    for stype in ("csr", "row_sparse"):
        got, want = t.tostype(stype), j.tostype(stype)
        assert got.stype == want.stype == stype
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        onp.testing.assert_array_equal(got.indices.asnumpy(),
                                       onp.asarray(want.indices))
        back = got.tostype("default")
        assert type(back) is mt.NDArray
        onp.testing.assert_array_equal(back.asnumpy(), dense)


def test_numpy_protocols():
    t, j = _pair(F)
    u, k = _pair(F[::-1].copy())
    with mt.cpu():
        # ufuncs of NDArrays are mx.np's functions, on the arrays' device
        for ufunc in (onp.exp, onp.negative, onp.sqrt, onp.floor):
            _same(ufunc(t), ufunc(j), ufunc.__name__)
        for ufunc in (onp.add, onp.multiply, onp.maximum, onp.arctan2):
            _same(ufunc(t, u), ufunc(j, k), ufunc.__name__)
            _same(ufunc(F, u), ufunc(F, k), (ufunc.__name__, "numpy first"))
        _same(onp.add(t, 1.5, dtype="float64"),
              onp.add(j, 1.5, dtype="float64"), "dtype=")
        out_t, out_j = mt.np.zeros((4, 6)), jmx.np.zeros((4, 6))
        assert onp.subtract(t, u, out=out_t) is out_t
        onp.subtract(j, k, out=out_j)
        _same(out_t, out_j, "out=")
        # numpy functions of NDArrays are mx.np's (or mx.np.linalg's)
        _same(onp.concatenate([t, u]), onp.concatenate([j, k]), "concat")
        _same(onp.mean(t, axis=0), onp.mean(j, axis=0), "mean")
        _same(onp.linalg.norm(t), onp.linalg.norm(j), "linalg.norm")
        _same(onp.where(t > 0, t, u), onp.where(j > 0, j, k), "where")
        _same(onp.clip(t, -1, 1), onp.clip(j, -1, 1), "clip")
        host = onp.zeros(6, "float32")
        onp.sum(t, axis=0, out=host)
        onp.testing.assert_allclose(host, F.sum(0), rtol=1e-6)
        # a ufunc method other than a call, a keyword other than axis and
        # a name mx.np lacks are NotImplemented (numpy raises TypeError),
        # as in the JAX package; the names both packages have agree
        for tag, call in (
                ("reduce", lambda a: onp.add.reduce(a)),
                ("accumulate", lambda a: onp.add.accumulate(a)),
                ("where=", lambda a: onp.add(a, a, where=a > 0)),
                ("iscomplexobj", onp.iscomplexobj),
                ("frexp", onp.frexp), ("spacing", onp.spacing),
                ("apply_over_axes",
                 lambda a: onp.apply_over_axes(onp.sum, a, [0])),
                ("nanmedian", onp.nanmedian), ("ldexp",
                                               lambda a: onp.ldexp(a, 2)),
                ("piecewise", lambda a: onp.piecewise(a, [a > 0], [1, 0]))):
            try:
                want = call(j)
            except TypeError:
                with pytest.raises(TypeError):
                    call(t)
                continue
            _same(call(t), want, tag)


def test_dlpack():
    t, j = _pair(F)
    assert t.__dlpack_device__() == (1, 0)
    assert t.__dlpack_device__() == j.__dlpack_device__()
    back = onp.from_dlpack(t)
    onp.testing.assert_array_equal(back, F)
    with mt.cpu():
        t.attach_grad()   # a variable exports too (its value)
        shared = mt.np.from_dlpack(t)
    assert shared._data.data_ptr() == t._data.data_ptr()
    onp.testing.assert_array_equal(mt.nd.from_jax(j._data).asnumpy(), F)
