"""Queue 3's seven faults of the re-anchor before slice 16, each held
against the JAX package on the CPU (64-bit types on there, as
mxnet_tpu/__init__.py sets them). Both packages get the same numpy
values; dtypes must be equal, ints and bools exactly, floats to 1e-6
relative (1e-5 for digamma, whose XLA form differs near its root).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt


def _same(got, want, tag, rtol=1e-6):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), tag
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, (tag, i), rtol)
        return
    assert str(got.dtype) == str(want.dtype), (tag, got.dtype, want.dtype)
    g, w = onp.asarray(got.asnumpy()), onp.asarray(want.asnumpy())
    assert g.shape == w.shape, (tag, g.shape, w.shape)
    if w.dtype.kind == "f":
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7,
                                    equal_nan=True, err_msg=str(tag))
        # signed zeros and infinities compare by sign too
        assert (onp.signbit(g) == onp.signbit(w)).all(), (tag, g, w)
    else:
        onp.testing.assert_array_equal(g, w, err_msg=str(tag))


def _both(fn, *values, **kwargs):
    """``fn(module, *arrays, **kwargs)`` in each package, each value an
    array (numpy values, their dtype kept) of that package."""
    j = fn(jmx, *[jmx.np.array(v, dtype=v.dtype) for v in values], **kwargs)
    with mt.cpu():
        t = fn(mt, *[mt.np.array(v, dtype=v.dtype) for v in values],
               **kwargs)
    return t, j


def _net_pair(module, device=None):
    net = module.gluon.nn.HybridSequential()
    net.add(module.gluon.nn.Dense(4, in_units=3, activation="relu"),
            module.gluon.nn.Dense(2, in_units=4))
    return net


def test_hybridize_takes_static_alloc_and_static_shape():
    """Item 1: the flags are kept, as the JAX package keeps them, and the
    hybridized net computes the JAX net's output from its weights."""
    x = onp.random.RandomState(0).rand(5, 3).astype("f")
    jnet = _net_pair(jmx)
    jnet.initialize()
    jnet.hybridize(static_alloc=True, static_shape=True)
    with mt.cpu():
        tnet = _net_pair(mt)
        tnet.initialize()
        tnet.hybridize(static_alloc=True, static_shape=True)
        mt.gluon.nn.Dense(2).hybridize(True, static_alloc=True)
        mt.gluon.nn.Sequential().hybridize(static_shape=True)
        from mxnet_tpu_torch.convert import load_jax_params
        load_jax_params(tnet, {k: p.data().asnumpy()
                               for k, p in jnet.collect_params().items()})
        out = tnet(mt.np.array(x))
    assert tnet._flags == jnet._flags == {"static_alloc": True,
                                          "static_shape": True}
    _same(out, jnet(jmx.np.array(x)), "hybridized forward", rtol=1e-5)


def test_ctx_spellings_of_initialize_and_grad():
    """Item 2: ``initialize(ctx=, verbose=)``, ``Parameter.initialize(
    ctx=)`` (a list of one device too) and ``Parameter.grad(ctx=,
    device=)``; a device the parameter is not on raises KeyError in both."""
    jnet = jmx.gluon.nn.Dense(2, in_units=3)
    jnet.initialize(ctx=jmx.cpu(), verbose=True)
    tnet = mt.gluon.nn.Dense(2, in_units=3)
    tnet.initialize(ctx=mt.cpu(), verbose=True)
    tnet2 = mt.gluon.nn.Dense(2, in_units=3)
    tnet2.initialize(ctx=[mt.cpu()])
    for net, dev in ((jnet, jmx.cpu()), (tnet, mt.cpu()), (tnet2, mt.cpu())):
        w = net.weight
        assert tuple(w.grad(ctx=dev).shape) == (2, 3)
        assert tuple(w.grad(device=dev).shape) == (2, 3)
        assert float(abs(w.grad(ctx=dev)).sum()) == 0.0
    with pytest.raises(KeyError):
        jnet.weight.grad(ctx=jmx.gpu(0))
    with pytest.raises(KeyError):
        tnet.weight.grad(ctx=mt.gpu(0))
    jp = jmx.gluon.Parameter("w", shape=(2, 2))
    jp.initialize(ctx=jmx.cpu())
    tp = mt.gluon.Parameter("w", shape=(2, 2))
    tp.initialize(ctx=[mt.cpu()])
    assert tp.data().shape == jp.data().shape == (2, 2)
    assert tp.list_ctx() == [mt.cpu()]


def test_clip_without_bounds_returns_the_values():
    """Item 3: ``mx.nd.clip(x)`` and ``NDArray.clip()``."""
    for dtype in ("float32", "int32"):
        x = onp.array([1.5, -2.0, 7.0]).astype(dtype)
        _same(*_both(lambda m, a: m.nd.clip(a), x), ("nd.clip", dtype))
        _same(*_both(lambda m, a: a.clip(), x), ("NDArray.clip", dtype))
        _same(*_both(lambda m, a: a.clip(0, 2), x), ("clip(0, 2)", dtype))


ACT_TYPES = ("relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
             "erf_gelu", "gelu_tanh", "silu", "swish", "mish",
             "hard_sigmoid", "hard_swish", "relu6", "softmax",
             "log_softmax", "identity")


def test_npx_activation_relu_and_softmax_on_int_and_bool():
    """Item 4: every act_type of int32, int64 and bool inputs gives the
    JAX package's dtype and values, or raises TypeError where it does."""
    values = {"int32": [2, -1, 0, 3], "int64": [3, -2, 0, 1],
              "bool": [True, False, True, True]}
    for dtype, vals in values.items():
        x = onp.array(vals).astype(dtype)
        cases = [(f"activation {a}", lambda m, v, a=a: m.npx.activation(v, a))
                 for a in ACT_TYPES]
        cases += [("relu", lambda m, v: m.npx.relu(v)),
                  ("softmax", lambda m, v: m.npx.softmax(v))]
        for tag, fn in cases:
            try:
                want = fn(jmx, jmx.np.array(x, dtype=dtype))
            except TypeError:
                with pytest.raises(TypeError), mt.cpu():
                    fn(mt, mt.np.array(x, dtype=dtype))
                continue
            with mt.cpu():
                got = fn(mt, mt.np.array(x, dtype=dtype))
            _same(got, want, (tag, dtype), rtol=1e-6)


def test_np_arguments_the_jax_package_takes():
    """Item 5: each argument of the queue's list, in both packages."""
    r = onp.random.RandomState(1)
    a = onp.array([3, 1, 2, 3, 1, 5], "int32")
    m = r.rand(3, 4).astype("f")
    v3 = r.rand(4, 3).astype("f")
    w3 = r.rand(4, 3).astype("f")
    ints = r.randint(0, 4, (3, 4)).astype("int32")
    cases = [
        ("unique", lambda mm, x: mm.np.unique(
            x, return_index=True, return_inverse=True, return_counts=True),
         (a,)),
        ("unique axis", lambda mm, x: mm.np.unique(
            x, axis=0, return_counts=True),
         (onp.array([[1, 2], [0, 1], [1, 2]], "int32"),)),
        ("diff", lambda mm, x: mm.np.diff(x, prepend=0, append=7), (a,)),
        ("diff 2d", lambda mm, x: mm.np.diff(x, axis=0, prepend=1.5), (m,)),
        ("ediff1d", lambda mm, x: mm.np.ediff1d(
            x, to_begin=onp.array([9, 8]), to_end=-1), (a,)),
        ("angle deg", lambda mm, x: mm.np.angle(x, deg=True),
         (onp.array([-1.0, 0.0, -0.0, 2.0], "f"),)),
        ("angle int", lambda mm, x: mm.np.angle(x), (a,)),
        ("cross axes", lambda mm, x, y: mm.np.cross(
            x, y, axisa=0, axisb=0, axisc=0),
         (v3.T.copy(), w3.T.copy())),
        ("cross axis", lambda mm, x, y: mm.np.cross(x, y, axis=1),
         (v3, w3)),
        ("take_along_axis", lambda mm, x, i: mm.np.take_along_axis(x, i),
         (m, ints % 4)),
        ("concatenate dtype", lambda mm, x, y: mm.np.concatenate(
            [x, y], dtype="float64"), (a, a)),
        ("stack dtype", lambda mm, x, y: mm.np.stack([x, y], dtype="int64"),
         (a, a)),
        ("hstack dtype", lambda mm, x, y: mm.np.hstack(
            [x, y], dtype="float32"), (a, a)),
        ("vstack dtype", lambda mm, x, y: mm.np.vstack(
            [x, y], dtype="float32"), (a, a)),
        ("dstack dtype", lambda mm, x, y: mm.np.dstack(
            [x, y], dtype="float32"), (a, a)),
        ("trace dtype", lambda mm, x: mm.np.trace(x, dtype="float64"),
         (ints,)),
        ("meshgrid sparse", lambda mm, x, y: mm.np.meshgrid(
            x, y, sparse=True, copy=True), (a[:3], a[:4])),
        ("meshgrid ij sparse", lambda mm, x, y: mm.np.meshgrid(
            x, y, sparse=True, indexing="ij"), (a[:3], a[:4])),
        ("reshape shape=", lambda mm, x: mm.np.reshape(x, shape=(4, 3)),
         (m,)),
        ("reshape order F", lambda mm, x: mm.np.reshape(x, (2, 6),
                                                        order="F"), (m,)),
        ("ravel order F", lambda mm, x: mm.np.ravel(x, order="F"), (m,)),
        ("sort descending", lambda mm, x: mm.np.sort(
            x, descending=True, stable=True), (a,)),
        ("argsort descending", lambda mm, x: mm.np.argsort(
            x, descending=True, stable=True), (a,)),
        ("argsort stable", lambda mm, x: mm.np.argsort(x, stable=True),
         (ints,)),
        ("reshape_like", lambda mm, x, y: mm.nd.reshape_like(
            x, y, lhs_begin=1, lhs_end=2, rhs_begin=0, rhs_end=2),
         (onp.zeros((2, 6), "f"), onp.zeros((2, 3, 5), "f"))),
        ("reshape_like tail", lambda mm, x, y: mm.nd.reshape_like(
            x, y, lhs_begin=-1, rhs_begin=1),
         (onp.zeros((5, 12), "f"), onp.zeros((7, 4, 3), "f"))),
    ]
    for mm in (jmx, mt):
        with pytest.raises(ValueError), mt.cpu():
            mm.np.meshgrid(mm.np.array(a), copy=False)
    for tag, fn, vals in cases:
        got, want = _both(fn, *vals)
        if isinstance(want, list):
            got, want = tuple(got), tuple(want)
        _same(got, want, tag)


def test_cbrt_rcbrt_and_digamma_at_signed_zero():
    """Item 6: the sign of -0.0 through cbrt, -inf from rcbrt(-0.0), and
    nan at digamma's pole at +-0."""
    x = onp.array([-0.0, 0.0, -8.0, 27.0, 1.5, -1.0, 0.25], "f")
    for name in ("cbrt", "rcbrt", "digamma"):
        _same(*_both(lambda m, v, n=name: getattr(m.nd, n)(v), x),
              ("nd", name), rtol=1e-5)
    _same(*_both(lambda m, v: m.np.cbrt(v), x), "np.cbrt")


def test_top_level_subpackages_are_attributes():
    """Item 7: ``mx.serving``, ``mx.observability``, ``mx.io``,
    ``mx.recordio``, ``gluon.data`` and ``gluon.utils`` need no import of
    their own, as in the JAX package."""
    for name in ("serving", "observability", "io", "recordio"):
        assert hasattr(jmx, name) and hasattr(mt, name), name
    for name in ("data", "utils"):
        assert hasattr(jmx.gluon, name) and hasattr(mt.gluon, name), name
    assert mt.serving.InferenceEngine.__name__ == "InferenceEngine"
    assert mt.observability.reqtrace.__name__.endswith("reqtrace")
    # the JAX package's public names, but the image decoders
    decoders = {"ImageFolderDataset", "ImageListDataset",
                "ImageRecordDataset", "ImageRecordIter", "pack_img",
                "unpack_img"}
    for jm, tm in ((jmx.gluon.data, mt.gluon.data),
                   (jmx.gluon.data.vision, mt.gluon.data.vision),
                   (jmx.gluon.data.vision.transforms,
                    mt.gluon.data.vision.transforms),
                   (jmx.io, mt.io), (jmx.recordio, mt.recordio),
                   (jmx.gluon.utils, mt.gluon.utils)):
        names = set(getattr(jm, "__all__", None) or (
            n for n in dir(jm) if not n.startswith("_")
            and getattr(getattr(jm, n), "__module__", "").startswith(
                jm.__name__)))
        missing = names - decoders - set(dir(tm))
        assert not missing, (jm.__name__, sorted(missing))
