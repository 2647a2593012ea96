"""The INT8 ops of contrib/quantization.py against the JAX package's on the
CPU: ``quantize``, ``quantize_v2`` (calibrated and dynamic), ``dequantize``
and ``requantize`` give the same int8 codes and the same f32 ranges bit for
bit, on inputs built to land on exact .5 ties (round half to even);
``optimal_threshold`` the same float on the same numpy array; the ten
``quantized_*`` ops the same codes and ranges, except that the codes of
the ops that take a transcendental function (sigmoid, tanh, softrelu),
whose f32 values the two libraries may round one ulp apart, may differ by
one at a rounding boundary (counted: at most 1 % of the elements) with
ranges within 1e-6 relative.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.kernels import int8 as kint8


def _both(name, *values, **kwargs):
    """The op ``name`` of each package on the same numpy values (NDArrays
    of each, dtypes kept); ``(port, jax)`` results as numpy."""
    j = getattr(jq, name)(*[jmx.np.array(v, dtype=v.dtype) for v in values],
                          **kwargs)
    with mt.cpu():
        t = getattr(tq, name)(*[mt.np.array(v, dtype=v.dtype)
                                for v in values], **kwargs)

    def host(out):
        out = out if isinstance(out, tuple) else (out,)
        return [onp.asarray(o.asnumpy()) for o in out]
    return host(t), host(j)


def _same(got, want, tag):
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (tag, i, g.dtype,
                                                           w.dtype, g.shape,
                                                           w.shape)
        onp.testing.assert_array_equal(g, w, err_msg=f"{tag} output {i}")


def _f(*v):
    return onp.array(v, "float32") if len(v) > 1 else onp.array(v[0],
                                                                "float32")


#: x * scale lands on k + 0.5 exactly: scale 1 (range +-127) and 2 (+-63.5)
_TIES = _f(-300.0, -127.5, -126.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5,
           126.5, 127.5, 300.0)
_QUARTERS = _TIES / 2


def test_quantize_codes_and_ranges_bitwise():
    """Ties round half to even; out-of-range values saturate at +-127."""
    rs = onp.random.RandomState(0)
    rand = rs.uniform(-4, 6, (5, 7)).astype("float32")
    for x, lo, hi in ((_TIES, -127.0, 127.0), (_QUARTERS, -63.5, 63.5),
                      (rand, -3.0, 5.0), (rand, -1e-30, 0.0),
                      (rand.reshape(35), -0.1, 7.25)):
        got, want = _both("quantize", x, _f(lo), _f(hi))
        _same(got, want, ("quantize", lo, hi))
    # a tie's even neighbour, read directly
    got, _ = _both("quantize", _f(-2.5, -1.5, 0.5, 1.5, 2.5), _f(-127.0),
                   _f(127.0))
    onp.testing.assert_array_equal(got[0], [-2, -2, 0, 2, 2])
    with pytest.raises(ValueError):
        tq.quantize(mt.np.array(rand, device=mt.cpu()), -1.0, 1.0,
                    out_type="uint8")


def test_quantize_v2_calibrated_and_dynamic_bitwise():
    rs = onp.random.RandomState(1)
    x = rs.normal(0, 2, (4, 3, 5)).astype("float32")
    for kw in (dict(min_calib_range=-127.0, max_calib_range=127.0),
               dict(min_calib_range=-1.0, max_calib_range=1.5),
               dict(min_calib_range=-0.3, max_calib_range=0.3)):
        for v in (x, _TIES):
            got, want = _both("quantize_v2", v, **kw)
            _same(got, want, ("quantize_v2", kw))
    for v in (x, _TIES, _QUARTERS, onp.abs(x)):
        got, want = _both("quantize_v2", v)
        _same(got, want, "quantize_v2 dynamic")


def test_dequantize_and_requantize_bitwise():
    rs = onp.random.RandomState(2)
    codes = rs.randint(-127, 128, (6, 9)).astype("int8")
    for lo, hi in ((-3.0, 5.0), (-127.0, 127.0), (-1e-3, 2e-3)):
        got, want = _both("dequantize", codes, _f(lo), _f(hi))
        _same(got, want, ("dequantize", lo, hi))
    acc = rs.randint(-2 ** 31, 2 ** 31 - 1, (5, 8)).astype("int32")
    acc[0, :3] = (1 << 20, -(1 << 21), 0)
    for kw in ({}, dict(min_calib_range=-50.0, max_calib_range=50.0),
               dict(min_calib_range=-0.01, max_calib_range=0.02)):
        got, want = _both("requantize", acc, _f(-100.0), _f(100.0), **kw)
        _same(got, want, ("requantize", kw))


def test_optimal_threshold_equals_the_reference():
    """The same float on the same numpy array (the port spreads each
    candidate q without the reference's per-bin loop): a normal sample
    with an outlier, ReLU'd activations, uniform, too few samples, zeros, a
    heavy tail."""
    rs = onp.random.RandomState(3)
    outlier = onp.concatenate([rs.normal(0, 1, 100000), [50.0]])
    for arr in (outlier,
                onp.maximum(rs.normal(0, 1, (64, 8, 8)), 0).astype("f"),
                rs.uniform(-2, 2, 20000).astype("float32"),
                rs.normal(0, 1, 300), onp.zeros(1000, "float32"),
                rs.standard_t(2, 50000).astype("float32")):
        assert tq.optimal_threshold(arr) == jq.optimal_threshold(arr)
    assert 1.0 < tq.optimal_threshold(outlier) < 25.0


def test_quantized_ops_against_the_reference():
    """The eight range-bookkeeping ops: codes and ranges bit for bit (the
    transcendental activations: codes within one, ranges 1e-6)."""
    rs = onp.random.RandomState(4)

    def codes(*shape):
        return rs.randint(-127, 128, shape).astype("int8")

    x, y = codes(2, 3, 6, 6), codes(2, 3, 6, 6)
    lo, hi, lo2, hi2 = _f(-2.0), _f(3.0), _f(-0.5), _f(0.25)
    exact = [
        ("quantized_act", (x, lo, hi), dict(act_type="relu")),
        ("quantized_flatten", (x, lo, hi), {}),
        ("quantized_pooling", (x, lo, hi), dict(kernel=(2, 2),
                                                stride=(2, 2))),
        ("quantized_pooling", (x, lo, hi), dict(kernel=(3, 3),
                                                pool_type="avg",
                                                stride=(1, 1), pad=(1, 1))),
        ("quantized_pooling", (x, lo, hi), dict(global_pool=True,
                                                pool_type="max")),
        ("quantized_elemwise_add", (x, y, lo, hi, lo2, hi2), {}),
        ("quantized_elemwise_mul", (x, y, lo, hi, lo2, hi2), {}),
        ("quantized_concat", (x, y, codes(2, 1, 6, 6), lo, hi, lo2, hi2,
                              _f(-4.0), _f(1.0)), dict(dim=1)),
        ("quantized_embedding", (rs.randint(0, 6, (2, 4)).astype("int32"),
                                 codes(6, 5), lo, hi), {}),
        ("quantized_batch_norm",
         (x, rs.uniform(0.5, 1.5, 3).astype("float32"),
          rs.uniform(-1, 1, 3).astype("float32"),
          rs.uniform(-0.1, 0.1, 3).astype("float32"),
          rs.uniform(0.5, 1.5, 3).astype("float32"), lo, hi), {}),
    ]
    for name, args, kw in exact:
        got, want = _both(name, *args, **kw)
        _same(got, want, (name, kw))
    for act in ("sigmoid", "tanh", "softrelu"):
        got, want = _both("quantized_act", x, lo, hi, act_type=act)
        assert got[0].dtype == want[0].dtype == onp.int8
        diff = onp.abs(got[0].astype(int) - want[0].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, act
        onp.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)


@pytest.mark.parametrize("kind", ["conv", "fully_connected"])
def test_quantized_conv_and_fully_connected(kind):
    """Q2's int32 sums (its plain version here) inside the reference's
    rescale and requantization: codes and ranges bit for bit, with and
    without bias, strided, padded, dilated, grouped, flattened or not."""
    rs = onp.random.RandomState(5)

    def codes(*shape):
        return rs.randint(-127, 128, shape).astype("int8")

    rng = [_f(-2.0), _f(3.0), _f(-0.5), _f(0.25)]
    brng = [_f(-1.0), _f(1.5)]
    if kind == "conv":
        x = codes(2, 4, 7, 7)
        cases = [((x, codes(6, 4, 3, 3), codes(6)), dict(pad=(1, 1))),
                 ((x, codes(6, 4, 3, 3), codes(6)),
                  dict(stride=(2, 2), dilate=(2, 2), pad=(2, 1))),
                 ((x, codes(6, 2, 1, 1), None), dict(num_group=2,
                                                     no_bias=True)),
                 ((x, codes(4, 1, 3, 3), codes(4)), dict(num_group=4,
                                                         pad=(1, 1)))]
    else:
        cases = [((codes(3, 2, 5), codes(4, 10), codes(4)), {}),
                 ((codes(3, 2, 5), codes(4, 5), None),
                  dict(flatten=False, no_bias=True)),
                 ((codes(1, 7), codes(9, 7), codes(9)), {})]
    for (data, weight, bias), kw in cases:
        args = (data, weight) + (() if bias is None else (bias,)) + tuple(
            rng) + (() if bias is None else tuple(brng))
        jargs = [jmx.np.array(v, dtype=v.dtype) for v in args]
        with mt.cpu():
            targs = [mt.np.array(v, dtype=v.dtype) for v in args]
            if bias is None:
                targs.insert(2, None)
            got = getattr(tq, f"quantized_{kind}")(*targs, **kw)
        if bias is None:
            jargs.insert(2, None)
        want = getattr(jq, f"quantized_{kind}")(*jargs, **kw)
        _same([onp.asarray(o.asnumpy()) for o in got],
              [onp.asarray(o.asnumpy()) for o in want], (kind, kw))


def test_registry_spellings_and_the_kernel_twins():
    """The ``_contrib_*`` names of ``mx.nd`` are the ops; Q1's plain version
    rounds half to even and saturates; Q2's plain version is the exact
    integer convolution."""
    import torch

    rs = onp.random.RandomState(6)
    x = rs.normal(0, 1, (3, 4)).astype("float32")
    with mt.cpu():
        a = mt.nd._contrib_quantize(mt.np.array(x), mt.np.array(_f(-1.0)),
                                    mt.np.array(_f(2.0)))
        b = tq.quantize(mt.np.array(x), _f(-1.0), _f(2.0))
        thr = mt.nd._contrib_calibrate_entropy(mt.np.array(
            rs.normal(0, 1, 5000).astype("float32")))
    for u, v in zip(a, b):
        onp.testing.assert_array_equal(u.asnumpy(), v.asnumpy())
    assert thr.shape == () and thr.dtype == onp.float32
    codes, info = kint8.quantize_reference(
        torch.tensor([-2.5, -0.5, 0.5, 1.5, 200.0]), torch.tensor([-127.0,
                                                                   127.0]))
    assert codes.tolist() == [-2, 0, 0, 2, 127]
    assert info.tolist() == [-127.0, 127.0, 1.0]
    xq = torch.from_numpy(rs.randint(-127, 128, (2, 4, 5, 5)).astype("int8"))
    wq = torch.from_numpy(rs.randint(-127, 128, (6, 2, 3, 3)).astype("int8"))
    acc = kint8.conv(xq, wq, 1, 1, 1, 2)
    want = torch.nn.functional.conv2d(xq.long().double(), wq.double(), None,
                                      1, 1, 1, 2)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.long(), want.long())
