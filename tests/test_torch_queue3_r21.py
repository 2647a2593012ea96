"""Queue 3's faults of the re-anchor before slice 21, each held against the
JAX package on the CPU with the same inputs: ``Parameter``'s positional
order, ``convolution(kernel_layout=)``, the keyword names of
``npx.relu``/``npx.sigmoid``/``npx.seed``, and the shape of an array made
from a scalar (found on the way: ``np.ascontiguousarray`` made it 1-d).
Floats to 1e-5 relative (a convolution sums in another order in each
library), shapes and dtypes equal.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt


def test_parameter_takes_the_reference_positional_order():
    args = ("w", "write", (2, 3), "float32", 0.5, 2.0, "zeros", True, False)
    j = jmx.gluon.Parameter(*args)
    t = mt.gluon.Parameter(*args)
    for p in (j, t):
        assert (p.lr_mult, p.wd_mult) == (0.5, 2.0)
        assert p.shape == (2, 3) and p.grad_req == "null"
    assert t.init == j.init == "zeros"
    assert t.allow_deferred_init == j.allow_deferred_init is True


@pytest.mark.parametrize("namespace", ["nd", "npx"])
def test_convolution_kernel_layout(namespace):
    """A weight laid out as ``kernel_layout`` says gives the default
    spec's output: HWIO, OIHW and OHWI under NHWC, OIHW under NCHW."""
    rs = onp.random.RandomState(0)
    x_nhwc = rs.uniform(-1, 1, (2, 7, 6, 4)).astype("f")
    w_ohwi = rs.uniform(-1, 1, (5, 3, 3, 4)).astype("f")
    b = rs.uniform(-1, 1, 5).astype("f")
    cases = [("NHWC", x_nhwc, "HWIO", w_ohwi.transpose(1, 2, 3, 0)),
             ("NHWC", x_nhwc, "OIHW", w_ohwi.transpose(0, 3, 1, 2)),
             ("NHWC", x_nhwc, "OHWI", w_ohwi),
             ("NCHW", x_nhwc.transpose(0, 3, 1, 2), "OIHW",
              w_ohwi.transpose(0, 3, 1, 2))]
    for layout, x, spec, w in cases:
        kw = dict(stride=(2, 1), pad=(1, 1), layout=layout,
                  kernel_layout=spec)
        want = getattr(jmx, namespace).convolution(
            jmx.np.array(x), jmx.np.array(w), jmx.np.array(b), **kw)
        with mt.cpu():
            got = getattr(mt, namespace).convolution(
                mt.np.array(x), mt.np.array(w), mt.np.array(b), **kw)
            default = getattr(mt, namespace).convolution(
                mt.np.array(x), mt.np.array(
                    w_ohwi if layout == "NHWC" else
                    w_ohwi.transpose(0, 3, 1, 2)), mt.np.array(b),
                stride=(2, 1), pad=(1, 1), layout=layout)
        want = onp.asarray(want.asnumpy())
        assert got.shape == want.shape, (layout, spec)
        onp.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5,
                                    atol=1e-5, err_msg=f"{layout} {spec}")
        onp.testing.assert_allclose(got.asnumpy(), default.asnumpy(),
                                    rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        with mt.cpu():
            mt.nd.convolution(mt.np.array(x_nhwc), mt.np.array(w_ohwi),
                              layout="NHWC", kernel_layout="HWIX")


def test_npx_keyword_spellings():
    x = onp.array([[-1.5, 0.0, 2.0]], "float32")
    for name in ("relu", "sigmoid"):
        want = getattr(jmx.npx, name)(x=jmx.np.array(x)).asnumpy()
        with mt.cpu():
            fn = getattr(mt.npx, name)
            for got in (fn(x=mt.np.array(x)), fn(data=mt.np.array(x)),
                        fn(mt.np.array(x))):
                onp.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6)
            with pytest.raises(TypeError):
                fn(mt.np.array(x), x=mt.np.array(x))
            with pytest.raises(TypeError):
                fn()
    draws = []
    for kw in (dict(s=7), dict(seed_state=7)):
        mt.npx.seed(**kw)
        with mt.cpu():
            draws.append(mt.np.random.uniform(size=(3,)).asnumpy())
    mt.npx.seed(7)
    with mt.cpu():
        draws.append(mt.np.random.uniform(size=(3,)).asnumpy())
    onp.testing.assert_array_equal(draws[0], draws[1])
    onp.testing.assert_array_equal(draws[0], draws[2])
    jmx.npx.seed(s=7)
    with pytest.raises(TypeError):
        mt.npx.seed(7, s=7)


def test_array_from_a_scalar_keeps_its_shape():
    for v in (3.0, 2, True, onp.float32(1.5), onp.array(-3.0, "f"),
              onp.array(4, "int64")):
        for ns in ("np", "nd"):
            want = getattr(jmx, ns).array(v)
            with mt.cpu():
                got = getattr(mt, ns).array(v)
            assert got.shape == want.shape == (), (ns, v)
            assert str(got.dtype) == str(want.dtype), (ns, v)
            assert got.asnumpy() == want.asnumpy()
