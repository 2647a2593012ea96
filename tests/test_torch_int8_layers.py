"""QuantizedConv2D and QuantizedDense against the JAX package's on the CPU,
from the same fp32 weights (carried by ``convert.load_jax_params``) and the
same input: the int8 weights and per-channel scales identical; the
input's int8 codes identical (Q1's plain version); the int32 sums (Q2's
plain version) identical to ``lax.conv_general_dilated`` with
``preferred_element_type=int32`` over the reference's codes; the f32
outputs within 1e-6 relative to their largest value (the two rescale
with the same f32 operations: equal in six of the eight cases, within
3e-8 where the range is dynamic or the activation tanh). NHWC: the reference
reads x and the weight as NCHW/OIHW whatever the layout, so it raises or
computes another function; the port refuses it with NotImplementedError.
"""
import numpy as onp
import pytest

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.kernels import int8 as kint8
import torch


def _pair(make, x, seed):
    """The same layer in both packages, initialized by the JAX package (a
    forward on ``x`` settles deferred shapes) and carried to the port."""
    jmx.seed(seed)
    jl = make(jmx)
    jl.initialize()
    jl(jmx.np.array(x))
    with mt.cpu():
        tl = make(mt)
        tl.initialize(device=mt.cpu())
        tl(mt.np.array(x))
    load_jax_params(tl, {k: p.data().asnumpy()
                         for k, p in jl.collect_params().items()})
    return tl, jl


def _check_outputs(tq_layer, jq_layer, x):
    with mt.cpu():
        got = tq_layer(mt.np.array(x)).asnumpy()
    want = onp.asarray(jq_layer(jmx.np.array(x)).asnumpy())
    assert got.shape == want.shape and got.dtype == want.dtype
    onp.testing.assert_allclose(got, want, rtol=1e-6,
                                atol=1e-6 * onp.abs(want).max())
    return onp.abs(got - want).max()


def _check_weights(tq_layer, jq_layer):
    onp.testing.assert_array_equal(tq_layer._wq.numpy(), jq_layer._wq)
    onp.testing.assert_array_equal(tq_layer._wscale.numpy(),
                                   jq_layer._wscale)
    assert tq_layer._wq.dtype == torch.int8


def _input_codes(x, rng):
    """The reference's codes of x and its scale, and the port's."""
    if rng is None:
        lo, hi = jnp.min(x), jnp.max(x)
        xd = jnp.asarray(x)
        lohi = torch.tensor([x.min(), x.max()])
    else:
        lo, hi = jnp.float32(rng[0]), jnp.float32(rng[1])
        xd = jnp.clip(jnp.asarray(x), lo, hi)
        lohi = torch.tensor(rng, dtype=torch.float32)
    jcodes, jscale = jq._q(xd, lo, hi)
    tcodes, info = kint8.quantize(torch.from_numpy(x), lohi,
                                  clip=rng is not None)
    onp.testing.assert_array_equal(tcodes.numpy(), onp.asarray(jcodes))
    assert info[2].item() == float(jscale)
    return jcodes, tcodes, info


#: (in channels, channels, kernel, strides, padding, dilation, groups,
#:  bias, activation, calibrated range or None for dynamic)
_CONVS = {
    "plain_bias_calibrated": (3, 8, 3, 1, 1, 1, 1, True, None, (-0.9, 0.9)),
    "strided_dilated_relu_dynamic": (4, 6, 3, 2, 2, 2, 1, False, "relu",
                                     None),
    "groups2_tanh": (4, 6, 3, 1, 1, 1, 2, True, "tanh", (-1.2, 1.2)),
    "depthwise_relu": (4, 4, 3, 1, 1, 1, 4, True, "relu", (-0.5, 0.5)),
}


@pytest.mark.parametrize("case", sorted(_CONVS))
def test_quantized_conv2d_against_the_reference(case):
    cin, ch, k, s, p, d, g, bias, act, rng = _CONVS[case]
    x = onp.random.RandomState(1).uniform(-1, 1, (2, cin, 9, 9)).astype("f")

    def make(m):
        return m.gluon.nn.Conv2D(ch, k, strides=s, padding=p, dilation=d,
                                 groups=g, use_bias=bias, activation=act,
                                 in_channels=cin,
                                 bias_initializer="normal" if bias
                                 else "zeros")

    tl, jl = _pair(make, x, 3)
    tqz, jqz = tq.QuantizedConv2D(tl, rng), jq.QuantizedConv2D(jl, rng)
    _check_weights(tqz, jqz)
    jcodes, tcodes, _ = _input_codes(x, rng)
    want = jax.lax.conv_general_dilated(
        jcodes, jnp.asarray(jqz._wq), (s, s), [(p, p)] * 2,
        rhs_dilation=(d, d), dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=g, preferred_element_type=jnp.int32)
    got = kint8.conv(tcodes, tqz._wq, s, p, d, g)
    assert got.dtype == torch.int32
    onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))
    _check_outputs(tqz, jqz, x)


def test_quantized_dense_against_the_reference():
    """Flatten on (a 4-d input) and off (a 3-d input), with and without
    bias, relu, tanh or no activation, a calibrated or dynamic range."""
    rs = onp.random.RandomState(2)
    for flatten, shape, bias, act, rng in (
            (True, (3, 2, 4, 5), True, "relu", (-0.8, 0.8)),
            (True, (5, 7), False, None, None),
            (False, (2, 3, 6), True, "tanh", None),
            (False, (4, 6), True, None, (-2.0, 2.0))):
        x = rs.uniform(-1, 1, shape).astype("f")

        def make(m, flatten=flatten, bias=bias, act=act):
            return m.gluon.nn.Dense(9, activation=act, use_bias=bias,
                                    flatten=flatten,
                                    bias_initializer="normal")

        tl, jl = _pair(make, x, 4)
        tqz, jqz = tq.QuantizedDense(tl, rng), jq.QuantizedDense(jl, rng)
        _check_weights(tqz, jqz)
        xm = x.reshape(x.shape[0], -1) if flatten else x
        jcodes, tcodes, _ = _input_codes(xm, rng)
        want = jax.lax.dot_general(
            jcodes, jnp.asarray(jqz._wq).T,
            (((jcodes.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        kk = xm.shape[-1]
        got = kint8.conv(tcodes.reshape(-1, kk, 1, 1),
                         tqz._wq.view(9, kk, 1, 1)).reshape(want.shape)
        onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))
        _check_outputs(tqz, jqz, x)


def test_nhwc_conv_is_refused():
    """The reference computes an NHWC Conv2D as if it were NCHW: where the
    shapes disagree it raises, where they happen to agree its result is not
    the layer's. The port raises NotImplementedError at the swap."""
    rs = onp.random.RandomState(5)
    x = rs.uniform(-1, 1, (2, 6, 6, 3)).astype("f")

    def make(m):
        return m.gluon.nn.Conv2D(8, 3, padding=1, layout="NHWC",
                                 in_channels=3)

    tl, jl = _pair(make, x, 6)
    with pytest.raises(ValueError):
        jq.QuantizedConv2D(jl, (-1.0, 1.0))(jmx.np.array(x))
    with pytest.raises(NotImplementedError):
        tq.QuantizedConv2D(tl, (-1.0, 1.0))
    # shapes that agree by accident: 3 x 3 x 3 planes, 3 channels out
    x = rs.uniform(-1, 1, (2, 3, 3, 3)).astype("f")

    def make3(m):
        return m.gluon.nn.Conv2D(3, 3, padding=1, layout="NHWC",
                                 in_channels=3)

    tl, jl = _pair(make3, x, 7)
    fp32 = jl(jmx.np.array(x)).asnumpy()
    int8 = jq.QuantizedConv2D(jl, (-1.0, 1.0))(jmx.np.array(x)).asnumpy()
    assert onp.abs(int8 - fp32).max() > 0.1 * onp.abs(fp32).max()
    with pytest.raises(NotImplementedError):
        with mt.cpu():
            tq.quantize_net(mt.gluon.nn.HybridSequential().add(tl))
