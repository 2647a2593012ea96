"""Convolution and pooling in the PyTorch port against the JAX package, on
the CPU: ``ops.nn.conv`` and ``ops.nn.pool`` in both layout families,
forward and gradient (``jax.vjp`` against torch autograd, with the same
head gradient), with stride, padding, dilation, groups and the ceil / same
conventions; ``SpaceToDepthStem`` against the plain 7x7/s2 convolution and
against the JAX package's stem; a deferred ``Conv2D``'s weight shape.
Inputs come from a numpy seed; f32 throughout, 1e-4 (1e-5 relative where
only one reduction order differs).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.ops import nn as jnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ops import nn as tnn

TOL = dict(atol=1e-4, rtol=1e-5)


def _check_fwd_and_grad(jfn, tfn, arrays, seed=0):
    """jfn(*jax arrays) and tfn(*torch tensors) agree, and so do their
    gradients for one random head gradient."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    want, vjp = jax.vjp(jfn, *jargs)
    got = tfn(*targs)
    assert tuple(got.shape) == want.shape
    onp.testing.assert_allclose(got.detach().numpy(), onp.asarray(want),
                                **TOL)
    head = onp.random.RandomState(seed).standard_normal(want.shape)
    head = head.astype("f")
    jgrads = vjp(jnp.asarray(head))
    got.backward(torch.from_numpy(head))
    for t, j in zip(targs, jgrads):
        onp.testing.assert_allclose(t.grad.numpy(), onp.asarray(j), **TOL)


# (layout, x shape, weight shape, stride, pad, dilate, groups, bias)
CONV_CASES = [
    ("NCHW", (2, 4, 9, 11), (6, 2, 3, 3), (2, 1), (1, 2), (1, 2), 2, True),
    ("NHWC", (2, 10, 9, 8), (12, 3, 3, 8), 1, 1, 1, 1, False),
    ("NHWC", (2, 12, 10, 6), (9, 3, 2, 2), (2, 3), (2, 0), 2, 3, True),
    ("NWC", (3, 17, 4), (5, 3, 4), 2, 1, 1, 1, True),
    ("NCDHW", (1, 2, 5, 6, 7), (4, 2, 3, 3, 2), 1, (1, 0, 1), 1, 1, True),
]


@pytest.mark.parametrize("layout,xs,ws,stride,pad,dilate,groups,bias",
                         CONV_CASES)
def test_conv_matches_reference(layout, xs, ws, stride, pad, dilate, groups,
                                bias):
    r = onp.random.RandomState(1)
    arrays = [r.standard_normal(xs).astype("f"),
              (r.standard_normal(ws) * 0.3).astype("f")]
    if bias:
        arrays.append(r.standard_normal(ws[0]).astype("f"))
    kw = dict(stride=stride, pad=pad, dilate=dilate, groups=groups,
              layout=layout)
    _check_fwd_and_grad(lambda *a: jnn.conv(*a, **kw),
                        lambda *a: tnn.conv(*a, **kw), arrays)


# {family: [(layout, x shape, pool kwargs), ...]}
POOL_CASES = {
    "channels_last": [
        ("NHWC", (2, 9, 11, 5), [
            dict(kernel=3, stride=2, pad=1),                    # ResNet's
            dict(kernel=(3, 2), pool_type="avg", stride=(2, 1), pad=(1, 0),
                 count_include_pad=False),
            dict(kernel=3, pool_type="avg", stride=2, pad=1, ceil_mode=True),
            dict(kernel=1, pool_type="avg", global_pool=True),
            dict(kernel=1, pool_type="max", global_pool=True)]),
        ("NWC", (3, 13, 4), [
            dict(kernel=3, pool_type="max", stride=2, pad=1, ceil_mode=True),
            dict(kernel=4, pool_type="avg", stride=2, pad=2,
                 count_include_pad=True),
            dict(kernel=2, pool_type="sum", stride=2)])],
    "channels_first": [
        ("NCHW", (2, 3, 10, 7), [
            dict(kernel=3, pool_type="max", stride=2, ceil_mode=True),
            dict(kernel=2, pool_type="sum", stride=2, pad=1),
            dict(kernel=3, pool_type="avg", stride=2,
                 pooling_convention="same", count_include_pad=False),
            dict(kernel=3, pool_type="lp", stride=1, pad=1),
            dict(kernel=2, pool_type="avg", stride=3,
                 pooling_convention="full")])],
}


@pytest.mark.parametrize("family", sorted(POOL_CASES))
def test_pool_matches_reference(family):
    """Max pooling's gradient goes to the window's maximum, which random
    inputs make unique; padding fills with -inf (max) or 0 (sums)."""
    for layout, xs, variants in POOL_CASES[family]:
        x = onp.random.RandomState(2).standard_normal(xs).astype("f")
        for kw in variants:
            kw = dict(kw, layout=layout)
            _check_fwd_and_grad(lambda a, kw=kw: jnn.pool(a, **kw),
                                lambda a, kw=kw: tnn.pool(a, **kw), [x])


def test_space_to_depth_stem_matches_7x7_conv_and_reference():
    """The s2d stem on the 7x7 weight equals the 7x7/s2/pad-3 convolution
    with that weight (the same sums, regrouped: 1e-4) and the JAX
    package's stem with the same weight."""
    r = onp.random.RandomState(3)
    x = r.standard_normal((2, 16, 12, 3)).astype("f")
    mx.seed(0)
    jstem = jresnet.SpaceToDepthStem(8)
    jstem.initialize()
    want = jstem(mx.np.array(x)).asnumpy()
    tstem = tresnet.SpaceToDepthStem(8)
    tstem.initialize(device=mt.cpu())
    load_jax_params(tstem, {"weight": jstem.weight.data().asnumpy()})
    got = tstem(torch.from_numpy(x))
    onp.testing.assert_allclose(got.numpy(), want, **TOL)
    direct = tnn.conv(torch.from_numpy(x), tstem.weight._tensor().detach(),
                      stride=2, pad=3, layout="NHWC")
    assert got.shape == direct.shape == (2, 8, 6, 8)
    onp.testing.assert_allclose(got.numpy(), direct.numpy(), **TOL)


def test_conv_layers_defer_in_channels_with_reference_shapes():
    """Conv2D with in_channels=0 takes its input channels at the first
    forward; the weight is (O, kh, kw, I/g) NHWC and (O, I/g, kh, kw)
    NCHW, as in the JAX package."""
    for layout, shape in (("NHWC", (1, 6, 6, 4)), ("NCHW", (1, 4, 6, 6))):
        mx.seed(0)
        jconv = mx.gluon.nn.Conv2D(6, (3, 2), groups=2, layout=layout)
        jconv.initialize()
        want = jconv(mx.np.ones(shape))
        tconv = mt.gluon.nn.Conv2D(6, (3, 2), groups=2, layout=layout)
        tconv.initialize(device=mt.cpu())
        assert tconv.weight.shape == jconv.weight.shape[:1] + (
            (0, 3, 2) if layout == "NCHW" else (3, 2, 0))
        load_jax_params(tconv, {k: p.data().asnumpy() for k, p in
                                jconv.collect_params().items()})
        got = tconv(torch.ones(shape))
        assert tconv.weight.shape == jconv.weight.shape
        onp.testing.assert_allclose(got.numpy(), want.asnumpy(), **TOL)
