"""Inception v3 of the port's vision zoo against the JAX package on the
CPU, through ``test_torch_vision_zoo.train_pair`` (its module
docstring).

Max pooling has kinks too: where two values of a window lie within
rounding of each other, the two packages route the gradient to different
elements, and behind Inception's four max pools (93 000 windows a step
at this size) the stem's gradients then differ by 1 % of the largest
(measured). Both packages' max pools average here, beside the module
docstring's substitutes; max pooling itself is held in
``tests/test_torch_conv.py``.
"""
import pytest

from mxnet_tpu import numpy_extension as jnpx
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.ops import nn as tnn
from test_torch_vision_zoo import _batch, same_noise, train_pair


@pytest.fixture
def noise(monkeypatch):
    jpool, tpool = jnn.pool, tnn.pool

    def smooth(pool):
        def fn(x, kernel, pool_type="max", **kwargs):
            return pool(x, kernel, "avg" if pool_type == "max" else pool_type,
                        **kwargs)
        return fn

    monkeypatch.setattr(jnpx, "pooling", jnpx._op(smooth(jpool), 1))
    monkeypatch.setattr(tnn, "pool", smooth(tpool))
    return same_noise(monkeypatch)


def _inception_body(pkg):
    """Inception v3's feature stack at full width with its 8x8 average
    pool, which needs 299x299 inputs, replaced by a global one: a
    107x107 input leaves 2x2 at the last block, so every BatchNorm site
    normalises at least 32 values a channel at batch 8."""
    nn = pkg.gluon.nn
    full = pkg.gluon.model_zoo.vision.Inception3(classes=10)
    net = nn.HybridSequential()
    net.add(*list(full.features)[:-2])
    net.add(nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(10))
    return net


def test_inception_training(noise):
    """The A-E blocks' branches and concatenations, the asymmetric 1x7 and
    7x1 convolutions, BatchNorm epsilon 0.001, batch 8 of 107x107."""
    x, y = _batch(8, 107, seed=6)
    train_pair(_inception_body, x, y, reset=noise)
