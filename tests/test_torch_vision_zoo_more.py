"""MobileNet v1, SqueezeNet and AlexNet of the port's vision zoo against
the JAX package on the CPU, narrow or on small inputs, through
``test_torch_vision_zoo.train_pair`` (its module docstring: the weights
carried across, dropout masks and smooth activations shared, two
SGD-momentum steps with BatchNorm in training mode)."""
import pytest

import mxnet_tpu_torch as mt
from test_torch_vision_zoo import _batch, same_noise, train_pair


@pytest.fixture
def noise(monkeypatch):
    return same_noise(monkeypatch)


def test_mobilenet_narrow_training(noise):
    """MobileNet v1 at multiplier 0.25, batch 8 of 64x64: 27 BatchNorm
    sites, the depthwise and pointwise convolutions."""
    x, y = _batch(8, 64, seed=1)
    net = train_pair(lambda p: p.gluon.model_zoo.vision.MobileNet(
        0.25, classes=10), x, y, reset=noise)
    assert sum(isinstance(m, mt.gluon.nn.BatchNorm)
               for m in net.modules()) == 27


@pytest.mark.parametrize("version", ["1.0", "1.1"])
def test_squeezenet_training(noise, version):
    """SqueezeNet at full width on 64x64 inputs, batch 4: the fire
    modules' concatenations, Dropout(0.5) and the convolutional head."""
    x, y = _batch(4, 64, seed=2)
    train_pair(lambda p: p.gluon.model_zoo.vision.SqueezeNet(
        version, classes=10), x, y, reset=noise)


def test_alexnet_training(noise):
    """AlexNet at full width on 64x64 inputs, batch 4: both Dropout(0.5)
    layers and the 4096-wide dense layers."""
    x, y = _batch(4, 64, seed=3)
    train_pair(lambda p: p.gluon.model_zoo.vision.alexnet(classes=10), x, y,
               reset=noise)
