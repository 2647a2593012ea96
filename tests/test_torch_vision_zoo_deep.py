"""VGG with BatchNorm and DenseNet of the port's vision zoo against the
JAX package on the CPU, narrow, through
``test_torch_vision_zoo.train_pair`` (its module docstring)."""
import pytest

from test_torch_vision_zoo import _batch, same_noise, train_pair


@pytest.fixture
def noise(monkeypatch):
    return same_noise(monkeypatch)


def test_vgg_bn_narrow_training(noise):
    """VGG's layout with BatchNorm and small filters (one convolution a
    stage, 4-16 channels) on 32x32 inputs, batch 8: its dense head of
    4096 units with both Dropout(0.5) layers."""
    x, y = _batch(8, 32, seed=4)
    train_pair(lambda p: p.gluon.model_zoo.vision.VGG(
        [1, 1, 1, 1, 1], [4, 8, 8, 16, 16], classes=10, batch_norm=True),
        x, y, reset=noise)


def test_densenet_narrow_training(noise):
    """A small DenseNet spec (8 initial features, growth 4, two layers a
    block, bottleneck 2) on 224x224 inputs, batch 4: the dense layers'
    concatenations, the transitions and the 7x7 average pool."""
    x, y = _batch(4, 224, seed=5)
    train_pair(lambda p: p.gluon.model_zoo.vision.DenseNet(
        8, 4, [2, 2, 2, 2], bn_size=2, classes=10), x, y, reset=noise)
