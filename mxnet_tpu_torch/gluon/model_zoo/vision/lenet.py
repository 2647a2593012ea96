"""LeNet-5 for MNIST, BASELINE config #1's model (counterpart of
mxnet_tpu/gluon/model_zoo/vision/lenet.py), with the same
``collect_params`` names: ``features.{0,2,5,6}`` and ``output``."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["LeNet", "lenet"]


class LeNet(HybridBlock):
    """Conv-pool twice, then three dense layers; NCHW 28x28 inputs."""

    def __init__(self, classes=10, **kwargs):  # noqa: ARG002
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(6, kernel_size=5, padding=2, activation="tanh"),
            nn.AvgPool2D(pool_size=2, strides=2),
            nn.Conv2D(16, kernel_size=5, activation="tanh"),
            nn.AvgPool2D(pool_size=2, strides=2),
            nn.Flatten(),
            nn.Dense(120, activation="tanh"),
            nn.Dense(84, activation="tanh"),
        )
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def lenet(classes=10, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("no pretrained weights bundled")
    return LeNet(classes=classes, **kwargs)
