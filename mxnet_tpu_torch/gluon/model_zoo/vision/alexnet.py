"""AlexNet (counterpart of mxnet_tpu/gluon/model_zoo/vision/alexnet.py),
NCHW."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from .resnet import _no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):  # noqa: ARG002
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(64, 11, 4, 2, activation="relu"),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 5, padding=2, activation="relu"),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(384, 3, padding=1, activation="relu"),
            nn.Conv2D(256, 3, padding=1, activation="relu"),
            nn.Conv2D(256, 3, padding=1, activation="relu"),
            nn.MaxPool2D(3, 2),
            nn.Flatten(),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5),
        )
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    kwargs.pop("ctx", None)
    kwargs.pop("root", None)
    return AlexNet(**kwargs)
