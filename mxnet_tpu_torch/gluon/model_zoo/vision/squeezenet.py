"""SqueezeNet 1.0 and 1.1 (counterpart of
mxnet_tpu/gluon/model_zoo/vision/squeezenet.py), NCHW; each fire module
concatenates its two expansions on the channel axis."""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from .resnet import _no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels):
        super().__init__()
        self.squeeze = nn.Conv2D(squeeze_channels, 1, activation="relu")
        self.expand1 = nn.Conv2D(expand1x1_channels, 1, activation="relu")
        self.expand3 = nn.Conv2D(expand3x3_channels, 3, padding=1,
                                 activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1(x), self.expand3(x)], dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):  # noqa: ARG002
        super().__init__()
        assert version in ("1.0", "1.1")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=False))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=False))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=False))
            self.features.add(_Fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, 3, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=False))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=False))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=False))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(_Fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    kwargs.pop("ctx", None)
    kwargs.pop("root", None)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    kwargs.pop("ctx", None)
    kwargs.pop("root", None)
    return SqueezeNet("1.1", **kwargs)
