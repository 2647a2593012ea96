"""Inception v3 (counterpart of
mxnet_tpu/gluon/model_zoo/vision/inception.py): NCHW, 299x299 inputs,
BatchNorm epsilon 0.001, branches concatenated on the channel axis."""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from .resnet import _no_pretrained

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel, stride=1, pad=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel, stride, pad, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Concur(HybridBlock):
    """Runs the branches on one input and concatenates on channels."""

    def __init__(self, *branches):
        super().__init__()
        for b in branches:
            self.register_child(b)

    def forward(self, x):
        return torch.cat([b(x) for b in self._modules.values()], dim=1)


def _branch(*stages):
    return nn.HybridSequential(*stages)


def _make_A(pool_features):
    return _Concur(
        _branch(_conv(64, 1)),
        _branch(_conv(48, 1), _conv(64, 5, pad=2)),
        _branch(_conv(64, 1), _conv(96, 3, pad=1), _conv(96, 3, pad=1)),
        _branch(nn.AvgPool2D(3, 1, 1), _conv(pool_features, 1)),
    )


def _make_B():
    return _Concur(
        _branch(_conv(384, 3, 2)),
        _branch(_conv(64, 1), _conv(96, 3, pad=1), _conv(96, 3, 2)),
        _branch(nn.MaxPool2D(3, 2)),
    )


def _make_C(channels_7x7):
    c = channels_7x7
    return _Concur(
        _branch(_conv(192, 1)),
        _branch(_conv(c, 1), _conv(c, (1, 7), pad=(0, 3)),
                _conv(192, (7, 1), pad=(3, 0))),
        _branch(_conv(c, 1), _conv(c, (7, 1), pad=(3, 0)),
                _conv(c, (1, 7), pad=(0, 3)), _conv(c, (7, 1), pad=(3, 0)),
                _conv(192, (1, 7), pad=(0, 3))),
        _branch(nn.AvgPool2D(3, 1, 1), _conv(192, 1)),
    )


def _make_D():
    return _Concur(
        _branch(_conv(192, 1), _conv(320, 3, 2)),
        _branch(_conv(192, 1), _conv(192, (1, 7), pad=(0, 3)),
                _conv(192, (7, 1), pad=(3, 0)), _conv(192, 3, 2)),
        _branch(nn.MaxPool2D(3, 2)),
    )


def _make_E():
    return _Concur(
        _branch(_conv(320, 1)),
        _branch(_conv(384, 1),
                _Concur(_branch(_conv(384, (1, 3), pad=(0, 1))),
                        _branch(_conv(384, (3, 1), pad=(1, 0))))),
        _branch(_conv(448, 1), _conv(384, 3, pad=1),
                _Concur(_branch(_conv(384, (1, 3), pad=(0, 1))),
                        _branch(_conv(384, (3, 1), pad=(1, 0))))),
        _branch(nn.AvgPool2D(3, 1, 1), _conv(192, 1)),
    )


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):  # noqa: ARG002
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_conv(32, 3, 2))
        self.features.add(_conv(32, 3))
        self.features.add(_conv(64, 3, pad=1))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(_conv(80, 1))
        self.features.add(_conv(192, 3))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    kwargs.pop("ctx", None)
    kwargs.pop("root", None)
    return Inception3(**kwargs)
