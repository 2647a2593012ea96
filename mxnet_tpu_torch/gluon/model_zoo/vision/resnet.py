"""ResNet v1/v2 (counterpart of
mxnet_tpu/gluon/model_zoo/vision/resnet.py).

Basic and bottleneck blocks, 18/34/50/101/152 layers, in the default NCHW
layout or ``layout="NHWC"``, whose convolutions reach cuDNN as
channels_last views with no transposes. ``stem_s2d=True`` computes the
7x7/s2 stem as a 4x4/s1 convolution over a 2x2 space-to-depth repacking of
the input, on the 7x7 weight. Parameter names and shapes are the JAX
package's, so ``convert.load_jax_params`` carries a checkpoint across.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import nn
from ....ops import nn as _nn
from ...block import HybridBlock
from ...parameter import Parameter

__all__ = ["SpaceToDepthStem", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "ResNetV1", "ResNetV2",
           "get_resnet", "resnet18_v1", "resnet34_v1", "resnet50_v1",
           "resnet101_v1", "resnet152_v1", "resnet18_v2", "resnet34_v2",
           "resnet50_v2", "resnet101_v2", "resnet152_v2"]


def _bn(layout, **kw):
    return nn.BatchNorm(axis=1 if layout[1] == "C" else -1, **kw)


class SpaceToDepthStem(HybridBlock):
    """The 7x7/s2 ResNet stem as a 4x4/s1 convolution over the input
    repacked 2x2 space-to-depth (resnet.py:21).

    Writing tap k-3 = 2m + a splits each 7-tap dimension into the s2d phase
    a and the offset m: the input (N, H, W, C) becomes (N, H/2, W/2, 4C),
    the weight, padded with one leading zero tap per spatial dim, becomes
    (O, 4, 4, 4C), and the padding becomes (2, 1) on each side. The
    parameter keeps the (O, 7, 7, C) shape. Channels-last layouts and even
    input sizes only."""

    def __init__(self, channels, in_channels=3, layout="NHWC"):
        super().__init__()
        if layout[-1] != "C":
            raise ValueError("SpaceToDepthStem requires a channels-last "
                             f"layout (got {layout!r})")
        self._channels = channels
        self.weight = Parameter("weight",
                                shape=(channels, 7, 7, in_channels),
                                allow_deferred_init=True)

    def forward(self, x):
        if self.weight._is_deferred:
            self.weight._finish_deferred_init(
                (self._channels, 7, 7, x.shape[-1]))
        w = self.weight._tensor()
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
        n, h, wd, c = x.shape
        o = w.shape[0]
        xs = x.reshape(n, h // 2, 2, wd // 2, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, h // 2, wd // 2, 4 * c)
        wp = F.pad(w, (0, 0, 1, 0, 1, 0)).reshape(o, 4, 2, 4, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(o, 4, 4, 4 * c)
        # F.conv2d pads symmetrically only: the (2, 1) padding goes first
        xs = F.pad(xs, (0, 0, 2, 1, 2, 1))
        return _nn.conv(xs, wp, layout="NHWC")


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError("pretrained weights are not bundled; load a local "
                         "checkpoint with convert.load_jax_params")


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                                in_channels=in_channels, layout=layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                                in_channels=channels, layout=layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, 1, stride,
                                          use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None
        self.relu = nn.Activation("relu")

    def forward(self, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, 1, stride, use_bias=False,
                                layout=layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels // 4, 3, 1, 1, use_bias=False,
                                layout=layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 1, 1, use_bias=False,
                                layout=layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, 1, stride,
                                          use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None
        self.relu = nn.Activation("relu")

    def forward(self, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        self.bn1 = _bn(layout)
        self.conv1 = nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                               in_channels=in_channels, layout=layout)
        self.bn2 = _bn(layout)
        self.conv2 = nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                               in_channels=channels, layout=layout)
        self.relu = nn.Activation("relu")
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.relu(self.bn2(x))
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        self.bn1 = _bn(layout)
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False,
                               layout=layout)
        self.bn2 = _bn(layout)
        self.conv2 = nn.Conv2D(channels // 4, 3, stride, 1, use_bias=False,
                               layout=layout)
        self.bn3 = _bn(layout)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False, layout=layout)
        self.relu = nn.Activation("relu")
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.relu(self.bn2(x))
        x = self.conv2(x)
        x = self.relu(self.bn3(x))
        x = self.conv3(x)
        return x + residual


def _stem(features, channels, layout, thumbnail, stem_s2d):
    if thumbnail:
        features.add(nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                               layout=layout))
        return
    if stem_s2d:
        features.add(SpaceToDepthStem(channels, layout=layout))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False,
                               layout=layout))
    features.add(_bn(layout))
    features.add(nn.Activation("relu"))
    features.add(nn.MaxPool2D(3, 2, 1, layout=layout))


class _ResNet(HybridBlock):
    def _make_layer(self, block, layers, channels, stride, in_channels=0):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=self._layout))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=self._layout))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", stem_s2d=False):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self._layout = layout
        self.features = nn.HybridSequential()
        _stem(self.features, channels[0], layout, thumbnail, stem_s2d)
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i]))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])


class ResNetV2(_ResNet):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", stem_s2d=False):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self._layout = layout
        self.features = nn.HybridSequential()
        self.features.add(_bn(layout, scale=False, center=False))
        _stem(self.features, channels[0], layout, thumbnail, stem_s2d)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=in_channels))
            in_channels = channels[i + 1]
        self.features.add(_bn(layout))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])


_resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]
_net_versions = [ResNetV1, ResNetV2]


def get_resnet(version, num_layers, pretrained=False, device=None,
               **kwargs):  # noqa: ARG001 - device: see Block.initialize
    """ResNet v``version`` with ``num_layers`` layers (resnet.py:get_resnet).
    The net is built uninitialized: ``net.initialize(device=...)`` places
    it."""
    _no_pretrained(pretrained)
    kwargs.pop("ctx", None)
    kwargs.pop("root", None)
    block_type, layers, channels = _resnet_spec[num_layers]
    block_class = _block_versions[version - 1][block_type]
    return _net_versions[version - 1](block_class, layers, channels,
                                      **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
