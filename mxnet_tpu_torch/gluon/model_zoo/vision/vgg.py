"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
mxnet_tpu/gluon/model_zoo/vision/vgg.py), NCHW."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from .resnet import _no_pretrained

__all__ = ["VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn"]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):  # noqa: ARG002
        super().__init__()
        self.features = nn.HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                self.features.add(nn.Conv2D(filters[i], 3, padding=1,
                                            use_bias=not batch_norm))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(2, 2))
        self.features.add(
            nn.Flatten(),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5),
        )
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, batch_norm=False, **kwargs):
    _no_pretrained(pretrained)
    kwargs.pop("ctx", None)
    kwargs.pop("root", None)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, batch_norm=batch_norm, **kwargs)


def vgg11(**kw):
    return get_vgg(11, **kw)


def vgg13(**kw):
    return get_vgg(13, **kw)


def vgg16(**kw):
    return get_vgg(16, **kw)


def vgg19(**kw):
    return get_vgg(19, **kw)


def vgg11_bn(**kw):
    return get_vgg(11, batch_norm=True, **kw)


def vgg13_bn(**kw):
    return get_vgg(13, batch_norm=True, **kw)


def vgg16_bn(**kw):
    return get_vgg(16, batch_norm=True, **kw)


def vgg19_bn(**kw):
    return get_vgg(19, batch_norm=True, **kw)
