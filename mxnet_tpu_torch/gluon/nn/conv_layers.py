"""Convolution, pooling, padding and pixel-shuffle layers (counterpart
of mxnet_tpu/gluon/nn/conv_layers.py).

Layouts: channels-first (NCW/NCHW/NCDHW, the default) and channels-last
(NWC/NHWC/NDHWC), with the JAX package's weight shapes, ``(O, I/g, *k)``
and ``(O, *k, I/g)`` (transposed: ``(I, O/g, *k)`` and ``(I, *k, O/g)``),
so checkpoints map 1:1. An unknown ``in_channels`` (0) is inferred on the
first forward. Deformable convolution (NCHW only) runs ops/vision.py's
bilinear gathers.
"""
from __future__ import annotations

import torch

from ...ops import nn as _nn
from ...ops import tensor as _tensor
from ...ops import vision as _vision
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "DeformableConvolution", "ModulatedDeformableConvolution"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """N-d convolution, or with ``transpose`` its transpose
    (conv_layers.py:29); weight and optional bias."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, use_bias, in_channels, activation,
                 weight_initializer, bias_initializer, ndim, layout,
                 transpose=False, output_padding=0):
        super().__init__()
        self._transpose = transpose
        self._output_padding = _tup(output_padding, ndim)
        self._channels = channels
        self._kernel = _tup(kernel_size, ndim)
        self._strides = _tup(strides, ndim)
        self._padding = _tup(padding, ndim)
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self._activation = activation
        self._layout = layout
        self._channels_last = layout[-1] == "C"
        self.weight = Parameter("weight",
                                shape=self._weight_shape(in_channels),
                                init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(channels,),
                               init=bias_initializer or "zeros")
                     if use_bias else None)

    def _weight_shape(self, in_channels):
        c_in = in_channels // self._groups if in_channels else 0
        if self._transpose:
            o = self._channels // self._groups
            if self._channels_last:
                return (in_channels,) + self._kernel + (o,)
            return (in_channels, o) + self._kernel
        if self._channels_last:
            return (self._channels,) + self._kernel + (c_in,)
        return (self._channels, c_in) + self._kernel

    def forward(self, x):
        if self.weight._is_deferred:
            c_in = x.shape[-1 if self._channels_last else 1]
            self.weight._finish_deferred_init(self._weight_shape(c_in))
        bias = self.bias._tensor() if self.bias is not None else None
        if self._transpose:
            out = _nn.conv_transpose(
                x, self.weight._tensor(), bias, stride=self._strides,
                pad=self._padding, dilate=self._dilation,
                output_padding=self._output_padding, groups=self._groups,
                layout=self._layout)
        else:
            out = _nn.conv(x, self.weight._tensor(), bias,
                           stride=self._strides, pad=self._padding,
                           dilate=self._dilation, groups=self._groups,
                           layout=self._layout)
        if self._activation:
            out = _nn.activation(out, self._activation)
        return out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}, layout={self._layout}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        assert layout in ("NCW", "NWC"), layout
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 1, layout)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        assert layout in ("NCHW", "NHWC"), layout
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 2, layout)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0):
        assert layout in ("NCDHW", "NDHWC"), layout
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 3, layout)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        assert layout in ("NCW", "NWC"), layout
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 1, layout,
                         transpose=True, output_padding=output_padding)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0):
        assert layout in ("NCHW", "NHWC"), layout
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 2, layout,
                         transpose=True, output_padding=output_padding)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        assert layout in ("NCDHW", "NDHWC"), layout
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 3, layout,
                         transpose=True, output_padding=output_padding)


class _Pool(HybridBlock):
    """Pooling (conv_layers.py:182); no parameters."""

    def __init__(self, pool_size, strides, padding, ndim, pool_type,
                 global_pool=False, count_include_pad=True, ceil_mode=False,
                 layout=None):
        super().__init__()
        self._kernel = _tup(pool_size, ndim)
        self._strides = _tup(strides if strides is not None else pool_size,
                             ndim)
        self._padding = _tup(padding, ndim)
        self._pool_type = pool_type
        self._global = global_pool
        self._count_include_pad = count_include_pad
        self._layout = layout
        self._ceil_mode = bool(ceil_mode)

    def forward(self, x):
        return _nn.pool(x, self._kernel, pool_type=self._pool_type,
                        stride=self._strides, pad=self._padding,
                        global_pool=self._global,
                        count_include_pad=self._count_include_pad,
                        layout=self._layout, ceil_mode=self._ceil_mode)

    def extra_repr(self):
        return (f"size={self._kernel}, stride={self._strides}, "
                f"padding={self._padding}, layout={self._layout}")


def _pool_class(name, ndim, pool_type, layouts, default_size):
    """A MaxPool / AvgPool class of ``ndim`` spatial dims."""

    def __init__(self, pool_size=default_size, strides=None, padding=0,
                 layout=layouts[0], ceil_mode=False, count_include_pad=True):
        assert layout in layouts, layout
        _Pool.__init__(self, pool_size, strides, padding, ndim, pool_type,
                       count_include_pad=count_include_pad,
                       ceil_mode=ceil_mode, layout=layout)

    return type(name, (_Pool,), {"__init__": __init__})


def _global_pool_class(name, ndim, pool_type, layouts):
    def __init__(self, layout=layouts[0]):
        assert layout in layouts, layout
        _Pool.__init__(self, 1, 1, 0, ndim, pool_type, global_pool=True,
                       layout=layout)

    return type(name, (_Pool,), {"__init__": __init__})


_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}

MaxPool1D = _pool_class("MaxPool1D", 1, "max", _LAYOUTS[1], 2)
MaxPool2D = _pool_class("MaxPool2D", 2, "max", _LAYOUTS[2], (2, 2))
MaxPool3D = _pool_class("MaxPool3D", 3, "max", _LAYOUTS[3], (2, 2, 2))
AvgPool1D = _pool_class("AvgPool1D", 1, "avg", _LAYOUTS[1], 2)
AvgPool2D = _pool_class("AvgPool2D", 2, "avg", _LAYOUTS[2], (2, 2))
AvgPool3D = _pool_class("AvgPool3D", 3, "avg", _LAYOUTS[3], (2, 2, 2))
GlobalMaxPool1D = _global_pool_class("GlobalMaxPool1D", 1, "max",
                                     _LAYOUTS[1])
GlobalMaxPool2D = _global_pool_class("GlobalMaxPool2D", 2, "max",
                                     _LAYOUTS[2])
GlobalMaxPool3D = _global_pool_class("GlobalMaxPool3D", 3, "max",
                                     _LAYOUTS[3])
GlobalAvgPool1D = _global_pool_class("GlobalAvgPool1D", 1, "avg",
                                     _LAYOUTS[1])
GlobalAvgPool2D = _global_pool_class("GlobalAvgPool2D", 2, "avg",
                                     _LAYOUTS[2])
GlobalAvgPool3D = _global_pool_class("GlobalAvgPool3D", 3, "avg",
                                     _LAYOUTS[3])


class ReflectionPad2D(HybridBlock):
    """Reflects the last two dims of an NCHW tensor by ``padding``
    (conv_layers.py:303)."""

    def __init__(self, padding=0):
        super().__init__()
        self._padding = _tup(padding, 2)

    def forward(self, x):
        ph, pw = self._padding
        return _tensor.pad(x, "reflect", (0, 0, 0, 0, ph, ph, pw, pw))


class _PixelShuffle(HybridBlock):
    """(N, C * prod(f), *spatial) -> (N, C, *(spatial * f)): the channel
    axis splits into (C, f1, ..., fn) and each factor moves behind its
    spatial dim (conv_layers.py:319-387)."""

    _ndim = 1

    def __init__(self, factor):
        super().__init__()
        self._factor = _tup(factor, self._ndim)

    def forward(self, x):
        nd = self._ndim
        n, cf = x.shape[:2]
        spatial = tuple(x.shape[2:])
        c = cf // torch.Size(self._factor).numel()
        v = x.reshape((n, c) + self._factor + spatial)
        # (n, c, f1..fn, s1..sn) -> (n, c, s1, f1, ..., sn, fn)
        perm = [0, 1] + [p for i in range(nd) for p in (2 + nd + i, 2 + i)]
        return v.permute(perm).reshape(
            (n, c) + tuple(s * f for s, f in zip(spatial, self._factor)))

    def extra_repr(self):
        return str(self._factor)


class PixelShuffle1D(_PixelShuffle):
    _ndim = 1


class PixelShuffle2D(_PixelShuffle):
    _ndim = 2


class PixelShuffle3D(_PixelShuffle):
    _ndim = 3


class DeformableConvolution(HybridBlock):
    """DCNv1 (conv_layers.py:388): an ``offset_conv`` Conv2D gives each
    output position's offsets, then ops/vision.py:deformable_convolution
    samples and contracts. NCHW only."""

    _use_mask = False

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True):
        super().__init__()
        assert layout == "NCHW", "deformable conv is NCHW-only"
        self._channels = channels
        self._kernel = _tup(kernel_size, 2)
        self._strides = _tup(strides, 2)
        self._padding = _tup(padding, 2)
        self._dilation = _tup(dilation, 2)
        self._groups = groups
        self._ndg = num_deformable_group
        self._activation = activation
        kh, kw = self._kernel
        mult = 3 if self._use_mask else 2
        self.offset_conv = Conv2D(
            mult * num_deformable_group * kh * kw, self._kernel,
            self._strides, self._padding, self._dilation,
            use_bias=offset_use_bias, in_channels=in_channels,
            weight_initializer=offset_weight_initializer,
            bias_initializer=offset_bias_initializer)
        self.weight = Parameter(
            "weight",
            shape=(channels, in_channels // groups if in_channels else 0,
                   kh, kw),
            init=weight_initializer, allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(channels,),
                               init=bias_initializer)
                     if use_bias else None)

    def forward(self, x):
        kh, kw = self._kernel
        if self.weight._is_deferred:
            self.weight._finish_deferred_init(
                (self._channels, x.shape[1] // self._groups, kh, kw))
        offs = self.offset_conv(x)
        mask = None
        if self._use_mask:
            n_off = 2 * self._ndg * kh * kw
            offs, mask = offs[:, :n_off], torch.sigmoid(offs[:, n_off:])
        out = _vision.deformable_convolution(
            x, offs, self.weight._tensor(),
            bias=self.bias._tensor() if self.bias is not None else None,
            kernel=self._kernel, stride=self._strides, pad=self._padding,
            dilate=self._dilation, num_deformable_group=self._ndg,
            groups=self._groups, mask=mask)
        if self._activation:
            out = _nn.activation(out, self._activation)
        return out


class ModulatedDeformableConvolution(DeformableConvolution):
    """DCNv2 (conv_layers.py:470): offsets and sigmoid masks from one
    ``offset_conv``."""

    _use_mask = True
