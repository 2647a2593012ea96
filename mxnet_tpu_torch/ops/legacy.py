"""The CamelCase v1 layer ops with the reference's call signatures
(counterpart of mxnet_tpu/ops/legacy.py).

``mx.nd.Convolution(data, weight, bias, kernel=(3, 3), num_filter=64,
...)`` and the rest accept the reference's attribute-style keywords and
forward to the plain tensor functions of ``ops/nn.py`` and
``ops/tensor.py``; keywords that only tuned the reference's backends
(``workspace``, ``cudnn_tune``, ...) are accepted and change nothing.
``BatchNorm`` in training reaches the K1/K2 kernels through
``nn.batch_norm``.
"""
from __future__ import annotations

import torch

from . import nn as _nn
from . import tensor as _tensor
from .registry import register_op

__all__ = []


@register_op("Convolution")
def Convolution(data, weight, bias=None, kernel=None, stride=None, pad=None,
                dilate=None, num_filter=None, num_group=1, no_bias=False,
                workspace=None, cudnn_tune=None, cudnn_off=None,
                layout=None):  # noqa: ARG001, N802
    """legacy.py:18; the layout keyword is accepted and not used, as
    there (NCHW family)."""
    nd = data.dim() - 2
    return _nn.conv(data, weight, None if no_bias else bias,
                    stride=stride or (1,) * nd, pad=pad or (0,) * nd,
                    dilate=dilate or (1,) * nd, groups=num_group)


@register_op("Deconvolution")
def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  pad=None, dilate=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True,
                  workspace=None, cudnn_tune=None, cudnn_off=None,
                  layout=None):  # noqa: ARG001, N802
    """legacy.py:32: ``no_bias`` defaults to True, ``adj`` is the output
    padding."""
    nd = data.dim() - 2
    return _nn.conv_transpose(
        data, weight, None if no_bias else bias, stride=stride or (1,) * nd,
        pad=pad or (0,) * nd, dilate=dilate or (1,) * nd,
        output_padding=adj or (0,) * nd, groups=num_group)


@register_op("FullyConnected")
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):  # noqa: N802
    return _nn.fully_connected(data, weight, bias, flatten=flatten,
                               num_hidden=num_hidden, no_bias=no_bias)


@register_op("Pooling")
def Pooling(data, kernel=(2, 2), pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, cudnn_off=None, p_value=None,
            layout=None):  # noqa: ARG001, N802
    """legacy.py:54: ``pooling_convention``, ``p_value`` and ``layout``
    are accepted and not used, as there."""
    return _nn.pool(data, kernel, pool_type=pool_type, stride=stride,
                    pad=pad, global_pool=global_pool,
                    count_include_pad=count_include_pad)


@register_op("BatchNorm")
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=None,
              min_calib_range=None, max_calib_range=None):  # noqa: ARG001, N802
    """legacy.py:62. ``fix_gamma`` (the default) replaces gamma by ones;
    the batch statistics normalize whenever ``use_global_stats`` is false,
    recording or not (through K1/K2 for CUDA tensors). The moving
    statistics are never written: the result is ``out``, or ``(out,
    new_mean, new_var)`` with ``output_mean_var``."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    out, new_mean, new_var = _nn.batch_norm(
        data, gamma, beta, moving_mean, moving_var, eps=eps,
        momentum=momentum, training=not use_global_stats,
        use_global_stats=use_global_stats, axis=axis)
    if output_mean_var:
        return out, new_mean, new_var
    return out


@register_op("LayerNorm")
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5,
              output_mean_var=False):  # noqa: N802
    out = _nn.layer_norm(data, gamma, beta, axis=axis, eps=eps)
    if output_mean_var:
        mean = data.mean(dim=axis, keepdim=True)
        var = (data - mean).square().mean(dim=axis, keepdim=True)
        return out, mean, var
    return out


@register_op("InstanceNorm")
def InstanceNorm(data, gamma, beta, eps=1e-3):  # noqa: N802
    return _nn.instance_norm(data, gamma, beta, eps=eps)


@register_op("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance"):  # noqa: N802
    return _nn.l2_normalization(data, eps=eps, mode=mode)


@register_op("Activation")
def Activation(data, act_type="relu"):  # noqa: N802
    return _nn.activation(data, act_type)


@register_op("LeakyReLU")
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=None, upper_bound=None):  # noqa: ARG001, N802
    return _nn.leaky_relu(data, gamma, act_type=act_type, slope=slope)


@register_op("SoftmaxActivation")
def SoftmaxActivation(data, mode="instance"):  # noqa: N802
    """Softmax over the channels (``mode="channel"``) or the last axis."""
    return _nn.softmax(data, axis=1 if mode == "channel" else -1)


@register_op("Embedding")
def Embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):  # noqa: ARG001, N802
    """legacy.py:124: the shape hints and ``dtype`` are not used, as
    there."""
    return _nn.embedding(data, weight)


@register_op("Concat")
def Concat(*data, dim=1, num_args=None):  # noqa: ARG001, N802
    return _tensor.concat(*data, dim=dim)


@register_op("Flatten")
def Flatten(data):  # noqa: N802
    return _tensor.flatten(data)


@register_op("Reshape")
def Reshape(data, shape=None, reverse=False, target_shape=None,
            keep_highest=False):  # noqa: ARG001, N802
    return _tensor.reshape(data, shape=shape, reverse=reverse)


@register_op("Cast")
def Cast(data, dtype):  # noqa: N802
    return _tensor.cast(data, dtype)


@register_op("SwapAxis")
def SwapAxis(data, dim1=0, dim2=1):  # noqa: N802
    return _tensor.swapaxes(data, dim1, dim2)


@register_op("SequenceLast")
def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):  # noqa: N802
    return _nn.sequence_last(data, sequence_length, use_sequence_length,
                             axis)


@register_op("SequenceMask")
def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):  # noqa: N802
    return _nn.sequence_mask(data, sequence_length, use_sequence_length,
                             value, axis)


@register_op("SequenceReverse")
def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):  # noqa: N802
    return _nn.sequence_reverse(data, sequence_length, use_sequence_length,
                                axis)


@register_op("UpSampling")
def UpSampling(*data, scale=2, sample_type="nearest", num_args=None,
               num_filter=None, multi_input_mode=None,
               workspace=None):  # noqa: ARG001, N802
    return _nn.upsample(data[0], scale=scale, sample_type=sample_type)


@register_op("LRN")
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):  # noqa: N802
    return _nn.lrn(data, nsize=nsize, alpha=alpha, beta=beta, knorm=knorm)


@register_op("SliceChannel")
def SliceChannel(data, num_outputs, axis=1, squeeze_axis=False):  # noqa: N802
    return _tensor.split(data, num_outputs, axis=axis,
                         squeeze_axis=squeeze_axis)


@register_op("Pad")
def Pad(data, mode="constant", pad_width=None, constant_value=0.0):  # noqa: N802
    return _tensor.pad(data, mode=mode, pad_width=pad_width,
                       constant_value=constant_value)


@register_op("Dropout")
def Dropout(data, key=None, p=0.5, mode="training", axes=None,
            cudnn_off=None):  # noqa: ARG001, N802
    """The pure op (legacy.py:184): identity without a key; with one (a
    ``torch.Generator`` on data's device) inverted dropout. ``mx.nd`` and
    ``mx.npx`` hand-write the stateful ``Dropout`` that draws its own."""
    if key is None:
        return data
    return _nn.dropout(data, p=p, training=True, axes=axes, generator=key)


@register_op("IdentityAttachKLSparseReg")
def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9):  # noqa: ARG001, N802
    """Forward identity (identity_attach_KL_sparse_reg.cc)."""
    return data
