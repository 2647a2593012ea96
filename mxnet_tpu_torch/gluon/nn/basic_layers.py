"""Basic layers (counterpart of mxnet_tpu/gluon/nn/basic_layers.py).

The containers (Sequential, HybridSequential, Concatenate,
HybridConcatenate, Identity, Lambda, HybridLambda), Dense, Dropout,
Embedding, the norms (LayerNorm, BatchNorm, BatchNormReLU, SyncBatchNorm,
GroupNorm, InstanceNorm), Flatten and Activation, with the JAX package's
parameter names and child naming (``layers.0``, ``layers.1`` ...), so
``collect_params()`` keys match across the two packages. Unknown input
dims (``in_units=0``, ``in_channels=0``) are inferred on the first
forward.
"""
from __future__ import annotations

import math

import torch

from ... import autograd as _ag
from ...ndarray.ndarray import NDArray
from ...ops import nn as _nn
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "LayerNorm",
           "Embedding", "BatchNorm", "BatchNormReLU", "SyncBatchNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Activation", "Identity",
           "Lambda", "HybridLambda", "Concatenate", "HybridConcatenate"]


class _SequentialMixin:
    """Children named "0", "1", ... run in turn; the first takes the extra
    arguments."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x

    def __getitem__(self, key):
        children = list(self._modules.values())
        if isinstance(key, slice):
            return type(self)(*children[key])
        return children[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_SequentialMixin, Block):
    """Sequential container (basic_layers.py:25)."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)


class HybridSequential(_SequentialMixin, HybridBlock):
    """Sequential container that can be the serving boundary."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)


class Dense(HybridBlock):
    """Fully connected layer; weight (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter("weight", shape=(units, in_units),
                                dtype=dtype, init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = (
            Parameter("bias", shape=(units,), dtype=dtype,
                      init=bias_initializer, allow_deferred_init=True)
            if use_bias else None)

    def forward(self, x):
        if self.weight._is_deferred:
            in_units = (math.prod(x.shape[1:]) if self._flatten
                        else x.shape[-1])
            self.weight._finish_deferred_init((self._units, in_units))
        if self.bias is not None and self.bias._is_deferred:
            self.bias._finish_deferred_init((self._units,))
        out = _nn.fully_connected(
            x, self.weight._tensor(),
            self.bias._tensor() if self.bias is not None else None,
            flatten=self._flatten)
        if self._activation is not None:
            out = _nn.activation(out, self._activation)
        return out

    def extra_repr(self):
        return f"{self._units}, in_units={self.weight.shape[1]}"


class Dropout(HybridBlock):
    """Inverted dropout, active only in train mode. ``generator`` is the
    ``torch.Generator`` the mask is drawn from, on the input's device: the
    one given here, else the one the net's ``initialize(generator=...)``
    derives (before either: the device's default generator)."""

    def __init__(self, rate, axes=(), generator=None):
        super().__init__()
        self._rate = rate
        self._axes = axes
        self.generator = generator

    def _set_generators(self, cpu_generator, device_generator):
        if self.generator is None:
            self.generator = device_generator

    def _noise_generators(self):
        # a TrainStep capture registers it with the graph: every replay
        # then advances it and draws a new mask
        return [self.generator] if self._rate > 0 and \
            self.generator is not None else []

    def forward(self, x):
        if self._rate <= 0:
            return x
        return _nn.dropout(x, p=self._rate, training=_ag.is_training(),
                           axes=self._axes or None, generator=self.generator)

    def extra_repr(self):
        return f"p={self._rate}, axes={self._axes}"


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis``; parameters gamma and beta."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32"):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer, dtype=dtype,
                               allow_deferred_init=True,
                               differentiable=scale)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer, dtype=dtype,
                              allow_deferred_init=True,
                              differentiable=center)

    def forward(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            if p._is_deferred:
                p._finish_deferred_init((c,))
        return _nn.layer_norm(x, self.gamma._tensor(), self.beta._tensor(),
                              axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Embedding lookup; weight (input_dim, output_dim).

    ``sparse_grad=True``: the gradient buffer stays dense, but a recorded
    forward keeps the ids it looked up on the weight, so the Trainer hands
    the optimizer a RowSparseNDArray of those rows and a ``lazy_update``
    writes only them (basic_layers.py:330)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        self.weight = Parameter(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer,
            grad_stype="row_sparse" if sparse_grad else "default")

    def forward(self, x):
        if self._sparse_grad:
            self.weight._record_sparse_rows(x)
        return _nn.embedding(x, self.weight._tensor())

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics (basic_layers.py:151).

    In train mode (``autograd.record()`` or ``train_mode()``, and not
    ``use_global_stats``) the batch statistics normalize, through
    kernels/norm.py:bn_train (K1/K2 on the card), and the running stats are
    updated in place, without gradient, as
    ``running * momentum + batch * (1 - momentum)`` with the biased batch
    variance. Otherwise the running stats normalize. The running stats are
    ``grad_req='null'`` Parameters: no Trainer updates them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):  # noqa: ARG002
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        sh = (in_channels,)
        self.gamma = Parameter("gamma", shape=sh, init=gamma_initializer,
                               allow_deferred_init=True,
                               differentiable=scale)
        self.beta = Parameter("beta", shape=sh, init=beta_initializer,
                              allow_deferred_init=True,
                              differentiable=center)
        self.running_mean = Parameter("running_mean", shape=sh,
                                      init=running_mean_initializer,
                                      grad_req="null", differentiable=False,
                                      allow_deferred_init=True)
        self.running_var = Parameter("running_var", shape=sh,
                                     init=running_variance_initializer,
                                     grad_req="null", differentiable=False,
                                     allow_deferred_init=True)

    def forward(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            if p._is_deferred:
                p._finish_deferred_init((c,))
        gamma = self.gamma._tensor()
        if not self._scale:
            gamma = torch.ones_like(gamma)
        rmean, rvar = self.running_mean._tensor(), self.running_var._tensor()
        training = _ag.is_training() and not self._use_global_stats
        out, new_mean, new_var = _nn.batch_norm(
            x, gamma, self.beta._tensor(), rmean, rvar, eps=self._epsilon,
            momentum=self._momentum, training=training,
            use_global_stats=self._use_global_stats, axis=self._axis)
        if training:
            with torch.no_grad():
                rmean.copy_(new_mean)
                rvar.copy_(new_var)
        return out

    def extra_repr(self):
        return (f"axis={self._axis}, momentum={self._momentum}, "
                f"in_channels={self.gamma.shape[0]}")


class BatchNormReLU(BatchNorm):
    """BatchNorm followed by ReLU (basic_layers.py:227)."""

    def forward(self, x):
        return torch.relu(super().forward(x))


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (basic_layers.py:237): on one device it is
    BatchNorm, as in the JAX package, and takes K1/K2 on the card."""

    def __init__(self, in_channels=0, num_devices=None,
                 **kwargs):  # noqa: ARG002
        super().__init__(in_channels=in_channels, **kwargs)


class GroupNorm(HybridBlock):
    """Group normalization over axis 1 (basic_layers.py:277)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer,
                               allow_deferred_init=True,
                               differentiable=scale)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer, allow_deferred_init=True,
                              differentiable=center)

    def _affine(self, x):
        for p in (self.gamma, self.beta):
            if p._is_deferred:
                p._finish_deferred_init((x.shape[1],))
        return self.gamma._tensor(), self.beta._tensor()

    def forward(self, x):
        gamma, beta = self._affine(x)
        return _nn.group_norm(x, gamma, beta, num_groups=self._num_groups,
                              eps=self._epsilon)


class InstanceNorm(GroupNorm):
    """Instance normalization: a group a channel (basic_layers.py:306)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):  # noqa: ARG002 - axis 1, as the reference
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)

    def forward(self, x):
        gamma, beta = self._affine(x)
        return _nn.instance_norm(x, gamma, beta, eps=self._epsilon)


class Flatten(HybridBlock):
    """Flatten to (N, -1) (basic_layers.py:362)."""

    def forward(self, x):
        return _nn.flatten(x)


class Activation(HybridBlock):
    """An activation by name: relu, sigmoid, tanh, gelu ...
    (basic_layers.py:445)."""

    def __init__(self, activation):
        super().__init__()
        self._act = activation

    def forward(self, x):
        return _nn.activation(x, self._act)

    def extra_repr(self):
        return self._act


class Identity(HybridBlock):
    """Returns its input (basic_layers.py:372)."""

    def forward(self, x):
        return x


def _resolve_lambda(function):
    """A callable, or the name of an operator of ``mx.npx``, ``mx.np`` or
    ``mx.nd``, searched in that order (basic_layers.py:377)."""
    if not isinstance(function, str):
        if not callable(function):
            raise ValueError("Lambda expects a callable or an operator name "
                             f"string, got {type(function)}")
        return function
    from ... import ndarray as _nd
    from ... import numpy as _mnp
    from ... import numpy_extension as _npx

    for ns in (_npx, _mnp, _nd):
        fn = getattr(ns, function, None)
        if callable(fn):
            return fn
    raise ValueError(f"no operator named {function!r} in npx/np/nd")


def _tensors(out):
    """An operator's NDArray results as the tensors the layers pass on."""
    if isinstance(out, NDArray):
        return out._data
    if isinstance(out, (tuple, list)):
        return type(out)(_tensors(o) for o in out)
    return out


class _LambdaMixin:
    def __init__(self, function):
        super().__init__()
        self._func = _resolve_lambda(function)

    def forward(self, *args):
        return _tensors(self._func(*args))


class Lambda(_LambdaMixin, Block):
    """A function, or an operator's name, as a layer (basic_layers.py:397)."""


class HybridLambda(_LambdaMixin, HybridBlock):
    """:class:`Lambda` that can be the serving boundary
    (basic_layers.py:409)."""


class _ConcatenateMixin:
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self._axis)


class Concatenate(_ConcatenateMixin, Sequential):
    """Runs every child on the input and concatenates their outputs along
    ``axis`` (basic_layers.py:418)."""


class HybridConcatenate(_ConcatenateMixin, HybridSequential):
    """:class:`Concatenate` that can be the serving boundary
    (basic_layers.py:433)."""
