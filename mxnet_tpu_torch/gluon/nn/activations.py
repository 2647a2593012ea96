"""Activation layers (counterpart of mxnet_tpu/gluon/nn/activations.py):
LeakyReLU, PReLU (its ``alpha`` Parameter), ELU, SELU, GELU (erf or tanh),
Swish and SiLU, over ops/nn.py's ``leaky_relu`` and ``activation``."""
from __future__ import annotations

import torch

from ... import initializer
from ...ops import nn as _nn
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "SiLU", "GELU"]


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _nn.leaky_relu(x, act_type="leaky", slope=self._alpha)

    def extra_repr(self):
        return str(self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learnt slope per channel of axis 1 (``alpha``,
    ``in_channels`` of them, 0.25 unless ``alpha_initializer``)."""

    def __init__(self, alpha_initializer=None, in_channels=1):
        super().__init__()
        self.alpha = Parameter(
            "alpha", shape=(in_channels,),
            init=alpha_initializer or initializer.Constant(0.25))

    def forward(self, x):
        return _nn.leaky_relu(x, self.alpha._tensor(), act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _nn.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return _nn.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """``approximation='erf'`` (exact) or anything else for tanh."""

    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation

    def forward(self, x):
        return _nn.activation(
            x, "gelu" if self._approx == "erf" else "gelu_tanh")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``; silu at ``beta`` 1."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        if self._beta == 1.0:
            return _nn.activation(x, "silu")
        return x * torch.sigmoid(x * self._beta)


SiLU = Swish
