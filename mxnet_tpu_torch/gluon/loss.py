"""Loss layers (counterpart of mxnet_tpu/gluon/loss.py): ``Loss``,
``L2Loss`` and ``SoftmaxCrossEntropyLoss``.

Each returns the per-sample loss vector, the mean over every axis but the
batch axis. There is no mean over the batch: ``Trainer.step(batch_size)``
divides the gradients by the batch size, and ``autograd.backward`` gives a
vector head ones as its head gradient.
"""
from __future__ import annotations

import torch

from ..ops import nn as _nn
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _reduce(x, weight, sample_weight, batch_axis):
    """Apply ``sample_weight`` and the scalar ``weight``, then average over
    every axis except ``batch_axis`` (loss.py:_reduce)."""
    if sample_weight is not None:
        x = x * sample_weight
    if weight is not None:
        x = x * weight
    axes = tuple(i for i in range(x.dim()) if i != batch_axis % x.dim())
    return x.mean(dim=axes) if axes else x


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    """``0.5 * (pred - label)^2`` (loss.py:L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred) / 2.0
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy (loss.py:SoftmaxCrossEntropyLoss).

    ``sparse_label=True`` takes class indices, else one-hot rows or
    probabilities; ``from_logits=True`` takes ``pred`` as log-probabilities
    already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis
        logp = pred if self._from_logits else _nn.log_softmax(pred, axis=axis)
        if self._sparse:
            ax = axis % logp.dim()
            lshape = logp.shape[:ax] + logp.shape[ax + 1:]
            idx = label.long().reshape(lshape).unsqueeze(ax)
            loss = -torch.take_along_dim(logp, idx, dim=ax).squeeze(ax)
        else:
            loss = -(logp * label.reshape(logp.shape)).sum(dim=axis)
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
