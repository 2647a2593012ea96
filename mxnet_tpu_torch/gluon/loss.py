"""Loss layers (counterpart of mxnet_tpu/gluon/loss.py): the JAX
package's 16 classes and its aliases ``SoftmaxCELoss`` and
``SigmoidBCELoss``.

Each returns the per-sample loss vector, the mean over every axis but the
batch axis. There is no mean over the batch: ``Trainer.step(batch_size)``
divides the gradients by the batch size, and ``autograd.backward`` gives a
vector head ones as its head gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import nn as _nn
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss",
           "PoissonNLLLoss", "CTCLoss", "SDMLLoss"]


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


class L1Loss(Loss):
    """``|pred - label|`` (loss.py:54)."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of logits, or of probabilities with
    ``from_sigmoid`` (loss.py:SigmoidBinaryCrossEntropyLoss); ``pos_weight``
    weighs the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        p, y = pred, label.reshape(pred.shape)
        if not self._from_sigmoid:
            soft = torch.log1p(torch.exp(-torch.abs(p)))
            if pos_weight is None:
                loss = torch.clamp_min(p, 0) - p * y + soft
            else:
                log_weight = 1 + (pos_weight - 1) * y
                loss = p - p * y + log_weight * (soft + torch.clamp_min(-p, 0))
        else:
            eps = 1e-12
            pos = y * torch.log(p + eps)
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + (1 - y) * torch.log(1 - p + eps))
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log label - log pred)``, averaged over ``axis``;
    ``from_logits=False`` takes the log-softmax of ``pred`` first
    (loss.py:KLDivLoss)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits else torch.log_softmax(
            pred, dim=self._axis)
        loss = (label * (torch.log(label + 1e-12) - logp)).mean(dim=self._axis)
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


class HuberLoss(Loss):
    """Smooth L1 with threshold ``rho`` (loss.py:HuberLoss)."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        rho = self._rho
        d = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(d > rho, d - 0.5 * rho, 0.5 / rho * d * d)
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` (loss.py:HingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def _hinge(self, pred, label):
        return torch.clamp_min(self._margin - pred * label.reshape(
            pred.shape), 0.0)

    def forward(self, pred, label, sample_weight=None):
        return _reduce(self._hinge(pred, label), self._weight, sample_weight,
                       self._batch_axis)


class SquaredHingeLoss(HingeLoss):
    """The hinge squared (loss.py:SquaredHingeLoss)."""

    def forward(self, pred, label, sample_weight=None):
        return _reduce(torch.square(self._hinge(pred, label)), self._weight,
                       sample_weight, self._batch_axis)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` with labels in {-1, 1}
    (``label_format='signed'``) or {0, 1} (``'binary'``)
    (loss.py:LogisticLoss)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        self._fmt = label_format

    def forward(self, pred, label, sample_weight=None):
        y = label.reshape(pred.shape)
        if self._fmt == "binary":
            y = 2 * y - 1
        loss = torch.log1p(torch.exp(-pred * y))
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


class TripletLoss(Loss):
    """``max(0, |pred - positive|^2 - |pred - negative|^2 + margin)``
    summed over all but axis 0 (loss.py:TripletLoss); ``sample_weight`` is
    ignored, as there."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative,
                sample_weight=None):  # noqa: ARG002
        axes = tuple(range(1, pred.dim()))
        loss = (torch.square(pred - positive)
                - torch.square(pred - negative)).sum(dim=axes) + self._margin
        return _reduce(torch.clamp_min(loss, 0.0), self._weight, None,
                       self._batch_axis)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``max(0, cos - margin)`` otherwise, the
    cosine over the last axis (loss.py:CosineEmbeddingLoss)."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label,
                sample_weight=None):  # noqa: ARG002
        cos = (input1 * input2).sum(-1) / (
            torch.linalg.vector_norm(input1, dim=-1)
            * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
        y = label.reshape(cos.shape)
        loss = torch.where(y == 1, 1 - cos,
                           torch.clamp_min(cos - self._margin, 0.0))
        return _reduce(loss, self._weight, None, self._batch_axis)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of ``pred`` (a log-rate with
    ``from_logits``, else a rate); ``compute_full`` adds the Stirling term
    where the target exceeds 1 (loss.py:PoissonNLLLoss)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        t = label.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - t * pred
        else:
            loss = pred - t * torch.log(pred + epsilon)
        if self._full:
            stirling = (t * torch.log(t + epsilon) - t
                        + 0.5 * torch.log(2 * math.pi * (t + epsilon)))
            loss = loss + torch.where(t > 1, stirling,
                                      torch.zeros_like(stirling))
        return _reduce(loss, self._weight, sample_weight, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification loss of unnormalized
    ``pred`` (``layout`` NTC or TNC) against ``label`` (N, L), one value a
    sequence (loss.py:300). Labels are padded with ``padding_value``;
    without ``label_lengths`` a label ends at its first padding value;
    without ``pred_lengths`` every sequence takes all T steps. The JAX
    package computes it through optax (XLA); here
    ``torch.nn.functional.ctc_loss`` on the log-softmax, in f32, cast back
    to ``pred``'s dtype."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 padding_value=-1, blank_id=0):
        super().__init__(weight, 0)
        assert layout in ("NTC", "TNC")
        self._layout = layout
        self._label_layout = label_layout
        self._padding_value = padding_value
        self._blank_id = blank_id

    def forward(self, pred, label, pred_lengths=None, label_lengths=None):
        logp = torch.log_softmax(pred.float(), dim=-1)
        if self._layout == "NTC":
            logp = logp.transpose(0, 1)           # (T, N, C)
        t, n = logp.shape[:2]
        in_len = (torch.full((n,), t, dtype=torch.long, device=pred.device)
                  if pred_lengths is None else pred_lengths.long())
        lt = label.shape[1]
        if label_lengths is None:
            is_pad = label == self._padding_value
            label_lengths = torch.where(is_pad.any(dim=1),
                                        is_pad.int().argmax(dim=1),
                                        torch.full_like(is_pad[:, 0], lt,
                                                        dtype=torch.int32))
        lab_len = label_lengths.long()
        keep = (torch.arange(lt, device=label.device)[None, :]
                < lab_len[:, None])
        targets = torch.where(keep, label.long(),
                              torch.full_like(label, self._blank_id,
                                              dtype=torch.long))
        loss = F.ctc_loss(logp, targets, in_len, lab_len,
                          blank=self._blank_id, reduction="none")
        loss = loss.to(pred.dtype)
        if self._weight is not None:
            loss = loss * self._weight
        return loss


class SDMLLoss(Loss):
    """Batchwise smoothed deep metric learning loss (loss.py:345): the
    squared distances of every ``x1`` row to every ``x2`` row, their
    negatives' log-softmax against a label-smoothed identity, the KL mean
    over each row. Needs at least 2 rows."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._smooth = smoothing_parameter

    def forward(self, x1, x2):
        if x1.shape[0] < 2:
            raise ValueError(
                "SDMLLoss needs batch_size >= 2 (off-diagonal rows are "
                "the negatives; a 1-row batch has none and the label "
                "smoothing divides by n-1)")
        n, smooth = x1.shape[0], self._smooth
        d = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(dim=2)
        logp = torch.log_softmax(-d, dim=1)
        eye = torch.eye(n, dtype=x1.dtype, device=x1.device)
        labels = eye * (1 - smooth) + (1 - eye) * smooth / (n - 1)
        kl = labels * (torch.log(torch.clamp_min(labels, 1e-12)) - logp)
        loss = kl.mean(dim=1)
        if self._weight is not None:
            loss = loss * self._weight
        return loss
