"""Evaluation metrics (counterpart of mxnet_tpu/gluon/metric.py).

Every metric sums on the host in numpy, as the JAX package's do: labels
and predictions (NDArrays, tensors on any device, numpy arrays) are
copied to numpy first, bf16 as float32, since numpy has no bfloat16.
``create`` takes a metric, a callable (a :class:`CustomMetric`), a list
(a :class:`CompositeEvalMetric`) or a registered name, case-insensitive,
with the JAX package's aliases (``acc``, ``ce``, ``top_k_acc``,
``torch``).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..ndarray.ndarray import NDArray


class _Registry:
    """Name -> metric class, case-insensitive (base.py:_Registry)."""

    def __init__(self):
        self._reg = {}

    def register(self, obj, name=None):
        self._reg[(name or obj.__name__).lower()] = obj
        return obj

    def create(self, name, *args, **kwargs):
        key = name.lower()
        if key not in self._reg:
            raise KeyError(f"metric '{name}' is not registered. "
                           f"Known: {sorted(self._reg)}")
        return self._reg[key](*args, **kwargs)


_REG = _Registry()

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "Fbeta",
           "BinaryAccuracy", "MCC", "PCC", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Perplexity", "PearsonCorrelation",
           "MeanCosineSimilarity", "MeanPairwiseDistance", "Loss",
           "Torch", "CompositeEvalMetric", "CustomMetric", "create", "np"]


def _fbeta_score(tp, fp, fn, beta):
    """Shared F-score kernel: F1 is the beta=1 case."""
    prec = tp / max(tp + fp, 1e-12)
    rec = tp / max(tp + fn, 1e-12)
    b2 = beta ** 2
    return (1 + b2) * prec * rec / max(b2 * prec + rec, 1e-12)


def _to_np(x):
    """A numpy copy on the host; bf16 as float32."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, *args, **kwargs))
        return out
    return _REG.create(metric, *args, **kwargs)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _register(klass):
    _REG.register(klass)
    return klass


@_register
class Accuracy(EvalMetric):
    def __init__(self, axis=-1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred)
            if pred.ndim > 1 and pred.shape != label.shape:
                # class-probability rows argmax to labels whenever the
                # shapes differ — labels may arrive 2-D from custom
                # iterators (reference Accuracy.update, test_metric.py:71)
                pred = pred.argmax(self.axis)
            pred = pred.astype(_np.int64).reshape(-1)
            label = label.astype(_np.int64).reshape(-1)
            if len(pred) != len(label):
                # reference check_label_shapes: loud, never broadcast
                raise ValueError(
                    f"Accuracy: {len(pred)} predictions vs "
                    f"{len(label)} labels")
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@_register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label).astype(_np.int64)
            pred = _to_np(pred)
            topk = _np.argsort(-pred, axis=-1)[..., : self.top_k]
            hit = (topk == label[..., None]).any(axis=-1)
            self.sum_metric += float(hit.sum())
            self.num_inst += hit.size


@_register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.threshold = threshold
        self.reset_stats()

    _beta = 1.0  # Fbeta overrides; one macro/micro get() serves both

    def reset_stats(self):
        self._tp = self._fp = self._fn = 0.0
        self._batch_counts = []  # per-update (tp, fp, fn) for 'macro'

    def reset(self):
        super().reset()
        if hasattr(self, "_tp"):
            self.reset_stats()

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        up_tp = up_fp = up_fn = 0.0
        for label, pred in zip(labels, preds):
            label = _to_np(label).reshape(-1).astype(_np.int64)
            pred = _to_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1).reshape(-1)
            else:
                pred = (pred.reshape(-1) > self.threshold).astype(_np.int64)
            up_tp += float(((pred == 1) & (label == 1)).sum())
            up_fp += float(((pred == 1) & (label == 0)).sum())
            up_fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)
        self._tp += up_tp
        self._fp += up_fp
        self._fn += up_fn
        if self.average == "macro":
            # macro: mean of per-UPDATE F scores (reference 'macro'
            # averages across batches; 'micro' pools the counts)
            self._batch_counts.append((up_tp, up_fp, up_fn))

    def get(self):
        if not self.num_inst:
            return self.name, float("nan")
        if self.average == "macro" and self._batch_counts:
            return self.name, float(_np.mean(
                [_fbeta_score(tp, fp, fn, self._beta)
                 for tp, fp, fn in self._batch_counts]))
        return self.name, _fbeta_score(self._tp, self._fp, self._fn,
                                       self._beta)


@_register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self._tp = self._tn = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._tn = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label).reshape(-1).astype(_np.int64)
            pred = _to_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1).reshape(-1)
            else:
                pred = (pred.reshape(-1) > 0.5).astype(_np.int64)
            self._tp += float(((pred == 1) & (label == 1)).sum())
            self._tn += float(((pred == 0) & (label == 0)).sum())
            self._fp += float(((pred == 1) & (label == 0)).sum())
            self._fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)

    def get(self):
        tp, tn, fp, fn = self._tp, self._tn, self._fp, self._fn
        denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
        mcc = (tp * tn - fp * fn) / denom if denom else 0.0
        return self.name, mcc if self.num_inst else float("nan")


@_register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred).reshape(label.shape)
            self.sum_metric += float(_np.abs(label - pred).mean()) * len(label)
            self.num_inst += len(label)


@_register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred).reshape(label.shape)
            self.sum_metric += float(((label - pred) ** 2).mean()) * len(label)
            self.num_inst += len(label)


@_register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        name, value = super().get()
        return name, value ** 0.5 if value == value else value


@_register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label).reshape(-1).astype(_np.int64)
            pred = _to_np(pred)
            prob = pred[_np.arange(len(label)), label]
            self.sum_metric += float(-_np.log(prob + self.eps).sum())
            self.num_inst += len(label)


@_register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, name="perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(_np.exp(self.sum_metric / self.num_inst))


@_register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels = []
        self._preds = []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            self._labels.append(_to_np(label).reshape(-1))
            self._preds.append(_to_np(pred).reshape(-1))
            self.num_inst += len(self._labels[-1])

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        x = _np.concatenate(self._labels)
        y = _np.concatenate(self._preds)
        return self.name, float(_np.corrcoef(x, y)[0, 1])


@_register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for pred in preds:
            p = _to_np(pred)
            self.sum_metric += float(p.sum())
            self.num_inst += p.size


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):  # noqa: ARG002
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            out = self._feval(_to_np(label), _to_np(pred))
            if isinstance(out, tuple):
                s, n = out
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += out
                self.num_inst += 1


np = _np  # parity: reference metric module exposes numpy as .np
_REG.register(Accuracy, "acc")
_REG.register(CrossEntropy, "ce")
_REG.register(TopKAccuracy, "top_k_acc")


@_register
class Fbeta(F1):
    """Fbeta = (1+β²)·precision·recall / (β²·precision + recall)
    (reference: metric.py:816)."""

    def __init__(self, name="fbeta", beta=1.0, **kwargs):
        super().__init__(name, **kwargs)
        self.beta = beta
        self._beta = beta  # F1.get() computes macro/micro with this


@_register
class BinaryAccuracy(EvalMetric):
    """Elementwise accuracy of binary/multilabel predictions against a
    decision threshold (reference: metric.py:877)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label).reshape(-1)
            pred = (_to_np(pred).reshape(-1) > self.threshold)
            hit = (pred == (label > 0.5))
            self.sum_metric += float(hit.sum())
            self.num_inst += hit.size


@_register
class MeanCosineSimilarity(EvalMetric):
    """Mean per-sample cosine similarity along the last axis
    (reference: metric.py:1260)."""

    def __init__(self, name="cos_sim", eps=1e-8, **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred)
            if label.ndim == 1:
                label, pred = label[None], pred[None]
            num = (label * pred).sum(-1)
            den = (_np.linalg.norm(label, axis=-1)
                   * _np.linalg.norm(pred, axis=-1))
            sim = num / _np.maximum(den, self.eps)
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@_register
class MeanPairwiseDistance(EvalMetric):
    """Mean per-sample L_p distance along the last axis
    (reference: metric.py:1199)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        super().__init__(name, **kwargs)
        self.p = p

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred)
            if label.ndim == 1:
                label, pred = label[None], pred[None]
            dist = (_np.abs(pred - label) ** self.p).sum(-1) ** (1 / self.p)
            self.sum_metric += float(dist.sum())
            self.num_inst += dist.size


@_register
class PCC(EvalMetric):
    """Multiclass Pearson correlation from a running confusion matrix —
    the discrete MCC generalization (reference: metric.py:1595). Equals
    MCC for binary problems."""

    def __init__(self, name="pcc", **kwargs):
        self._cm = _np.zeros((0, 0), dtype=_np.float64)
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._cm = _np.zeros((0, 0), dtype=_np.float64)

    def _grow(self, k):
        if k > self._cm.shape[0]:
            cm = _np.zeros((k, k), dtype=_np.float64)
            n = self._cm.shape[0]
            cm[:n, :n] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label).reshape(-1).astype(_np.int64)
            pred = _to_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1).reshape(-1).astype(_np.int64)
            else:
                # 1-D probabilities: threshold like F1/MCC so binary
                # PCC == MCC holds for sigmoid outputs too
                pred = (pred.reshape(-1) > 0.5).astype(_np.int64)
            k = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            self._grow(k)
            _np.add.at(self._cm, (pred, label), 1)
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        c = self._cm
        n = c.sum()
        x = c.sum(axis=1)  # predicted counts
        y = c.sum(axis=0)  # true counts
        cov_xy = n * _np.trace(c) - (x * y).sum()
        cov_xx = n * n - (x * x).sum()
        cov_yy = n * n - (y * y).sum()
        den = _np.sqrt(cov_xx * cov_yy)
        return self.name, float(cov_xy / den) if den else float("nan")


Torch = Loss  # reference keeps the legacy Torch criterion name as Loss
_REG.register(Loss, "torch")
