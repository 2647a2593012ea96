"""``gluon.metric`` of the port against the JAX package on the CPU.

Every metric is fed the same seeded batches in both packages, the JAX
package as its NDArrays, the port as tensors (one batch as an NDArray, one
as numpy) over several ``update`` calls; ``get()`` names agree and values
within 1e-12 (both sum in float64 numpy on the host). ``create`` by name,
alias, list and callable; a bfloat16 tensor arrives as float32.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

jmetric, tmetric = jmx.gluon.metric, mt.gluon.metric


def _same(tm, jm, label):
    (tn, tv), (jn, jv) = tm.get(), jm.get()
    assert tn == jn, label
    tv, jv = (tv if isinstance(tv, list) else [tv]), \
        (jv if isinstance(jv, list) else [jv])
    for a, b in zip(tv, jv):
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), label
        else:
            assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (label, a, b)


def _feed(tm, jm, batches):
    for k, (labels, preds) in enumerate(batches):
        jm.update(jmx.np.array(labels), jmx.np.array(preds))
        if k % 3 == 0:
            tl, tp = torch.from_numpy(labels), torch.from_numpy(preds)
        elif k % 3 == 1:
            tl, tp = labels, preds
        else:
            with mt.cpu():
                tl, tp = mt.np.array(labels), mt.np.array(preds)
        tm.update(tl, tp)


def _batches(kind, seed, n=4):
    r = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "class":
            p = r.uniform(size=(8, 5)).astype("f")
            out.append((r.randint(0, 5, 8).astype("f"),
                        p / p.sum(axis=1, keepdims=True)))
        elif kind == "binary":
            out.append((r.randint(0, 2, 10).astype("f"),
                        r.uniform(size=10).astype("f")))
        elif kind == "binary2":
            p = r.uniform(size=(10, 2)).astype("f")
            out.append((r.randint(0, 2, 10).astype("f"), p))
        else:
            out.append((r.standard_normal((6, 3)).astype("f"),
                        r.standard_normal((6, 3)).astype("f")))
    return out


CASES = [
    ("Accuracy", {}, "class"), ("TopKAccuracy", {"top_k": 3}, "class"),
    ("F1", {}, "binary"), ("F1", {"average": "micro"}, "binary2"),
    ("Fbeta", {"beta": 2.0}, "binary"), ("MCC", {}, "binary2"),
    ("MAE", {}, "real"), ("MSE", {}, "real"), ("RMSE", {}, "real"),
    ("CrossEntropy", {}, "class"), ("Perplexity", {}, "class"),
    ("PearsonCorrelation", {}, "real"), ("PCC", {}, "binary2"),
    ("PCC", {}, "class"), ("BinaryAccuracy", {"threshold": 0.4}, "binary"),
    ("MeanCosineSimilarity", {}, "real"),
    ("MeanPairwiseDistance", {"p": 3}, "real"),
]


@pytest.mark.parametrize("chunk", [0, 1])
def test_every_metric(chunk):
    """Each metric over four batches (empty first: nan in both), then
    ``reset`` and one batch again."""
    for name, kw, kind in CASES[chunk::2]:
        tm, jm = getattr(tmetric, name)(**kw), getattr(jmetric, name)(**kw)
        _same(tm, jm, f"{name} empty")
        batches = _batches(kind, hash(name) % 1000)
        _feed(tm, jm, batches)
        _same(tm, jm, name)
        tm.reset(), jm.reset()
        _feed(tm, jm, batches[:1])
        _same(tm, jm, f"{name} after reset")
        assert str(tm) == str(jm)


def test_loss_composite_custom_and_create():
    """Loss (the mean of what it is given), CompositeEvalMetric,
    CustomMetric with a sum-and-count and a plain feval, and ``create`` by
    name, alias (acc, ce, top_k_acc, torch), list and callable."""
    batches = _batches("class", 5)
    for name in ("acc", "Accuracy", "ce", "top_k_acc", "torch", "loss",
                 "mae", "pearsoncorrelation"):
        kind = "real" if name in ("mae", "pearsoncorrelation") else "class"
        b = _batches(kind, 6)
        tm, jm = tmetric.create(name), jmetric.create(name)
        assert type(tm).__name__ == type(jm).__name__, name
        _feed(tm, jm, b)
        _same(tm, jm, f"create({name})")
    tm = tmetric.create(["acc", "top_k_acc", tmetric.CrossEntropy()])
    jm = jmetric.create(["acc", "top_k_acc", jmetric.CrossEntropy()])
    _feed(tm, jm, batches)
    _same(tm, jm, "composite")
    assert [n for n, _ in tm.get_name_value()] == \
        [n for n, _ in jm.get_name_value()]

    def feval(label, pred):
        return float((pred.argmax(-1) == label).sum()), len(label)

    def feval1(label, pred):
        return float(onp.abs(pred).mean())

    for fn in (feval, feval1):
        tm, jm = tmetric.create(fn), jmetric.create(fn)
        _feed(tm, jm, batches)
        _same(tm, jm, f"custom {fn.__name__}")
    with pytest.raises(KeyError):
        tmetric.create("no_such_metric")


def test_bf16_and_card_tensors_reach_numpy():
    """A bfloat16 prediction is read as float32 (numpy has no bfloat16),
    and equals the JAX package's float32 result on the same values."""
    labels, preds = _batches("real", 7, 1)[0]
    bf = torch.from_numpy(preds).to(torch.bfloat16)
    tm, jm = tmetric.MSE(), jmetric.MSE()
    tm.update(torch.from_numpy(labels), bf)
    jm.update(jmx.np.array(labels), jmx.np.array(bf.float().numpy()))
    _same(tm, jm, "bf16 MSE")
    assert tmetric._to_np(bf).dtype == onp.float32
    with pytest.raises(ValueError):
        tmetric.Accuracy().update(torch.zeros(3), torch.zeros(4))
