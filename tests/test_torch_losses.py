"""The loss layers of the port against the JAX package on the CPU: the 13
classes from ``L1Loss`` to ``SDMLLoss`` and the ``SigmoidBCELoss`` alias,
with ``weight``, ``sample_weight`` and ``batch_axis``.

Each case feeds the same seeded numpy inputs to both packages' block under
``autograd.record()`` and backward of ``sum(loss * ct)``: the per-sample
loss and the gradient of every float input agree within 1e-5 relative,
plus 1e-5 of the tensor's largest value (f32). ``CTCLoss`` (optax in the
JAX package, ``F.ctc_loss`` here) is held in both layouts, with and
without lengths, labels padded with -1 and their lengths inferred from the
first padding value.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

TOL = 1e-5


def _close(got, want, msg):
    want = onp.asarray(want, "f")
    onp.testing.assert_allclose(onp.asarray(got, "f"), want, rtol=TOL,
                                atol=TOL * max(onp.abs(want).max(), 1e-30),
                                err_msg=msg)


def _run(name, ctor, args, kwargs=None, grads=(0,)):
    """``name(**ctor)`` of both packages on ``args`` (numpy arrays; int
    arrays stay ints) and ``kwargs``; compares the loss and the gradients
    of ``args[i]`` for i in ``grads``."""
    kwargs = kwargs or {}
    jl, tl = getattr(jmx.gluon.loss, name)(**ctor), \
        getattr(mt.gluon.loss, name)(**ctor)
    ja = [jmx.np.array(a, dtype=a.dtype) for a in args]
    jk = {k: jmx.np.array(v, dtype=v.dtype) for k, v in kwargs.items()}
    ta = [torch.from_numpy(a.copy()) for a in args]
    tk = {k: torch.from_numpy(v.copy()) for k, v in kwargs.items()}
    for i in grads:
        ja[i].attach_grad()
        ta[i].requires_grad_()
    with jmx.autograd.record():
        jout = jl(*ja, **jk)
        ct = onp.random.RandomState(99).uniform(
            0.5, 1.5, jout.shape).astype("f")
        (jout * jmx.np.array(ct)).sum().backward()
    with mt.autograd.record():
        tout = tl(*ta, **tk)
        (tout * torch.from_numpy(ct)).sum().backward()
    label = f"{name}({ctor}, {sorted(kwargs)})"
    assert tuple(tout.shape) == tuple(jout.shape), label
    _close(tout.detach().numpy(), jout.asnumpy(), label)
    for i in grads:
        _close(ta[i].grad.numpy(), ja[i].grad.asnumpy(), f"{label} grad {i}")


def _r(seed):
    return onp.random.RandomState(seed)


def _f(r, *shape, lo=None, hi=None):
    if lo is not None:
        return r.uniform(lo, hi, shape).astype("f")
    return r.standard_normal(shape).astype("f")


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_regression_and_margin_losses(batch_axis):
    """L1, L2, Huber, Hinge, SquaredHinge, Logistic (signed and binary
    labels) and PoissonNLL (log-rates, rates, with the Stirling term),
    each without and with ``weight`` and ``sample_weight``, reduced over
    every axis but ``batch_axis``; gradients of pred and label."""
    r = _r(batch_axis)
    pred, label = _f(r, 4, 5, 3), _f(r, 4, 5, 3)
    signs = onp.sign(_f(r, 4, 5, 3)).astype("f")
    bits = (signs > 0).astype("f")
    sw = _f(r, 4, 5, 1, lo=0.2, hi=2.0)
    rates, counts = _f(r, 4, 5, 3, lo=0.2, hi=3.0), \
        r.randint(0, 5, (4, 5, 3)).astype("f")
    cases = [("L1Loss", {}, (pred, label)),
             ("L2Loss", {}, (pred, label)),
             ("HuberLoss", {"rho": 0.7}, (pred, label)),
             ("HingeLoss", {"margin": 0.5}, (pred, signs)),
             ("SquaredHingeLoss", {}, (pred, signs)),
             ("LogisticLoss", {}, (pred, signs)),
             ("LogisticLoss", {"label_format": "binary"}, (pred, bits)),
             ("PoissonNLLLoss", {}, (pred, counts)),
             ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
              (rates, counts))]
    for name, ctor, args in cases:
        ctor = dict(ctor, batch_axis=batch_axis)
        _run(name, ctor, args, grads=(0, 1))
        _run(name, dict(ctor, weight=0.7), args, {"sample_weight": sw},
             grads=(0, 1))


def test_sigmoid_bce_and_alias():
    """SigmoidBinaryCrossEntropyLoss over logits and over probabilities,
    with ``pos_weight`` and ``sample_weight``; ``SigmoidBCELoss`` is the
    same class."""
    assert mt.gluon.loss.SigmoidBCELoss is \
        mt.gluon.loss.SigmoidBinaryCrossEntropyLoss
    r = _r(2)
    logits, probs = _f(r, 6, 4) * 3, _f(r, 6, 4, lo=0.05, hi=0.95)
    label = (r.uniform(size=(6, 4)) > 0.5).astype("f")
    pw, sw = _f(r, 4, lo=0.5, hi=3.0), _f(r, 6, 1, lo=0.2, hi=2.0)
    for ctor, x in (({}, logits), ({"from_sigmoid": True}, probs)):
        _run("SigmoidBCELoss", ctor, (x, label))
        _run("SigmoidBCELoss", dict(ctor, weight=2.0), (x, label),
             {"sample_weight": sw, "pos_weight": pw})


def test_kl_div_and_softmax_cross_entropy():
    """KLDivLoss from log-probabilities and from logits, along the last
    axis and along axis 1; SoftmaxCrossEntropyLoss with sparse and dense
    labels and a weight."""
    r = _r(3)
    x, y = _f(r, 4, 6, 3), _f(r, 4, 6, 3)
    logp = (x - onp.log(onp.exp(x).sum(axis=-1, keepdims=True))).astype("f")
    p = (onp.exp(y) / onp.exp(y).sum(axis=1, keepdims=True)).astype("f")
    for ctor, pred in (({}, logp), ({"from_logits": False, "axis": 1}, x)):
        _run("KLDivLoss", ctor, (pred, p))
        _run("KLDivLoss", dict(ctor, weight=0.5), (pred, p),
             {"sample_weight": _f(r, 4, 1, 1, lo=0.5, hi=2)})
    logits = _f(r, 5, 7)
    _run("SoftmaxCrossEntropyLoss", {"weight": 1.5},
         (logits, r.randint(0, 7, (5,)).astype("int32")))
    dense = onp.eye(7, dtype="f")[r.randint(0, 7, 5)]
    _run("SoftmaxCrossEntropyLoss", {"sparse_label": False},
         (logits, dense), {"sample_weight": _f(r, 5, lo=0.5, hi=2)})


def test_triplet_and_cosine_embedding():
    """TripletLoss (gradients of anchor, positive and negative) and
    CosineEmbeddingLoss with labels 1 and -1 and a margin."""
    r = _r(4)
    a, pos, neg = _f(r, 5, 3, 2), _f(r, 5, 3, 2), _f(r, 5, 3, 2)
    _run("TripletLoss", {"margin": 0.3}, (a, pos, neg), grads=(0, 1, 2))
    _run("TripletLoss", {"weight": 2.0}, (a, pos, neg), grads=(0, 1, 2))
    x1, x2 = _f(r, 6, 4), _f(r, 6, 4)
    label = onp.array([1, -1, 1, -1, -1, 1], "f")
    _run("CosineEmbeddingLoss", {"margin": 0.1}, (x1, x2, label),
         grads=(0, 1))
    _run("CosineEmbeddingLoss", {"weight": 0.5}, (x1, x2, label),
         grads=(0, 1))


def test_sdml():
    """SDMLLoss over an aligned pair of batches, default and with its
    smoothing and weight; a one-row batch raises."""
    r = _r(5)
    x1, x2 = _f(r, 5, 4), _f(r, 5, 4)
    _run("SDMLLoss", {}, (x1, x2), grads=(0, 1))
    _run("SDMLLoss", {"smoothing_parameter": 0.1, "weight": 2.0}, (x1, x2),
         grads=(0, 1))
    with pytest.raises(ValueError, match="batch_size >= 2"):
        mt.gluon.loss.SDMLLoss()(torch.zeros(1, 4), torch.zeros(1, 4))


def _ctc_labels(r, n, lmax, classes):
    """Labels 1..classes-1 with no two equal neighbours (every alignment
    feasible), padded with -1 to ``lmax``."""
    out = onp.full((n, lmax), -1, "int32")
    for i, length in enumerate(r.randint(1, lmax + 1, n)):
        prev = 0
        for j in range(length):
            v = prev
            while v == prev:
                v = r.randint(1, classes)
            out[i, j] = prev = v
    return out


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_ctc(layout):
    """CTCLoss in ``layout`` with lengths inferred (labels cut at their
    first -1, every sequence all T steps) and given (``pred_lengths``,
    ``label_lengths``); a weight; the gradient of the logits."""
    r = _r(6)
    n, t, c = 3, 9, 5
    pred = _f(r, n, t, c)
    if layout == "TNC":
        pred = onp.ascontiguousarray(pred.transpose(1, 0, 2))
    label = _ctc_labels(r, n, 4, c)
    _run("CTCLoss", {"layout": layout}, (pred, label))
    lengths = {"pred_lengths": onp.array([9, 7, 8], "int32"),
               "label_lengths": onp.array([2, 3, 1], "int32")}
    _run("CTCLoss", {"layout": layout, "weight": 0.5}, (pred, label),
         lengths)
