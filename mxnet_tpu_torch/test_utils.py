"""Test toolkit (counterpart of mxnet_tpu/test_utils.py): dtype-aware
``assert_almost_equal``, random arrays, finite-difference gradient
checks against autograd, the same function on several devices
(``check_consistency``: the CPU against the card), and the chi-square
harness of the random generators."""
from __future__ import annotations

import numpy as _np
import torch

from .device import cpu, current_device, gpu
from .ndarray.ndarray import NDArray

__all__ = ["assert_almost_equal", "almost_equal", "same", "rand_ndarray",
           "random_arrays", "check_numeric_gradient", "check_consistency",
           "default_device", "default_rtol_atol", "effective_dtype",
           "gen_buckets_probs_with_ppf", "chi_square_check",
           "verify_generator"]

_RTOL = {"float16": 1e-2, "bfloat16": 3e-2, "float32": 1e-4,
         "float64": 1e-6}
_ATOL = {"float16": 1e-3, "bfloat16": 1e-2, "float32": 1e-5,
         "float64": 1e-8}


def default_device():
    return current_device()


def _dtype_name(dtype):
    return "bfloat16" if dtype == torch.bfloat16 else _np.dtype(dtype).name


def effective_dtype(arr):
    return arr.dtype


def default_rtol_atol(*arrays):
    rtol = atol = 0.0
    for a in arrays:
        name = _dtype_name(a.dtype)
        rtol = max(rtol, _RTOL.get(name, 1e-4))
        atol = max(atol, _ATOL.get(name, 1e-5))
    return rtol, atol


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def same(a, b):
    return _np.array_equal(_as_np(a), _as_np(b))


def _tolerances(a, b, rtol, atol):
    """``rtol``/``atol``, or where None the looser default of the two
    operands' dtypes (an NDArray's own: bfloat16 stays bfloat16)."""
    arrays = [x if isinstance(x, NDArray) else _as_np(x) for x in (a, b)]
    d_rtol, d_atol = default_rtol_atol(*arrays)
    return (rtol if rtol is not None else d_rtol,
            atol if atol is not None else d_atol)


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    rtol, atol = _tolerances(a, b, rtol, atol)
    return _np.allclose(_as_np(a).astype(_np.float64),
                        _as_np(b).astype(_np.float64),
                        rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """``a`` and ``b`` (NDArrays or array-likes) within ``rtol``/``atol``,
    by default those of their dtypes (the looser of the two)."""
    rtol, atol = _tolerances(a, b, rtol, atol)
    a_np, b_np = _as_np(a), _as_np(b)
    if not _np.allclose(a_np.astype(_np.float64), b_np.astype(_np.float64),
                        rtol=rtol, atol=atol, equal_nan=equal_nan):
        diff = _np.abs(a_np.astype(_np.float64) - b_np.astype(_np.float64))
        rel = diff / (_np.abs(b_np.astype(_np.float64)) + 1e-12)
        raise AssertionError(
            f"{names[0]} != {names[1]} (rtol={rtol}, atol={atol}): "
            f"max abs diff {diff.max():.3e}, max rel diff {rel.max():.3e}\n"
            f"{names[0]}: {a_np.reshape(-1)[:8]}...\n"
            f"{names[1]}: {b_np.reshape(-1)[:8]}...")


def rand_ndarray(shape, dtype="float32", device=None, low=-1.0, high=1.0):
    """Uniform values in ``[low, high)`` from numpy's global generator, as
    an NDArray on ``device``."""
    from .numpy import array

    data = _np.random.uniform(low, high, size=shape)
    if dtype in ("bfloat16", torch.bfloat16):
        return array(data.astype(_np.float32), device=device).astype(
            torch.bfloat16)
    return array(data.astype(_np.dtype(dtype)), dtype=_np.dtype(dtype),
                 device=device)


def random_arrays(*shapes, dtype="float32"):
    out = [_np.random.uniform(-1, 1, s).astype(dtype) for s in shapes]
    return out[0] if len(out) == 1 else out


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3):
    """Autograd's gradients of ``fn(*inputs).sum()`` against central
    finite differences, input by input."""
    from . import autograd
    from .numpy import array

    inputs = [i if isinstance(i, NDArray) else array(i) for i in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        out = fn(*inputs)
        total = out.sum() if out.ndim > 0 else out
    total.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    for idx, x in enumerate(inputs):
        base = x.asnumpy().astype(_np.float64)
        numeric = _np.zeros_like(base)
        flat = base.reshape(-1)
        num_flat = numeric.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            vals = []
            for probe in (orig + eps, orig - eps):
                flat[i] = probe
                # dtype given: float64 probes keep their resolution
                xp = array(base, dtype=x.dtype, device=x.device)
                args = [inputs[j] if j != idx else xp
                        for j in range(len(inputs))]
                vals.append(float(fn(*args).sum().item()))
            flat[i] = orig
            num_flat[i] = (vals[0] - vals[1]) / (2 * eps)
        if not _np.allclose(analytic[idx], numeric, rtol=rtol, atol=atol):
            raise AssertionError(
                f"gradient mismatch on input {idx}: "
                f"analytic {analytic[idx].reshape(-1)[:5]} vs "
                f"numeric {num_flat[:5]}")


def check_consistency(fn, inputs, devices=None, rtol=None, atol=None):
    """``fn`` on each of ``devices`` (the CPU and card 0 by default), the
    results held against the first one's. Returns the first result."""
    from .numpy import array

    devices = devices or [cpu(0), gpu(0)]
    results = []
    for dev in devices:
        dev_inputs = [array(i, device=dev) if not isinstance(i, NDArray)
                      else i.as_in_ctx(dev) for i in inputs]
        results.append(_as_np(fn(*dev_inputs)))
    for r in results[1:]:
        assert_almost_equal(results[0], r, rtol=rtol, atol=atol)
    return results[0]


def gen_buckets_probs_with_ppf(ppf, nbuckets):
    """``nbuckets`` buckets of equal probability from the quantile
    function ``ppf``: ``([(lo, hi), ...], [1/nbuckets, ...])``."""
    edges = [ppf(i / nbuckets) for i in range(nbuckets + 1)]
    return (list(zip(edges[:-1], edges[1:])),
            [1.0 / nbuckets] * nbuckets)


def chi_square_check(generator, buckets, probs, nsamples=1000000):
    """Chi-square goodness of fit of ``generator(n)``'s samples to the
    bucket probabilities: ``(p value, observed, expected)``. Continuous
    buckets are ``(lo, hi)`` pairs, discrete ones the values; more than
    0.1 % of the samples outside every bucket fails."""
    import scipy.stats as ss

    samples = _as_np(generator(nsamples)).ravel()
    if isinstance(buckets[0], (list, tuple)):
        edges = _np.array([e for pair in buckets for e in pair],
                          dtype=_np.float64)
        ids = _np.searchsorted(edges, samples, side="right")
        obs = _np.array([(ids == 2 * i + 1).sum()
                         for i in range(len(buckets))], dtype=_np.float64)
    else:
        obs = _np.array([(samples == b).sum() for b in buckets],
                        dtype=_np.float64)
    exp = _np.asarray(probs, dtype=_np.float64) * nsamples
    outside = nsamples - obs.sum()
    if outside > max(nsamples * 1e-3, 3):
        raise AssertionError(
            f"{outside}/{nsamples} samples fell outside every bucket "
            f"{buckets[:3]}...; observed in-bucket counts {obs}")
    exp = exp * (obs.sum() / exp.sum())
    _, p = ss.chisquare(f_obs=obs, f_exp=exp)
    return p, obs, exp


def verify_generator(generator, buckets, probs, nsamples=1000000,
                     nrepeat=5, success_rate=0.2, alpha=0.05):
    """:func:`chi_square_check` ``nrepeat`` times; at least
    ``success_rate`` of the runs must have p > ``alpha``."""
    pvals = []
    for _ in range(nrepeat):
        p, obs, exp = chi_square_check(generator, buckets, probs,
                                       nsamples=nsamples)
        pvals.append(p)
    if sum(p > alpha for p in pvals) < nrepeat * success_rate:
        raise AssertionError(
            f"generator failed the chi-square harness: p-values {pvals}, "
            f"last observed {obs}, expected {exp}")
    return pvals
