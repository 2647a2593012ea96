"""The per-row samplers (``_sample_*``) and densities (``_random_pdf_*``)
of the legacy API (counterpart of mxnet_tpu/ops/random_legacy.py).

A sampler draws ``shape`` samples for each element of its parameter
tensors, with that element's parameters (multisample_op.cc), from the
generator of the parameters' device. A density is closed-form, over
per-row parameters broadcast against the sample dims, with ``is_log``
(pdf_op.cc).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .. import _random
from ..base import normalize_dtype
from .registry import register_op

__all__ = ["sample_multinomial", "multinomial_logp"]


def _shape_tuple(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _flag(v):
    """A bool attribute, also in the string form of a symbol graph."""
    return v in (True, 1, "True", "true", "1")


def _sampler(name, draw):
    """``draw(generator, out_shape, *params expanded)``, float32."""

    def sample(*params, shape=None, dtype=None, **kwargs):  # noqa: ARG001
        ps = [p if isinstance(p, torch.Tensor) else torch.as_tensor(p)
              for p in params]
        dev = ps[0].device
        extra = _shape_tuple(shape)
        out_shape = tuple(ps[0].shape) + extra
        ps = [p.to(torch.float32).reshape(tuple(p.shape) + (1,) * len(extra))
              .expand(out_shape) for p in ps]
        out = draw(_random.generator(dev), out_shape, *ps)
        if dtype is not None and str(dtype) != "None":
            out = out.to(normalize_dtype(dtype))
        return out

    sample.__name__ = sample.__qualname__ = name
    return sample


def _empty(shape, p):
    return torch.empty(shape, dtype=torch.float32, device=p.device)


def _gamma(gen, alpha):
    return torch._standard_gamma(alpha.contiguous(), generator=gen)


_DRAWS = {
    "uniform": lambda gen, shape, low, high: low + _empty(
        shape, low).uniform_(generator=gen) * (high - low),
    "normal": lambda gen, shape, mu, sigma: mu + sigma * _empty(
        shape, mu).normal_(generator=gen),
    # the rate parameterization, lam
    "exponential": lambda gen, shape, lam: _empty(shape, lam).exponential_(
        generator=gen) / lam,
    # alpha the shape, beta the scale
    "gamma": lambda gen, shape, alpha, beta: _gamma(gen, alpha) * beta,
    "poisson": lambda gen, shape, lam: torch.poisson(lam.contiguous(),
                                                     generator=gen),
}


def multinomial_logp(p):
    """The log of the normalized probability rows ``p``: the normalizer
    carries no gradient, and a class of probability 0 gets -87 and a zero
    gradient (random_legacy.py:multinomial_logp)."""
    pos = p > 0
    logz = torch.log(p.sum(-1, keepdim=True)).detach()
    safe = torch.log(torch.where(pos, p, torch.ones_like(p)))
    return torch.where(pos, safe, torch.full_like(p, -87.0)) - logz


def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       **kwargs):  # noqa: ARG001
    """Categories of the probability rows ``data`` (..., k), ``shape``
    draws a row, by the inverse CDF; with ``get_prob`` also their
    log-probabilities (sample_multinomial_op.h)."""
    extra = _shape_tuple(shape)
    batch, k = tuple(data.shape[:-1]), data.shape[-1]
    cdf = torch.cumsum(data.detach().float(), -1)
    cdf = (cdf / cdf[..., -1:]).reshape(batch + (1,) * len(extra) + (k,))
    u = torch.empty(batch + extra, dtype=torch.float32,
                    device=data.device).uniform_(
        generator=_random.generator(data.device))
    idx = (u[..., None] >= cdf).sum(-1).clamp(0, k - 1)
    idx = idx.to(normalize_dtype(dtype))
    if not _flag(get_prob):
        return idx
    logp = multinomial_logp(data).reshape(batch + (1,) * len(extra) + (k,))
    logp = logp.expand(batch + extra + (k,))
    picked = torch.take_along_dim(logp, idx[..., None].to(torch.int64),
                                  dim=-1)[..., 0]
    return idx, picked


def _zipfian_draws(u, range_max):
    """Uniform draws to log-uniform classes in [0, range_max):
    ``lround(exp(u * log(range_max))) - 1``, clipped (sampler.h)."""
    raw = onp.floor(onp.exp(u * math.log(range_max)) + 0.5).astype(
        onp.int64) - 1
    return onp.clip(raw, 0, range_max - 1)


def sample_unique_zipfian(range_max, shape=None, **kwargs):  # noqa: ARG001
    """``shape[-1]`` distinct log-uniform classes a row, and how many raw
    draws each row took (unique_sample_op.cc, a host op there too): int64
    ``(classes, num_trials)`` on the current device."""
    from ..device import current_device

    shp = _shape_tuple(shape)
    if len(shp) == 1:
        shp = (1,) + shp
    batch, num_sampled = shp
    if num_sampled > range_max:
        raise ValueError(f"cannot draw {num_sampled} unique classes from "
                         f"range_max={range_max}")
    dev = current_device()
    seed = int(torch.randint(0, 2 ** 31 - 1, (), device=dev,
                             generator=_random.generator(dev)))
    rs = onp.random.RandomState(seed)
    classes = onp.empty((batch, num_sampled), onp.int64)
    trials = onp.empty((batch,), onp.int64)
    for i in range(batch):
        draws = onp.empty((0,), onp.int64)
        chunk = max(4 * num_sampled, 1024)
        while True:
            draws = onp.concatenate(
                [draws, _zipfian_draws(rs.random_sample(chunk), range_max)])
            uniq, first = onp.unique(draws, return_index=True)
            if uniq.size >= num_sampled:
                cut = onp.sort(first)[num_sampled - 1]
                trials[i] = cut + 1
                keep = first <= cut
                classes[i] = uniq[keep][onp.argsort(first[keep])]
                break
            chunk *= 2
    return (torch.as_tensor(classes, device=dev),
            torch.as_tensor(trials, device=dev))


def shuffle(data, **kwargs):  # noqa: ARG001
    """A copy permuted along the first axis (shuffle_op.cc)."""
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_random.generator(data.device))
    return data[perm]


# -- densities ---------------------------------------------------------------

def _pdf(name, logpdf, nparams, consumes_last=False):
    def density(sample, *params, is_log=False, **kwargs):  # noqa: ARG001
        ps = list(params[:nparams])
        extra = sample.dim() - ps[0].dim()
        if consumes_last:   # the event axis stays last (dirichlet)
            ps = [p.reshape(tuple(p.shape[:-1]) + (1,) * extra
                            + tuple(p.shape[-1:])) for p in ps]
        else:
            ps = [p.reshape(tuple(p.shape) + (1,) * extra) for p in ps]
        ll = logpdf(sample, *ps)
        return ll if _flag(is_log) else torch.exp(ll)

    density.__name__ = density.__qualname__ = name
    return density


def _lp_uniform(x, low, high):
    inside = (x >= low) & (x <= high)
    return torch.where(inside, -torch.log(high - low),
                       torch.full_like(x, -math.inf))


def _lp_normal(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - torch.log(sigma) - 0.5 * math.log(2 * math.pi)


def _lp_gamma(x, alpha, beta):
    return ((alpha - 1) * torch.log(x) - x / beta - torch.lgamma(alpha)
            - alpha * torch.log(beta))


def _lp_exponential(x, lam):
    return torch.log(lam) - lam * x


def _lp_poisson(x, lam):
    return x * torch.log(lam) - lam - torch.lgamma(x + 1)


def _lp_negative_binomial(x, k, p):
    return (torch.lgamma(x + k) - torch.lgamma(k) - torch.lgamma(x + 1)
            + k * torch.log(p) + x * torch.log1p(-p))


def _lp_generalized_negative_binomial(x, mu, alpha):
    r = 1.0 / torch.clamp_min(alpha, 1e-12)
    return _lp_negative_binomial(x, r, r / (r + mu))


def _lp_dirichlet(x, alpha):
    return ((alpha - 1) * torch.log(x)).sum(-1) + torch.lgamma(
        alpha.sum(-1)) - torch.lgamma(alpha).sum(-1)


for _name, (_lp, _n) in {
        "uniform": (_lp_uniform, 2), "normal": (_lp_normal, 2),
        "gamma": (_lp_gamma, 2), "exponential": (_lp_exponential, 1),
        "poisson": (_lp_poisson, 1),
        "negative_binomial": (_lp_negative_binomial, 2),
        "generalized_negative_binomial":
            (_lp_generalized_negative_binomial, 2)}.items():
    register_op(f"_random_pdf_{_name}", _pdf(f"_random_pdf_{_name}", _lp,
                                              _n))
register_op("_random_pdf_dirichlet", _pdf("_random_pdf_dirichlet",
                                          _lp_dirichlet, 1,
                                          consumes_last=True))
for _name, _draw in _DRAWS.items():
    register_op(f"_sample_{_name}", _sampler(f"_sample_{_name}", _draw))
register_op("_sample_multinomial", sample_multinomial)
register_op("_sample_unique_zipfian", sample_unique_zipfian)
register_op("_shuffle", shuffle)
del _name
