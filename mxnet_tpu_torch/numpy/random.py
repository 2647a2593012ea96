"""``mx.np.random`` (and ``mx.random``): numpy's samplers on the current
device (counterpart of mxnet_tpu/numpy/random.py).

Each draw comes from the device's generator in ``_random.py``, seeded by
``mx.random.seed``, and is made on the device of the array parameters, or
else on the current device (``cuda:0`` outside a scope; the CPU only when
asked, by a scope or ``ctx=``/``device=``). Array parameters broadcast as
numpy's: with ``size=None`` the result takes their shape. The streams are
torch's (Philox on a card), so a seed gives other numbers than the JAX
package's threefry: tests that compare the two packages pass numpy data
to both, and hold the samplers to their distributions.
"""
from __future__ import annotations

import math

import torch

from .. import _random
from ..base import normalize_dtype
from ..ndarray.ndarray import NDArray, creation_device
from ..ops.registry import register_op

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint", "choice",
           "shuffle", "permutation", "gamma", "beta", "exponential",
           "poisson", "bernoulli", "binomial", "negative_binomial",
           "multinomial", "dirichlet", "multivariate_normal", "laplace",
           "logistic", "gumbel", "pareto", "power", "rayleigh", "weibull",
           "lognormal", "chisquare", "f", "standard_normal",
           "standard_cauchy", "standard_exponential"]

seed = _random.seed


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _float(dtype):
    if dtype is not None:
        return normalize_dtype(dtype)
    from ..numpy_extension import default_float_dtype

    return normalize_dtype(default_float_dtype())


def _value(x):
    return x._data if isinstance(x, NDArray) else x


def _where(params, ctx=None, device=None):
    """The device of the first tensor among ``params``, else the current
    (or the given) one."""
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return creation_device(device if device is not None else ctx)


def _params(params, ctx=None, device=None, dtype=torch.float32):
    """``(tensors, device, their broadcast shape)`` of the distribution
    parameters."""
    raw = [_value(p) for p in params]
    dev = _where(raw, ctx, device)
    ts = [p.to(dev) if isinstance(p, torch.Tensor)
          else torch.as_tensor(p, dtype=dtype, device=dev) for p in raw]
    return ts, dev, tuple(torch.broadcast_shapes(*[t.shape for t in ts]))


def _out_shape(size, base):
    return _shape(size) if size is not None else base


def _uniform01(shape, dtype, dev):
    return torch.empty(shape, dtype=dtype, device=dev).uniform_(
        generator=_random.generator(dev))


def _std_normal(shape, dtype, dev):
    return torch.empty(shape, dtype=dtype, device=dev).normal_(
        generator=_random.generator(dev))


def _std_gamma(alpha, shape, dtype):
    """Gamma(alpha, 1) draws of ``shape``, ``alpha`` broadcast to it."""
    a = alpha.to(dtype).expand(shape).contiguous()
    return torch._standard_gamma(a, generator=_random.generator(a.device))


_REQUIRED = object()


def _sampler(fn, **params):
    """An ``mx.np.random`` function from ``fn(params, shape, dtype, dev)``
    over tensors; ``params`` names the distribution's parameters, in
    order, with their defaults (``_REQUIRED``: none)."""
    names = list(params)

    def sample(*args, size=None, dtype=None, ctx=None, device=None,
               **kwargs):
        values = dict(zip(names, args))
        for name in names[len(args):]:
            values[name] = kwargs.pop(name, params[name])
            if values[name] is _REQUIRED:
                raise TypeError(f"{sample.__name__}() missing argument "
                                f"{name!r}")
        if kwargs:
            raise TypeError(f"{sample.__name__}() got unexpected "
                            f"arguments {sorted(kwargs)}")
        ts, dev, base = _params([values[n] for n in names], ctx, device)
        return NDArray(fn(ts, _out_shape(size, base), _float(dtype), dev))
    sample.__name__ = sample.__qualname__ = fn.__name__.lstrip("_")
    return sample


def uniform(low=0.0, high=1.0, size=None, dtype=None, device=None,
            ctx=None):
    """Samples of U[low, high)."""
    (lo, hi), dev, base = _params((low, high), ctx, device)
    u = _uniform01(_out_shape(size, base), _float(dtype), dev)
    return NDArray(u * (hi - lo) + lo)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, device=None,
           ctx=None):
    """Samples of N(loc, scale^2)."""
    (mu, sigma), dev, base = _params((loc, scale), ctx, device)
    z = _std_normal(_out_shape(size, base), _float(dtype), dev)
    return NDArray(z * sigma + mu)


def standard_normal(size=None, dtype=None, device=None, ctx=None):
    return normal(0.0, 1.0, size, dtype, device, ctx)


def randn(*shape, **kwargs):
    return normal(size=shape, **kwargs)


def rand(*shape, **kwargs):
    return uniform(size=shape, **kwargs)


def randint(low, high=None, size=None, dtype=None, device=None, ctx=None):
    """Integers of [low, high) (int32 by default)."""
    if high is None:
        low, high = 0, low
    dev = creation_device(device if device is not None else ctx)
    out = torch.randint(int(low), int(high), _shape(size),
                        generator=_random.generator(dev), device=dev,
                        dtype=normalize_dtype(dtype) if dtype is not None
                        else torch.int32)
    return NDArray(out)


def choice(a, size=None, replace=True, p=None, device=None, ctx=None):
    """Elements of ``a`` (or of ``arange(a)``), with replacement or not,
    uniformly or by the probabilities ``p``."""
    a = _value(a)
    pool = a if isinstance(a, torch.Tensor) else None
    dev = pool.device if pool is not None else creation_device(
        device if device is not None else ctx)
    n = pool.shape[0] if pool is not None else int(a)
    shape = _shape(size)
    count = math.prod(shape)
    gen = _random.generator(dev)
    if p is not None:
        idx = torch.multinomial(_value(p).to(dev, torch.float32), count,
                                replacement=replace, generator=gen)
    elif replace:
        idx = torch.randint(0, n, (count,), generator=gen, device=dev)
    else:
        idx = torch.randperm(n, generator=gen, device=dev)[:count]
    idx = idx.reshape(shape)
    return NDArray(pool[idx] if pool is not None else idx)


def permutation(x, device=None, ctx=None):
    """A permuted ``arange(x)``, or a copy of ``x`` permuted along its
    first axis."""
    x = _value(x)
    if isinstance(x, int):
        dev = creation_device(device if device is not None else ctx)
        return NDArray(torch.randperm(x, generator=_random.generator(dev),
                                      device=dev))
    perm = torch.randperm(x.shape[0], generator=_random.generator(x.device),
                          device=x.device)
    return NDArray(x[perm])


def shuffle(x):
    """Permute ``x`` along its first axis in place, in its own storage."""
    from ..ndarray.register import write_into

    write_into(x, permutation(x))


def _gamma(ts, shape, dtype, dev):  # noqa: ARG001
    k, theta = ts
    return _std_gamma(k, shape, dtype) * theta


gamma = _sampler(_gamma, shape=_REQUIRED, scale=1.0)


def _beta(ts, shape, dtype, dev):  # noqa: ARG001
    x, y = (_std_gamma(t, shape, dtype) for t in ts)
    return x / (x + y)


beta = _sampler(_beta, a=_REQUIRED, b=_REQUIRED)


def _exponential(ts, shape, dtype, dev):
    e = torch.empty(shape, dtype=dtype, device=dev).exponential_(
        generator=_random.generator(dev))
    return e * ts[0]


exponential = _sampler(_exponential, scale=1.0)


def standard_exponential(size=None, dtype=None, device=None, ctx=None):
    return exponential(1.0, size=size, dtype=dtype, device=device, ctx=ctx)


def _counts(draw, dtype):
    return draw.to(normalize_dtype(dtype) if dtype is not None
                   else torch.int32)


def poisson(lam=1.0, size=None, dtype=None, device=None, ctx=None):
    """Counts of Poisson(lam), int32 by default."""
    (rate,), dev, base = _params((lam,), ctx, device)
    r = rate.to(torch.float32).expand(_out_shape(size, base)).contiguous()
    return NDArray(_counts(torch.poisson(r, generator=_random.generator(
        dev)), dtype))


def bernoulli(prob=None, logit=None, size=None, dtype=None, device=None,
              ctx=None):
    """0/1 draws (default float) with probability ``prob`` or
    ``sigmoid(logit)``."""
    if (prob is None) == (logit is None):
        raise ValueError("pass exactly one of prob/logit")
    (p,), dev, base = _params((prob if prob is not None else logit,), ctx,
                              device)
    if prob is None:
        p = torch.sigmoid(p.to(torch.float32))
    p = p.to(torch.float32).expand(_out_shape(size, base)).contiguous()
    return NDArray(torch.bernoulli(p, generator=_random.generator(dev)).to(
        _float(dtype)))


def binomial(n, p, size=None, dtype=None, device=None, ctx=None):
    """Successes of ``n`` trials of probability ``p`` (float)."""
    (cnt, prob), dev, base = _params((n, p), ctx, device)
    shape = _out_shape(size, base)
    draw = torch.binomial(cnt.to(torch.float32).expand(shape).contiguous(),
                          prob.to(torch.float32).expand(shape).contiguous(),
                          generator=_random.generator(dev))
    return NDArray(draw.to(_float(dtype)))


def negative_binomial(n, p, size=None, dtype=None, device=None, ctx=None):
    """Failures before ``n`` successes of probability ``p``: Poisson of a
    Gamma(n, (1 - p) / p) rate."""
    (k, prob), dev, base = _params((n, p), ctx, device)
    lam = _std_gamma(k, _out_shape(size, base), torch.float32) * (
        (1.0 - prob) / prob)
    return NDArray(_counts(torch.poisson(
        lam, generator=_random.generator(dev)), dtype))


def dirichlet(alpha, size=None, dtype=None, device=None, ctx=None):
    """Points of the simplex, the event axis last."""
    (a,), _, base = _params((alpha,), ctx, device)
    g = _std_gamma(a, _shape(size) + base, _float(dtype))
    return NDArray(g / g.sum(-1, keepdim=True))


def multinomial(n, pvals, size=None, device=None, ctx=None):
    """Counts of ``n`` draws over the categories of ``pvals``, shape
    ``size + (k,)``, float64 as the JAX package's (``jax.random.
    multinomial``'s float under its 64-bit types)."""
    (p,), dev, _ = _params((pvals,), ctx, device)
    shape = _shape(size)
    rows = math.prod(shape)
    k = p.shape[-1]
    idx = torch.multinomial(p.to(torch.float32).expand(rows, k), int(n),
                            replacement=True,
                            generator=_random.generator(dev))
    counts = torch.zeros(rows, k, dtype=torch.float64, device=dev)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float64))
    return NDArray(counts.reshape(shape + (k,)))


def multivariate_normal(mean, cov, size=None, check_valid=None, tol=None,
                        dtype=None, device=None,
                        ctx=None):  # noqa: ARG001 - numpy's signature
    """``mean + L z`` with L the Cholesky factor of ``cov``."""
    (mu, sigma), dev, _ = _params((mean, cov), ctx, device)
    dt = _float(dtype)
    z = _std_normal(_shape(size) + (mu.shape[-1],), dt, dev)
    return NDArray(mu.to(dt) + z @ torch.linalg.cholesky(sigma.to(dt)).mT)


def _location_scale(name, standard):
    def sample(loc=0.0, scale=1.0, size=None, dtype=None, device=None,
               ctx=None):
        (mu, s), dev, base = _params((loc, scale), ctx, device)
        dt = _float(dtype)
        return NDArray(standard(_out_shape(size, base), dt, dev) * s + mu)
    sample.__name__ = name
    return sample


def _tiny_uniform(shape, dt, dev):
    """U(0, 1) without 0, for the logarithms below."""
    u = _uniform01(shape, dt, dev)
    return u.clamp_min(torch.finfo(dt).tiny)


laplace = _location_scale("laplace", lambda shape, dt, dev: (
    lambda u: -torch.sign(u) * torch.log1p(-2 * u.abs()))(
        _uniform01(shape, dt, dev) - 0.5))
logistic = _location_scale("logistic", lambda shape, dt, dev: (
    lambda u: torch.log(u) - torch.log1p(-u))(_tiny_uniform(shape, dt, dev)))
gumbel = _location_scale("gumbel", lambda shape, dt, dev: -torch.log(
    -torch.log(_tiny_uniform(shape, dt, dev))))


def _pareto(ts, shape, dtype, dev):
    e = torch.empty(shape, dtype=dtype, device=dev).exponential_(
        generator=_random.generator(dev))
    return torch.expm1(e / ts[0])


pareto = _sampler(_pareto, a=_REQUIRED)


def _power(ts, shape, dtype, dev):
    return _uniform01(shape, dtype, dev) ** (1.0 / ts[0])


power = _sampler(_power, a=_REQUIRED)


def _rayleigh(ts, shape, dtype, dev):
    u = _uniform01(shape, dtype, dev)
    return ts[0] * torch.sqrt(-2.0 * torch.log1p(-u))


rayleigh = _sampler(_rayleigh, scale=1.0)


def _weibull(ts, shape, dtype, dev):
    e = torch.empty(shape, dtype=dtype, device=dev).exponential_(
        generator=_random.generator(dev))
    return e ** (1.0 / ts[0])


weibull = _sampler(_weibull, a=_REQUIRED)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, device=None,
              ctx=None):
    return NDArray(torch.exp(normal(mean, sigma, size, dtype, device,
                                    ctx)._data))


def _chisquare(ts, shape, dtype, dev):  # noqa: ARG001
    return 2.0 * _std_gamma(ts[0] / 2.0, shape, dtype)


chisquare = _sampler(_chisquare, df=_REQUIRED)


def _f(ts, shape, dtype, dev):
    num, den = ts
    return ((_chisquare([num], shape, dtype, dev) / num)
            / (_chisquare([den], shape, dtype, dev) / den))


f = _sampler(_f, dfnum=_REQUIRED, dfden=_REQUIRED)


def standard_cauchy(size=None, dtype=None, device=None, ctx=None):
    dev = creation_device(device if device is not None else ctx)
    u = _uniform01(_shape(size), _float(dtype), dev)
    return NDArray(torch.tan(math.pi * (u - 0.5)))


# the ``_npi_*`` spellings of the samplers (src/operator/numpy/random/)
for _name, _fn in (("normal", normal), ("uniform", uniform),
                   ("gamma", gamma), ("exponential", exponential),
                   ("laplace", laplace), ("gumbel", gumbel),
                   ("logistic", logistic), ("pareto", pareto),
                   ("rayleigh", rayleigh), ("weibull", weibull),
                   ("bernoulli", bernoulli), ("choice", choice),
                   ("multinomial", multinomial), ("normal_n", normal),
                   ("uniform_n", uniform), ("powerd", power)):
    register_op(f"_npi_{_name}", _fn)
del _name, _fn
