"""``mx.nd.random``: the legacy spellings over ``mx.np.random``
(counterpart of mxnet_tpu/ndarray/random.py): ``shape=`` for numpy's
``size=``, the legacy parameter names, and ``out=`` takes the sample in
place, into its own storage."""
from __future__ import annotations

from .ndarray import NDArray, apply_op  # noqa: F401 - as the reference's

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle", "seed"]


def _npr():
    from ..numpy import random   # mx.np imports this package

    return random


def _out(res, out):
    if out is None:
        return res
    from .register import write_into

    return write_into(out, res)


def _legacy(name, **renames):
    def sample(*args, shape=None, ctx=None, dtype=None, out=None, **kwargs):
        for old, new in renames.items():
            if old in kwargs:
                kwargs[new] = kwargs.pop(old)
        res = getattr(_npr(), name)(*args, size=shape, dtype=dtype, ctx=ctx,
                                    **kwargs)
        return _out(res, out)
    sample.__name__ = sample.__qualname__ = name
    return sample


uniform = _legacy("uniform")
normal = _legacy("normal", mu="loc", sigma="scale")
gamma = _legacy("gamma", alpha="shape", beta="scale")
# the parameter of nd.random.exponential is the scale, numpy's; the legacy
# op nd.random_exponential takes lam = 1 / scale
exponential = _legacy("exponential")
poisson = _legacy("poisson")
negative_binomial = _legacy("negative_binomial", k="n")
randint = _legacy("randint")


def randn(*shape, **kwargs):
    return _npr().randn(*shape, **kwargs)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, out=None):
    """Negative binomial with mean ``mu`` and dispersion ``alpha``: n =
    1 / alpha, p = 1 / (1 + mu * alpha) (random.py:46)."""
    res = _npr().negative_binomial(1.0 / alpha, 1.0 / (1.0 + mu * alpha),
                                   size=shape, dtype=dtype, ctx=ctx)
    return _out(res, out)


def multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Categories drawn from the probability rows of ``data`` (the last
    axis), ``shape`` appended to the batch dims; with ``get_prob`` also
    their log-probabilities, differentiable in ``data`` (random.py:64)."""
    from ..ndarray.ndarray import apply_op
    from ..ops import random_legacy as _rl

    def draw(p):
        return _rl.sample_multinomial(p, shape, get_prob, dtype)

    return apply_op(draw, data)


def shuffle(data, **kwargs):  # noqa: ARG001
    """A copy permuted along the first axis (the legacy op returns it)."""
    return _npr().permutation(data)


def seed(seed_state, ctx="all"):
    _npr().seed(seed_state, ctx)
