"""``mx.np.random``: uniform, normal and randint on the current device
(counterpart of mxnet_tpu/numpy/random.py:47, :54, :72).

Each draw comes from the device's generator in ``_random.py``, seeded by
``mx.random.seed``. The streams are torch's (Philox on a card), so a seed
gives other numbers than the JAX package's threefry: tests that compare
the two packages pass numpy data to both.
"""
from __future__ import annotations

import torch

from .. import _random
from ..base import normalize_dtype
from ..ndarray.ndarray import NDArray, creation_device

__all__ = ["seed", "uniform", "normal", "randint"]

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


def uniform(low=0.0, high=1.0, size=None, dtype=None, device=None, ctx=None):
    """Samples of U[low, high) of shape ``size``."""
    dev = creation_device(device if device is not None else ctx)
    out = torch.empty(_shape(size), dtype=_float(dtype), device=dev)
    out.uniform_(generator=_random.generator(dev))
    return NDArray(out * (_value(high) - _value(low)) + _value(low))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, device=None,
           ctx=None):
    """Samples of N(loc, scale^2) of shape ``size``."""
    dev = creation_device(device if device is not None else ctx)
    out = torch.empty(_shape(size), dtype=_float(dtype), device=dev)
    out.normal_(generator=_random.generator(dev))
    return NDArray(out * _value(scale) + _value(loc))


def randint(low, high=None, size=None, dtype=None, device=None, ctx=None):
    """Integers of [low, high) (int32 by default) of shape ``size``."""
    if high is None:
        low, high = 0, low
    dev = creation_device(device if device is not None else ctx)
    out = torch.randint(int(low), int(high), _shape(size),
                        generator=_random.generator(dev), device=dev,
                        dtype=normalize_dtype(dtype) if dtype is not None
                        else torch.int32)
    return NDArray(out)
