"""``mx.npx``: the operators beyond NumPy that LeNet and the tests use
(counterpart of the subset of mxnet_tpu/numpy_extension/__init__.py:77,
:151, :200): ``activation``, ``relu``, ``softmax``, and ``set_np`` with the
creation defaults it sets (``default_float_dtype``). Each op runs the
port's ``ops/nn.py`` function through ``apply_op``, so it is recorded
inside ``autograd.record()``.
"""
from __future__ import annotations

import numpy as _np

from ..device import cpu, current_device, gpu
from ..ndarray.ndarray import apply_op, waitall
from ..ops import nn as _nn

__all__ = ["activation", "relu", "softmax", "set_np", "is_np_default_dtype",
           "default_float_dtype", "default_int_dtype", "cpu", "gpu",
           "current_device", "waitall"]


def activation(data, act_type="relu"):
    return apply_op(lambda x: _nn.activation(x, act_type), data)


def relu(data):
    return activation(data, "relu")


def softmax(data, axis=-1, length=None, temperature=None):
    """Softmax over ``axis``; ``length`` (per row of axis 0) masks the
    positions past it."""
    return apply_op(lambda x, n: _nn.softmax(x, axis, n, temperature),
                    data, length)


_flags = {"dtype": False}


def set_np(shape=True, array=True, dtype=False):
    """Set the np-semantics flags (numpy_extension/__init__.py:151). Every
    array is an ``mx.np`` array here, as there, so ``shape`` and ``array``
    change nothing; ``dtype=True`` makes creation default to float64 and
    int64, as official numpy does."""
    if array and not shape:
        raise ValueError("set_np: array semantics require shape semantics")
    _flags["dtype"] = bool(dtype)


def is_np_default_dtype():
    """True when creation follows official numpy's float64/int64."""
    return _flags["dtype"]


def default_float_dtype():
    """The creation default float dtype: float32, or float64 under
    ``set_np(dtype=True)`` (numpy_extension/__init__.py:200)."""
    return _np.float64 if _flags["dtype"] else _np.float32


def default_int_dtype():
    return _np.int64 if _flags["dtype"] else _np.int32
