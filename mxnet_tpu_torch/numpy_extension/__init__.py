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
import torch

from ..ndarray.ndarray import apply_op, waitall
from ..ops import nn as _nn
from ..ops import promote as _promote

__all__ = ["activation", "relu", "softmax", "set_np", "is_np_default_dtype",
           "default_float_dtype", "default_int_dtype", "cpu", "gpu",
           "current_device", "waitall"]


# What each act_type makes of an int or bool input in the JAX package,
# where the function's own constants decide: "inexact" computes in
# promote.inexact_dtype; "weak_int" as "inexact" but a bool meets a weak
# int first (bool -> int64 -> float64); "weak_float" meets a weak float
# (any int or bool -> float64); "refuse" and "refuse_bool" raise TypeError
# for ints and bools, or for bools only; "keep" keeps the dtype. relu keeps
# an int's dtype and makes int64 of a bool (promote.relu).
_INT_INPUT = {
    "identity": "keep",
    "tanh": "inexact", "gelu": "inexact", "erf_gelu": "inexact",
    "gelu_tanh": "inexact", "softmax": "refuse_bool",
    "log_softmax": "refuse_bool", "softrelu": "weak_int",
    "softsign": "weak_int", "mish": "weak_int", "relu6": "weak_float",
    "hard_sigmoid": "weak_float", "hard_swish": "weak_float",
    "sigmoid": "refuse", "silu": "refuse", "swish": "refuse",
}


def _float_input(x, act_type):
    """``x`` in the dtype the JAX package computes ``act_type`` of it in."""
    rule = _INT_INPUT.get(act_type, "inexact")
    if x.is_floating_point() or x.is_complex() or rule == "keep":
        return x
    boolean = x.dtype == torch.bool
    if rule == "refuse" or (rule == "refuse_bool" and boolean):
        raise _promote._refuse(act_type, x.dtype, "floating")
    if rule == "weak_float" or (rule == "weak_int" and boolean):
        return x.to(torch.float64)
    return _promote.inexact(x)


def _activation(x, act_type):
    if act_type == "relu":
        return _promote.relu(x)
    return _nn.activation(_float_input(x, act_type), act_type)


def activation(data, act_type="relu"):
    """``act_type`` of ``data``; int and bool inputs give the JAX
    package's result dtypes (:data:`_INT_INPUT`)."""
    return apply_op(lambda x: _activation(x, act_type), data)


def relu(data):
    return activation(data, "relu")


def softmax(data, axis=-1, length=None, temperature=None):
    """Softmax over ``axis``; ``length`` (per row of axis 0) masks the
    positions past it. An int input computes in promote.inexact_dtype and
    a bool one raises, as in the JAX package."""
    return apply_op(lambda x, n: _nn.softmax(_float_input(x, "softmax"),
                                             axis, n, temperature),
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
