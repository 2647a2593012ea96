"""``mx.npx``: the operators beyond NumPy (counterpart of
mxnet_tpu/numpy_extension/__init__.py).

Filled from the op registry as ``mx.nd`` is (``ndarray/register.py``), so
every registered op resolves here too, over NDArrays and recorded inside
``autograd.record()``. Hand-written ahead of it: ``activation``, ``relu``,
``sigmoid`` and ``softmax`` with the JAX package's result dtypes for int
inputs; the stateful ``batch_norm`` (the running statistics updated in
place while training) and ``dropout``; the npx ``reshape`` codes;
``masked_softmax``, ``gelu``, ``arange_like``, ``broadcast_like`` in
their npx forms; the samplers ``bernoulli``, ``normal_n``, ``uniform_n``;
the data-dependent ``nonzero``, ``boolean_mask``, ``constraint_check``;
``set_np`` and the creation defaults it sets; control flow
(``control_flow.py``).
"""
from __future__ import annotations

import threading

import numpy as _np
import torch
import torch.nn.functional as F

from .. import _random
from ..autograd import is_training
from ..device import cpu, current_device, gpu, num_gpus, tpu
from ..ndarray.ndarray import NDArray, apply_op, waitall
from ..ndarray.register import populate, write_into
from ..ndarray.utils import load, save, savez
from ..ops import nn as _nn
from ..ops import promote as _promote
from ..ops.registry import register_op
from .control_flow import cond, foreach, while_loop

__all__ = ["cond", "foreach", "while_loop", "activation", "relu", "sigmoid",
           "softmax", "batch_norm", "BatchNorm", "dropout", "Dropout",
           "gamma", "erf", "erfinv", "set_np", "reset_np", "is_np_array",
           "is_np_shape", "is_np_default_dtype", "default_float_dtype",
           "default_int_dtype", "use_np", "cpu", "gpu", "tpu", "num_gpus",
           "current_device", "waitall", "seed", "from_numpy", "from_dlpack",
           "to_dlpack_for_read", "to_dlpack_for_write", "arange_like",
           "batch_dot", "broadcast_like", "masked_softmax",
           "masked_log_softmax", "gelu", "bernoulli", "normal_n",
           "uniform_n", "reshape", "npx_reshape_shape", "batch_flatten",
           "boolean_mask", "index_update", "index_add", "nonzero",
           "constraint_check", "load", "save", "savez"]


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


_UNSET = object()


def _one_of(fn, first, first_name, second, second_name):
    """The one argument given of two spellings of it (MXNet's and the JAX
    package's); both or neither raise ``TypeError``."""
    if (first is _UNSET) == (second is _UNSET):
        raise TypeError(f"{fn}() takes its argument as {first_name}= or "
                        f"{second_name}=, once")
    return second if first is _UNSET else first


def relu(data=_UNSET, x=_UNSET):
    """ReLU; the argument as ``data`` (MXNet's name) or ``x`` (the JAX
    package's, numpy_extension/__init__.py:77)."""
    return activation(_one_of("relu", data, "data", x, "x"), "relu")


def sigmoid(data=_UNSET, x=_UNSET):
    """Sigmoid; ``data`` or ``x``, as :func:`relu`."""
    return activation(_one_of("sigmoid", data, "data", x, "x"), "sigmoid")


def softmax(data, axis=-1, length=None, temperature=None):
    """Softmax over ``axis``; ``length`` (per row of axis 0) masks the
    positions past it. An int input computes in promote.inexact_dtype and
    a bool one raises, as in the JAX package."""
    return apply_op(lambda x, n: _nn.softmax(_float_input(x, "softmax"),
                                             axis, n, temperature),
                    data, length)


# the np-semantics flags: process-wide, as set_np sets them
_flags = {"dtype": False, "array": True, "shape": True}


def set_np(shape=True, array=True, dtype=False):
    """Set the np-semantics flags (numpy_extension/__init__.py:151). Every
    array is an ``mx.np`` array here, as there, so ``shape`` and ``array``
    only change what :func:`is_np_shape`/:func:`is_np_array` report;
    ``dtype=True`` makes creation default to float64 and int64, as official
    numpy does."""
    if array and not shape:
        raise ValueError("set_np: array semantics require shape semantics")
    _flags.update(dtype=bool(dtype), array=bool(array), shape=bool(shape))


def reset_np():
    """Every np-semantics flag off; creation back to float32/int32."""
    _flags.update(dtype=False, array=False, shape=False)


# thread-local overrides of "array" and "shape" by util.np_array and
# util.np_shape scopes (numpy_extension/__init__.py:142)
_np_tls = threading.local()


def is_np_array():
    over = getattr(_np_tls, "array", None)
    return _flags["array"] if over is None else over


def is_np_shape():
    over = getattr(_np_tls, "shape", None)
    return _flags["shape"] if over is None else over


def is_np_default_dtype():
    """True when creation follows official numpy's float64/int64."""
    return _flags["dtype"]


def default_float_dtype():
    """The creation default float dtype: float32, or float64 under
    ``set_np(dtype=True)`` (numpy_extension/__init__.py:200)."""
    return _np.float64 if _flags["dtype"] else _np.float32


def default_int_dtype():
    return _np.int64 if _flags["dtype"] else _np.int32


def use_np(func):
    """The decorator of the reference: every array is an np array here."""
    return func


def seed(seed_state=_UNSET, ctx="all", s=_UNSET):
    """Seed the generators; the seed as ``seed_state`` (MXNet's name) or
    ``s`` (the JAX package's, numpy_extension/__init__.py:235)."""
    _random.seed(_one_of("seed", seed_state, "seed_state", s, "s"), ctx)


# -- the stateful ops -----------------------------------------------------

def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    """BatchNorm over ``axis`` (numpy_extension/__init__.py:85): while
    training (``autograd.is_training()``, and not ``use_global_stats``)
    the batch statistics normalize, through K1/K2 for CUDA tensors, and
    ``running_mean``/``running_var`` take the blended statistics in place,
    in their own storage; otherwise the running statistics normalize.
    ``fix_gamma`` replaces gamma by ones."""
    training = is_training() and not use_global_stats
    if fix_gamma:
        gamma = NDArray(torch.ones_like(gamma._data))

    def bn(x_, g_, b_, m_, v_):
        return _nn.batch_norm(x_, g_, b_, m_, v_, eps=eps,
                              momentum=momentum, training=training,
                              use_global_stats=use_global_stats, axis=axis)

    out, new_mean, new_var = apply_op(bn, x, gamma, beta, running_mean,
                                      running_var)
    if training:
        # state, not a result: no gradient flows into the statistics
        write_into(running_mean, new_mean._data.detach())
        write_into(running_var, new_var._data.detach())
    return (out, new_mean, new_var) if output_mean_var else out


def BatchNorm(data, gamma, beta, moving_mean, moving_var, **kwargs):  # noqa: N802
    return batch_norm(data, gamma, beta, moving_mean, moving_var, **kwargs)


def dropout(x, p=0.5, axes=None, mode="training"):
    """Inverted dropout while training or with ``mode="always"``, the mask
    from the generator of x's device."""
    if not (is_training() or mode == "always") or p <= 0:
        return x
    return apply_op(lambda t: _nn.dropout(
        t, p=p, training=True, axes=axes,
        generator=_random.generator(t.device)), x)


def Dropout(data, p=0.5, mode="training", axes=None, **kwargs):  # noqa: ARG001, N802
    return dropout(data, p=p, axes=axes, mode=mode)


# -- special functions ----------------------------------------------------

def _gamma_fn(v):
    """``jax.scipy.special.gamma``: sign times exp(lgamma)."""
    v = _promote.inexact(v)
    odd = torch.remainder(torch.floor(v), 2) != 0
    sign = torch.where((v < 0) & odd, -torch.ones_like(v),
                       torch.ones_like(v))
    return sign * torch.exp(torch.lgamma(v))


def gamma(x):
    return apply_op(_gamma_fn, x)


def erf(x):
    return apply_op(lambda v: torch.erf(_promote.inexact(v)), x)


def erfinv(x):
    return apply_op(lambda v: torch.erfinv(_promote.inexact(v)), x)


# -- the npx forms of ops the registry also has ------------------------------

def from_numpy(ndarray_, zero_copy=True):  # noqa: ARG001
    """An NDArray of a numpy array, on the current device."""
    from ..ndarray.ndarray import array

    a = _np.asarray(ndarray_)
    return array(a, dtype=a.dtype)


def from_dlpack(x):
    return NDArray(torch.from_dlpack(x))


def to_dlpack_for_read(x):
    """The array's tensor, which speaks the DLPack protocol
    (``__dlpack__``)."""
    return x._data


to_dlpack_for_write = to_dlpack_for_read


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * (i // repeat)`` in data's dtype, shaped like
    ``data`` or as long as its ``axis`` (the npx form, contrib
    arange_like)."""

    def pure(x):
        n = x.numel() if axis is None else x.shape[axis]
        idx = torch.arange(n, dtype=x.dtype, device=x.device)
        if repeat != 1:
            idx = torch.div(idx, repeat, rounding_mode="floor")
        out = start + step * idx
        return out.reshape(x.shape) if axis is None else out

    return apply_op(pure, data)


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    """Batched matmul over the leading batch dims."""
    return apply_op(lambda x, y: torch.matmul(
        x.mT if transpose_a else x, y.mT if transpose_b else y), a, b)


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """``lhs`` broadcast to ``rhs``'s shape, or on ``lhs_axes`` to the
    extents of ``rhs_axes``."""

    def pure(x, y):
        if lhs_axes is None:
            return x.expand(y.shape)
        shape = list(x.shape)
        for la, ra in zip(lhs_axes, rhs_axes):
            shape[la] = y.shape[ra]
        return x.expand(shape)

    return apply_op(pure, lhs, rhs)


def _masked(x, m, axis, temperature, log):
    keep = m.bool()
    neg = torch.finfo(x.dtype).min
    logits = torch.where(keep, x / temperature, torch.full_like(x, neg))
    out = (torch.log_softmax if log else torch.softmax)(logits, dim=axis)
    fill = torch.full_like(out, neg if log else 0.0)
    return torch.where(keep, out, fill).to(x.dtype)


def masked_softmax(data, mask, axis=-1, temperature=1.0):
    """Softmax over the positions ``mask`` keeps, 0 elsewhere."""
    return apply_op(lambda x, m: _masked(x, m, axis, temperature, False),
                    data, mask)


def masked_log_softmax(data, mask, axis=-1, temperature=1.0):
    """Log-softmax over the positions ``mask`` keeps, the dtype's lowest
    value elsewhere."""
    return apply_op(lambda x, m: _masked(x, m, axis, temperature, True),
                    data, mask)


def gelu(x, approximate=True):
    """``jax.nn.gelu``: the tanh form by default, the exact erfc form with
    ``approximate=False``."""
    return apply_op(lambda v: F.gelu(v, approximate="tanh") if approximate
                    else _nn.gelu_exact(v), x)


# -- samplers -----------------------------------------------------------------

def bernoulli(prob=None, logit=None, size=None, dtype=None):
    """0/1 draws (float32 by default) of probability ``prob`` or
    ``sigmoid(logit)``, shaped ``size`` or like the parameter."""
    from ..numpy.random import bernoulli as _bern

    return _bern(prob, logit, size=size, dtype=dtype or "float32")


def _sample_n(name, a, b, shape, dtype):
    from ..numpy import random as _npr

    ts, dev, base = _npr._params((a, b))
    return getattr(_npr, name)(ts[0], ts[1], size=tuple(shape or ()) + base,
                               dtype=dtype)


def normal_n(loc=0.0, scale=1.0, shape=None, dtype="float32"):
    """N(loc, scale^2) draws of shape ``shape + broadcast(loc, scale)``."""
    return _sample_n("normal", loc, scale, shape, dtype)


def uniform_n(low=0.0, high=1.0, shape=None, dtype="float32"):
    """U[low, high) draws of shape ``shape + broadcast(low, high)``."""
    return _sample_n("uniform", low, high, shape, dtype)


# -- shapes and data-dependent outputs -------------------------------------------

def npx_reshape_shape(src, target):
    """The ``_npx_reshape`` code table (np_matrix_op.cc
    NumpyXReshapeInferShape): -1 infers, -2 copies a dim, -3 skips a size-1
    dim, -4 copies the rest, -5 merges two, -6 splits one into the next two
    entries (either may be -1)."""
    src, target = list(src), list(target)
    if all(t >= 0 for t in target):
        return tuple(target)
    out, i, j, infer_at, known = [], 0, 0, -1, 1
    while j < len(target):
        t = target[j]
        if t == -1:
            infer_at = len(out)
            out.append(-1)
            i += 1
        elif t == -2:
            out.append(src[i])
            known *= src[i]
            i += 1
        elif t == -3:
            if src[i] != 1:
                raise ValueError("-3 may only skip a size-1 dim")
            i += 1
        elif t == -4:
            while i < len(src):
                out.append(src[i])
                known *= src[i]
                i += 1
        elif t == -5:
            out.append(src[i] * src[i + 1])
            known *= src[i] * src[i + 1]
            i += 2
        elif t == -6:
            if j + 2 >= len(target):
                raise ValueError(
                    "-6 needs two following entries in the (possibly "
                    f"reversed) target shape, got {target[j:]}")
            d0, d1, d2 = src[i], target[j + 1], target[j + 2]
            if d1 == -1:
                d1 = d0 // d2
            elif d2 == -1:
                d2 = d0 // d1
            if d1 * d2 != d0:
                raise ValueError(f"split dims ({d1}, {d2}) do not divide "
                                 f"source dim {d0}")
            out.extend([d1, d2])
            known *= d1 * d2
            i += 1
            j += 2
        else:
            out.append(t)
            known *= t
            i += 1
        j += 1
    if infer_at >= 0:
        out[infer_at] = int(_np.prod(src)) // known
    return tuple(out)


def reshape(a, newshape, reverse=False, order="C"):  # noqa: ARG001
    """Reshape by the npx codes (:func:`npx_reshape_shape`), read from the
    right with ``reverse``."""

    def pure(v):
        shape = [newshape] if isinstance(newshape, int) else list(newshape)
        src = list(v.shape)
        if reverse:
            return v.reshape(npx_reshape_shape(src[::-1], shape[::-1])[::-1])
        return v.reshape(npx_reshape_shape(src, shape))

    return apply_op(pure, a)


def batch_flatten(x):
    """All but the batch axis collapsed."""
    return apply_op(lambda v: v.reshape(v.shape[0], -1), x)


def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is non-zero
    (contrib boolean_mask.cc); the output's length depends on the data,
    and the gradient scatters back to the kept slices."""
    return apply_op(lambda x, m: x.index_select(
        axis, torch.nonzero(m.reshape(-1) != 0).reshape(-1)), data, index)


def _scatter_index(idx):
    if not (idx.dtype == torch.bool or not idx.is_floating_point()):
        idx = idx.to(torch.int64)   # float indices, the default dtype
    if idx.dim() == 2 and idx.dtype != torch.bool:  # coordinate rows
        return tuple(idx.long().T)
    return (idx if idx.dtype == torch.bool else idx.long(),)


def index_update(data, indices, val):
    """``data`` with ``data[indices]`` set to ``val``, out of place: an
    (N, k) int array of coordinates, or indices (or a mask) of axis 0."""
    return apply_op(lambda x, i, v: x.index_put(
        _scatter_index(i), torch.as_tensor(v, dtype=x.dtype,
                                           device=x.device)),
        data, indices, val)


def index_add(data, indices, val):
    """``data`` with ``val`` added at ``indices``, out of place."""
    return apply_op(lambda x, i, v: x.index_put(
        _scatter_index(i), torch.as_tensor(v, dtype=x.dtype,
                                           device=x.device),
        accumulate=True), data, indices, val)


def _tensor(x):
    return x._data if isinstance(x, NDArray) else torch.as_tensor(x)


def nonzero(data):
    """The (N, ndim) int64 coordinates of the non-zero elements."""
    return NDArray(torch.nonzero(_tensor(data)).to(torch.int64))


def constraint_check(condition, msg="Constraint violated"):
    """Raise ``ValueError(msg)`` unless every element holds, else a
    ``(1,)`` f32 one (the probability module's validation op)."""
    cond_ = _tensor(condition)
    if not bool(cond_.all()):
        raise ValueError(msg)
    return NDArray(torch.ones((1,), dtype=torch.float32,
                              device=cond_.device))


def _over_ndarrays(fn):
    """``fn`` for the registry: the tensors ``make_eager`` hands it, also
    those in a list of loop variables, become NDArrays again (the
    control-flow bodies take NDArrays)."""

    def wrap(a):
        if isinstance(a, torch.Tensor):
            return NDArray(a)
        if isinstance(a, (list, tuple)):
            return type(a)(wrap(v) for v in a)
        return a

    def call(*args, **kwargs):
        return fn(*[wrap(a) for a in args], **kwargs)
    call.__name__ = call.__qualname__ = fn.__name__
    return call


# the registry's internal spellings of the npx functions (aliases.py)
for _name, _fn in (("_npx_reshape", reshape), ("_npx_nonzero", nonzero),
                   ("_npx_index_add", index_add),
                   ("_npx_index_update", index_update),
                   ("_scatter_set_nd", index_update),
                   ("_npx_constraint_check", constraint_check),
                   ("_contrib_arange_like", arange_like),
                   ("_npx_foreach", _over_ndarrays(foreach)),
                   ("_foreach", _over_ndarrays(foreach)),
                   ("_npx_while_loop", _over_ndarrays(while_loop)),
                   ("_while_loop", _over_ndarrays(while_loop)),
                   ("_npx_cond", _over_ndarrays(cond)),
                   ("_cond", _over_ndarrays(cond))):
    register_op(_name, _fn)
del _name, _fn

populate(globals())

from . import random  # noqa: E402,F401 - needs bernoulli et al. above
