"""Tensor ops over ``torch.Tensor`` (counterpart of the subset of
mxnet_tpu/ops/tensor.py that the NDArray frontends call).

Two families:

* numpy-semantics reductions and scans (:data:`NP_REDUCE`, :func:`cumulate`),
  shared by ``mx.np`` and the NDArray methods: ``axis`` None, an int or a
  tuple, ``keepdims``, ``ddof``. Result dtypes are the JAX package's,
  which runs with 64-bit types on: integer sums, products and indices are
  int64 (uint64 for unsigned ints), integer scans keep their dtype, means
  of integers are float32 (float64 of int64: ``promote.inexact``);
  ``median`` and ``quantile`` interpolate as numpy does (torch's
  ``median`` takes the lower middle value);
* the legacy ``mx.nd`` operators, registered by name
  (:func:`..registry.register_op`): elementwise unary and binary and the
  ``broadcast_*`` family (comparisons return the left operand's dtype),
  reductions with ``exclude``, ``argmax``/``argmin`` as float indices, the
  reshape codes 0/-1/-2/-3/-4, ``transpose``, ``slice``, ``take``, ``clip``,
  ``concat``, ``stack``, ``split``, ``dot``, ``batch_dot``, ``cast``,
  ``pad`` and ``depth_to_space``.

Every function is differentiable through torch autograd where its math is.
"""
from __future__ import annotations

import builtins
import math

import torch
import torch.nn.functional as F

from ..base import normalize_dtype
from . import promote as _promote
from .registry import _OPS, register_op

__all__ = ["NP_REDUCE", "cumulate", "legacy_reshape_shape", "int_default",
           "np_axes", "np_dot", "cbrt"]


# ---------------------------------------------------------------------------
# numpy-semantics reductions (mx.np and the NDArray methods)
# ---------------------------------------------------------------------------

def np_axes(ndim, axis):
    """numpy's ``axis`` as a sorted tuple of non-negative dims."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(sorted(int(a) % ndim for a in axis)) if ndim else ()


def int_default(out, x):
    """An int64 result of an int32 (or narrower) input comes back in the
    input's dtype, where the JAX package keeps it (scans, searchsorted)."""
    if out.dtype == torch.int64 and x.dtype != torch.int64 \
            and not x.is_floating_point() and x.dtype != torch.bool:
        return out.to(x.dtype)
    return out


def _over_last(x, axis, keepdims, fn):
    """Apply ``fn``, which reduces its argument's last dim, over ``axis``
    of ``x``: the reduced dims are moved last and merged into one."""
    ax = np_axes(x.dim(), axis)
    rest = [d for d in range(x.dim()) if d not in ax]
    n = math.prod(x.shape[d] for d in ax)
    t = x.permute(*rest, *ax).reshape(*[x.shape[d] for d in rest], n) \
        if x.dim() else x.reshape(1)
    out = fn(t)
    if keepdims:
        out = out.reshape([1 if d in ax else x.shape[d]
                           for d in range(x.dim())])
    return out


_floating = _promote.inexact


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _reducer(fn, *, to_float=False, accumulates=False):
    def reduce(a, axis=None, dtype=None, keepdims=False, **kwargs):
        if dtype is not None:
            a = a.to(normalize_dtype(dtype))
        elif to_float:
            a = _floating(a)
        out = _over_last(a, axis, keepdims, lambda t: fn(t, **kwargs))
        if accumulates and a.dtype in _UNSIGNED:
            # the JAX package sums unsigned ints in uint64; torch has no
            # uint64 sum, so the int64 one is cast
            out = out.to(torch.uint64)
        return out
    return reduce


def _index_reducer(fn):
    def reduce(a, axis=None, keepdims=False):
        if a.dtype == torch.bool:   # torch's argmax takes no bool
            a = a.to(torch.uint8)
        return _over_last(a, axis, keepdims, fn)
    return reduce


def _nan_fill(t, value):
    if not t.is_floating_point():
        return t
    return torch.where(torch.isnan(t), torch.full_like(t, value), t)


def _nanext(t, largest):
    if not t.is_floating_point():   # no nan to skip
        return t.amax(-1) if largest else t.amin(-1)
    m = _nan_fill(t, -math.inf if largest else math.inf)
    m = m.amax(-1) if largest else m.amin(-1)
    return torch.where(torch.isnan(t).all(-1), torch.full_like(m, math.nan),
                       m)


def _nanvar(t, ddof=0):
    ok = ~torch.isnan(t)
    n = ok.sum(-1)
    mean = torch.nansum(t, -1) / n
    dev = torch.where(ok, t - mean.unsqueeze(-1), torch.zeros_like(t))
    return (dev * dev).sum(-1) / (n - ddof)


def _var(t, ddof=0):
    return t.var(-1, correction=ddof)


def _median(t):
    return torch.quantile(t, 0.5, dim=-1)


def _nanmedian(t):
    return torch.nanquantile(t, 0.5, dim=-1)


def _quantile(name, scale, nan):
    qfn = torch.nanquantile if nan else torch.quantile

    def quantile(a, q, axis=None, method="linear", keepdims=False,
                 interpolation=None):
        a = _floating(a)
        q = torch.as_tensor(q, dtype=a.dtype, device=a.device) / scale
        out = _over_last(a, axis, False, lambda t: qfn(
            t, q, dim=-1, interpolation=interpolation or method))
        if keepdims:
            kept = [1 if d in np_axes(a.dim(), axis) else a.shape[d]
                    for d in range(a.dim())]
            out = out.reshape(tuple(q.shape) + tuple(kept))
        return out

    quantile.__name__ = name
    return quantile


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _floating(a)
    if weights is None:
        avg = _over_last(a, axis, keepdims, lambda t: t.mean(-1))
        wsum = torch.full_like(avg, a.numel() / max(avg.numel(), 1))
    else:
        w = torch.as_tensor(weights, device=a.device)
        dt = torch.promote_types(a.dtype, w.dtype)
        a, w = a.to(dt), w.to(dt)
        if w.dim() == 1 and a.dim() > 1:
            shape = [1] * a.dim()
            shape[int(axis) % a.dim()] = -1
            w = w.reshape(shape)
        w = w.expand_as(a)
        wsum = _over_last(w, axis, keepdims, lambda t: t.sum(-1))
        avg = _over_last(a * w, axis, keepdims, lambda t: t.sum(-1)) / wsum
    return (avg, wsum) if returned else avg


def _count_nonzero(a, axis=None, keepdims=False):
    return _over_last(a != 0, axis, keepdims, lambda t: t.sum(-1))


#: mx.np's reductions by name, numpy semantics over tensors
NP_REDUCE = {
    "sum": _reducer(lambda t: t.sum(-1), accumulates=True),
    "prod": _reducer(lambda t: t.prod(-1), accumulates=True),
    "mean": _reducer(lambda t: t.mean(-1), to_float=True),
    "max": _reducer(lambda t: t.amax(-1)),
    "min": _reducer(lambda t: t.amin(-1)),
    "amax": _reducer(lambda t: t.amax(-1)),
    "amin": _reducer(lambda t: t.amin(-1)),
    "ptp": _reducer(lambda t: t.amax(-1) - t.amin(-1)),
    "all": _reducer(lambda t: t.bool().all(-1)),
    "any": _reducer(lambda t: t.bool().any(-1)),
    "std": _reducer(lambda t, ddof=0: _var(t, ddof).sqrt(), to_float=True),
    "var": _reducer(_var, to_float=True),
    "median": _reducer(_median, to_float=True),
    "nansum": _reducer(lambda t: torch.nansum(t, -1), accumulates=True),
    "nanprod": _reducer(lambda t: _nan_fill(t, 1.0).prod(-1), accumulates=True),
    "nanmean": _reducer(lambda t: torch.nanmean(t, -1), to_float=True),
    "nanmax": _reducer(lambda t: _nanext(t, True)),
    "nanmin": _reducer(lambda t: _nanext(t, False)),
    "nanstd": _reducer(lambda t, ddof=0: _nanvar(t, ddof).sqrt(),
                       to_float=True),
    "nanvar": _reducer(_nanvar, to_float=True),
    "nanmedian": _reducer(_nanmedian, to_float=True),
    "argmax": _index_reducer(lambda t: t.argmax(-1)),
    "argmin": _index_reducer(lambda t: t.argmin(-1)),
    "nanargmax": _index_reducer(
        lambda t: _nan_fill(t, -math.inf).argmax(-1)),
    "nanargmin": _index_reducer(
        lambda t: _nan_fill(t, math.inf).argmin(-1)),
    "count_nonzero": _count_nonzero,
    "average": _average,
    "quantile": _quantile("quantile", 1.0, False),
    "percentile": _quantile("percentile", 100.0, False),
    "nanquantile": _quantile("nanquantile", 1.0, True),
    "nanpercentile": _quantile("nanpercentile", 100.0, True),
}


def np_dot(a, b):
    """numpy's ``dot``: a product of scalars, a matrix product up to 2-D, and
    above that a sum over ``a``'s last and ``b``'s second-to-last axis."""
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or (a.dim() <= 2 and b.dim() <= 2):
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def cumulate(name):
    """numpy's ``cumsum``/``cumprod`` (and their nan forms): ``axis`` None
    scans the flattened array."""
    op = torch.cumsum if "sum" in name else torch.cumprod
    nan_to = (0.0 if "sum" in name else 1.0) if name.startswith("nan") \
        else None

    def scan(a, axis=None, dtype=None):
        if dtype is not None:
            a = a.to(normalize_dtype(dtype))
        t = a.reshape(-1) if axis is None else a
        if nan_to is not None and t.is_floating_point():
            t = _nan_fill(t, nan_to)
        return int_default(op(t, 0 if axis is None else int(axis)), a)

    scan.__name__ = name
    return scan


# ---------------------------------------------------------------------------
# legacy mx.nd operators (registered)
# ---------------------------------------------------------------------------

def cbrt(x):
    """The real cube root, negative inputs too; the sign is copied, so
    -0.0 gives -0.0 (and ``rcbrt`` -inf) as ``jnp.cbrt`` does."""
    return torch.copysign(torch.abs(x).pow(1.0 / 3.0), x)


def digamma(x):
    """``torch.digamma`` with nan at the pole x = 0 of either sign, as
    ``jax.scipy.special.digamma`` gives (torch gives -inf at +0, +inf at
    -0)."""
    return torch.where(x == 0, torch.full_like(x, float("nan")),
                       torch.digamma(x))


_add = _promote.binary(torch.add)
_multiply = _promote.binary(torch.mul)
_divide = _promote.binary(torch.true_divide, "inexact")
_abs = _promote.bool_same(torch.abs)

#: float functions: an int or bool input computes in promote.inexact_dtype
_FLOAT = {
    "sqrt": torch.sqrt, "cbrt": cbrt,
    "rcbrt": lambda x: 1.0 / cbrt(x),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)), "gammaln": torch.lgamma,
    "digamma": digamma, "erf": torch.erf, "erfinv": torch.erfinv,
}

_UNARY = {name: _promote.float_fn(fn) for name, fn in _FLOAT.items()}
_UNARY.update({
    # the JAX package refuses int and bool inputs to these (promote note)
    "rsqrt": _promote.float_only(torch.rsqrt, "rsqrt"),
    "sigmoid": _promote.float_only(torch.sigmoid, "sigmoid"),
    "log_sigmoid": _promote.no_bool(_promote.float_fn(F.logsigmoid),
                                    "log_sigmoid"),
    "sign": _promote.no_bool(torch.sign, "sign"),
    "abs": _abs,
    "rint": _promote.default_float(torch.round), "round": torch.round,
    "ceil": _promote.bool_same(torch.ceil),
    "floor": _promote.bool_same(torch.floor),
    "trunc": _promote.bool_same(torch.trunc),
    "fix": _promote.bool_same(torch.trunc),
    "square": lambda x: torch.square(x.to(_promote.numeric_dtype(x.dtype))),
    "reciprocal": lambda x: _divide(1.0, x), "negative": torch.neg,
    "logical_not": lambda x: (x == 0).to(x.dtype), "relu": _promote.relu,
    # the JAX package's x / (1 + |x|): a bool input meets the weak 1
    "softsign": lambda x: _divide(x, _add(1, _abs(x))),
    "identity": lambda x: x.clone(),
})

for _name, _fn in _UNARY.items():
    register_op(_name, _fn)


@register_op("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    """``alpha * x + beta`` clipped to [0, 1] (tensor.py:hard_sigmoid)."""
    return torch.clamp(_add(_multiply(alpha, x), beta), 0.0, 1.0)


def _both(fn):
    # torch's comparisons want a tensor on each side; a Python scalar
    # becomes a 0-dim tensor, which promotes like numpy's weak scalar
    def binary(lhs, rhs):
        if not isinstance(lhs, torch.Tensor):
            lhs = torch.as_tensor(lhs, device=rhs.device)
        if not isinstance(rhs, torch.Tensor):
            rhs = torch.as_tensor(rhs, device=lhs.device)
        return fn(lhs, rhs)
    binary.__name__ = getattr(fn, "__name__", "binary")
    return binary


#: name -> (function over tensors of one dtype, promote kind)
_BINARY = {
    "elemwise_add": (torch.add, "same"), "elemwise_sub": (torch.sub, "same"),
    "elemwise_mul": (torch.mul, "same"),
    "elemwise_div": (torch.true_divide, "inexact"),
    "broadcast_add": (torch.add, "same"),
    "broadcast_plus": (torch.add, "same"),
    "broadcast_sub": (torch.sub, "same"),
    "broadcast_minus": (torch.sub, "same"),
    "broadcast_mul": (torch.mul, "same"),
    "broadcast_div": (torch.true_divide, "inexact"),
    "broadcast_mod": (torch.remainder, "numeric"),
    "broadcast_power": (torch.pow, "power"),
    "broadcast_maximum": (torch.maximum, "same"),
    "broadcast_minimum": (torch.minimum, "same"),
    "broadcast_hypot": (torch.hypot, "inexact"),
    "hypot": (torch.hypot, "inexact"),
}

_BINARY_CMP = {
    "broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt, "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}


def _cmp(fn):
    # legacy comparisons return the lhs dtype (0/1 valued), not bool
    def compare(lhs, rhs):
        dtype = lhs.dtype if isinstance(lhs, torch.Tensor) else torch.float32
        return _both(fn)(lhs, rhs).to(dtype)
    compare.__name__ = fn.__name__
    return compare


for _name, (_fn, _kind) in _BINARY.items():
    register_op(_name, _promote.binary(_fn, _kind))
for _name, _fn in _BINARY_CMP.items():
    register_op(_name, _cmp(_fn))


@register_op("add_n")
def add_n(*args):
    """Sum of n arrays (tensor.py:add_n)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _legacy_axes(axis, ndim, exclude=False):
    if axis is None or axis == ():
        return None
    axes = np_axes(ndim, axis)
    if exclude:
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _legacy_reduce(name):
    fn = NP_REDUCE[name]

    def reduce(data, axis=None, keepdims=False, exclude=False):
        return fn(data, axis=_legacy_axes(axis, data.dim(), exclude),
                  keepdims=keepdims)
    reduce.__name__ = name
    return register_op(name, reduce)


for _name in ("sum", "nansum", "prod", "nanprod", "mean", "max", "min"):
    _legacy_reduce(_name)
register_op("sum_axis", _legacy_reduce("sum"))
register_op("max_axis", _legacy_reduce("max"))
register_op("min_axis", _legacy_reduce("min"))


@register_op("norm")
def norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    """L1 or L2 norm over ``axis`` or everything (tensor.py:norm)."""
    dims = None if axis is None else np_axes(data.dim(), axis)
    if ord == 1:
        return data.abs().sum(dim=dims, keepdim=keepdims)
    return _promote.inexact(
        data.square().sum(dim=dims, keepdim=keepdims)).sqrt()


@register_op("argmax")
def argmax(data, axis=None, keepdims=False):
    """Float indices, as the reference returns them."""
    return NP_REDUCE["argmax"](data, axis, keepdims).to(torch.float32)


@register_op("argmin")
def argmin(data, axis=None, keepdims=False):
    return NP_REDUCE["argmin"](data, axis, keepdims).to(torch.float32)


@register_op("sort")
def sort(data, axis=-1, is_ascend=True):
    return torch.sort(data, dim=axis, descending=not is_ascend,
                      stable=True).values


@register_op("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(normalize_dtype(dtype))


@register_op("take")
def take(a, indices, axis=0, mode="clip"):
    """Rows of ``a`` along ``axis``; out-of-range indices clip or wrap."""
    n = a.shape[axis]
    idx = indices.long()
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx % n
    out = a.movedim(axis, 0)[idx]
    return out.movedim(tuple(range(idx.dim())),
                       tuple(range(axis, axis + idx.dim())))


@register_op("where")
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


def legacy_reshape_shape(src, target, reverse=False):
    """Resolve MXNet's reshape codes (matrix_op-inl.h InferReshapeShape):
    0 copies a dim, -1 infers one, -2 copies the rest, -3 merges two, -4
    splits one into the next two entries (tensor.py:legacy_reshape_shape)."""
    src = list(src)
    target = list(target)
    if reverse:
        src = src[::-1]
        target = target[::-1]
    out = []
    i = j = 0
    while j < len(target):
        t = target[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            if j + 2 >= len(target):
                raise ValueError(
                    "-4 needs two following entries in the (possibly "
                    f"reversed) target shape, got {target[j:]}")
            a, b = target[j + 1], target[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            if a * b != src[i]:
                raise ValueError(
                    f"split dims ({a}, {b}) do not divide source dim "
                    f"{src[i]}")
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(t)
            i += 1
        j += 1
    if -1 in out:
        known = math.prod(d for d in out if d != -1)
        out[out.index(-1)] = math.prod(src) // known
    if reverse:
        out = out[::-1]
    return tuple(out)


@register_op("reshape")
def reshape(data, shape=None, reverse=False):
    return data.reshape(legacy_reshape_shape(data.shape, shape, reverse))


@register_op("reshape_like")
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """``lhs`` in ``rhs``'s shape, or with ``lhs.shape[lhs_begin:lhs_end]``
    replaced by ``rhs.shape[rhs_begin:rhs_end]``."""
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)
    lb = lhs_begin or 0
    le = lhs_end if lhs_end is not None else lhs.dim()
    rb = rhs_begin or 0
    re_ = rhs_end if rhs_end is not None else rhs.dim()
    shape = tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_]) \
        + tuple(lhs.shape[le:])
    return lhs.reshape(shape)


@register_op("flatten")
def flatten(data):
    """(N, everything else), as the legacy Flatten does."""
    return data.reshape(data.shape[0], -1)


@register_op("transpose")
def transpose(data, axes=None):
    axes = tuple(axes) if axes else tuple(range(data.dim() - 1, -1, -1))
    return data.permute(*axes)


@register_op("expand_dims")
def expand_dims(data, axis):
    return data.unsqueeze(axis)


@register_op("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(np_axes(data.dim(), axis))


@register_op("slice")
def slice(data, begin, end, step=None):  # noqa: A001
    """None entries of begin/end/step take the whole range."""
    step = step or (None,) * len(begin)
    idx = tuple(builtins.slice(b, e, s) for b, e, s in zip(begin, end, step))
    return data[idx]


@register_op("slice_axis")
def slice_axis(data, axis, begin, end):
    idx = [builtins.slice(None)] * data.dim()
    idx[axis] = builtins.slice(begin, end)
    return data[tuple(idx)]


@register_op("clip")
def clip(data, a_min=None, a_max=None):
    """Without bounds the values come back unchanged, as in the JAX
    package."""
    if a_min is None and a_max is None:
        return data.clone()
    return torch.clamp(data, a_min, a_max)


@register_op("repeat")
def repeat(data, repeats, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register_op("tile")
def tile(data, reps):
    return torch.tile(data, tuple(reps) if not isinstance(reps, int)
                      else (reps,))


@register_op("reverse")
def reverse(data, axis=0):
    return torch.flip(data, np_axes(data.dim(), axis))


register_op("flip", reverse)


@register_op("cast")
def cast(data, dtype):
    return data.to(normalize_dtype(dtype))


@register_op("swapaxes")
def swapaxes(data, dim1=0, dim2=1):
    return data.transpose(dim1, dim2)


@register_op("depth_to_space")
def depth_to_space(data, block_size):
    """(N, C, H, W) -> (N, C / b^2, H * b, W * b), DCR order
    (ops/tensor.py:533)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _pad_index(n, before, after, mode, device):
    """Source indices of a dim of ``n`` padded by (before, after): numpy's
    ``reflect`` (the edge not repeated, reflecting again past the far
    edge) or ``edge``."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


@register_op("pad")
def pad(data, mode="constant", pad_width=None, constant_value=0.0):
    """Pad every dim by the flat ``(before, after)`` list ``pad_width``
    (ops/tensor.py:571): ``constant`` with ``constant_value``, ``reflect``
    as ``jnp.pad``'s (the edge not repeated) or, in any other mode, the
    edge value repeated. Reflect and edge pads gather along each padded
    dim, so the gradient reaches the sources."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [v for lo_hi in reversed(pw) for v in lo_hi]
        return F.pad(data, flat, value=constant_value)
    out = data
    for dim, (lo, hi) in enumerate(pw):
        if lo or hi:
            idx = _pad_index(out.shape[dim], lo, hi,
                             "reflect" if mode == "reflect" else "edge",
                             out.device)
            out = out.index_select(dim, idx)
    return out


@register_op("stack")
def stack(*data, axis=0):
    return torch.stack(data, dim=axis)


@register_op("concat")
def concat(*data, dim=1):
    return torch.cat(data, dim=dim)


@register_op("split")
def split(data, num_outputs, axis=1, squeeze_axis=False):
    """Equal sections along ``axis`` (the legacy SliceChannel)."""
    if data.shape[axis] % num_outputs:
        raise ValueError(f"{num_outputs} sections do not divide axis "
                         f"{axis} of {tuple(data.shape)}")
    outs = torch.tensor_split(data, num_outputs, dim=axis)
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs)


@register_op("broadcast_to")
def broadcast_to(data, shape):
    shape = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.expand(shape)


@register_op("broadcast_axis")
def broadcast_axis(data, axis=None, size=None):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return data.expand(shape)


register_op("broadcast_axes", broadcast_axis)


@register_op("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a and lhs.dim() > 1:
        lhs = lhs.transpose(-1, -2)
    if transpose_b and rhs.dim() > 1:
        rhs = rhs.transpose(-1, -2)
    return np_dot(lhs, rhs)


@register_op("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register_op("BlockGrad")
def stop_gradient(data):
    return data.detach()


register_op("stop_gradient", stop_gradient)


# ---------------------------------------------------------------------------
# the rest of ops/tensor.py's registrations: indexing, shape, windows
# ---------------------------------------------------------------------------

@register_op("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """Huber-like smooth L1 with ``sigma = scalar`` (tensor.py:149)."""
    s2 = scalar * scalar
    a = data.abs()
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data.square(), a - 0.5 / s2)


@register_op("argmax_channel")
def argmax_channel(data):
    """Float indices of the largest along axis 1 (tensor.py:212)."""
    return argmax(data, axis=1)


@register_op("batch_take")
def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]``, the indices clipped (tensor.py:253)."""
    idx = indices.to(torch.int64).clamp(0, a.shape[1] - 1)
    return torch.take_along_dim(a, idx[:, None], dim=1)[:, 0]


@register_op("choose_element_0index")
def choose_element_0index(lhs, rhs):
    """``out[i] = lhs[i, rhs[i]]`` with float indices (tensor.py:495)."""
    idx = rhs.to(torch.int64)
    return torch.take_along_dim(lhs, idx[:, None], dim=1)[:, 0]


@register_op("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """``lhs`` with ``lhs[i, rhs[i]] = mhs[i]``, out of place
    (tensor.py:504)."""
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, rhs.to(torch.int64)), mhs.to(lhs.dtype))


def _nd_index(indices):
    idx = indices.to(torch.int64)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register_op("gather_nd")
def gather_nd(data, indices):
    """``indices`` (M, ...) select along the first M dims of ``data``
    (tensor.py:260)."""
    return data[_nd_index(indices)]


@register_op("scatter_nd")
def scatter_nd(data, indices, shape):
    """A zero array of ``shape`` with ``data`` set at ``indices``
    (tensor.py:269)."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data)


@register_op("ravel_multi_index")
def ravel_multi_index(data, shape):
    """(ndim, n) coordinates to flat indices, as float32 (tensor.py:278)."""
    idx = data.to(torch.int32)
    out = torch.zeros(tuple(idx.shape[1:]), dtype=torch.int32,
                      device=idx.device)
    for i, s in enumerate(shape):
        out = out * s + idx[i]
    return out.to(torch.float32)


@register_op("unravel_index")
def unravel_index(data, shape):
    """Flat indices to (ndim, n) coordinates, as float32 (tensor.py:288)."""
    idx = data.to(torch.int32)
    coords = []
    for s in reversed(shape):
        coords.append(idx % s)
        idx = idx // s
    return torch.stack(coords[::-1]).to(torch.float32)


register_op("_ravel_multi_index", ravel_multi_index)
register_op("_unravel_index", unravel_index)


@register_op("diag")
def diag(data, k=0, axis1=0, axis2=1):
    """A diagonal matrix of a vector, or the ``k``-th diagonal of
    ``data`` over (axis1, axis2) (tensor.py:298)."""
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


@register_op("trace")
def trace(data, offset=0, axis1=0, axis2=1):
    """The sum of a diagonal (tensor.py:803); an int sum is int64."""
    d = torch.diagonal(data, offset=offset, dim1=axis1, dim2=axis2)
    return NP_REDUCE["sum"](d, axis=-1)


@register_op("slice_like")
def slice_like(data, shape_like, axes=None):
    """``data`` cut to ``shape_like``'s extent on ``axes`` (default: the
    dims both have) (tensor.py:436)."""
    idx = [builtins.slice(None)] * data.dim()
    axes = axes if axes else range(builtins.min(data.dim(),
                                                shape_like.dim()))
    for ax in axes:
        idx[ax] = builtins.slice(0, shape_like.shape[ax])
    return data[tuple(idx)]


@register_op("broadcast_like")
def broadcast_like(lhs, rhs):
    """``lhs`` broadcast to ``rhs``'s shape (tensor.py:809)."""
    return lhs.expand(rhs.shape)


@register_op("arange_like")
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """float32 ``start + step * i`` shaped like ``data`` (or as long as its
    ``axis``), each value ``repeat`` times (tensor.py:815)."""
    n = data.shape[axis] if axis is not None else data.numel()
    count = -(-n // repeat) if repeat > 1 else n
    out = torch.arange(count, dtype=torch.float32,
                       device=data.device) * step + start
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)[:n]
    return out.reshape(data.shape) if axis is None else out


@register_op("histogram")
def histogram(data, bins=None, bin_cnt=None, range=None):  # noqa: A002
    """``(counts int64, edges)`` (tensor.py:469): an array ``bins`` gives
    the edges; an int count needs ``range``, its edges from float64 on the
    host cast to the data's dtype. Each bin is closed on the left, the
    last on both sides; values outside are not counted."""
    if isinstance(bins, torch.Tensor):
        edges = bins
    else:
        n = bin_cnt if bin_cnt is not None else (bins or 10)
        if range is None:
            raise ValueError(
                "histogram with an integer bin count requires range= "
                "(reference histogram.cc contract)")
        import numpy as onp

        edges = torch.as_tensor(onp.linspace(range[0], range[1],
                                             int(n) + 1),
                                dtype=data.dtype, device=data.device)
    x = data.reshape(-1).to(edges.dtype)
    nb = edges.numel() - 1
    idx = torch.bucketize(x, edges, right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, nb - 1), idx)
    valid = (x >= edges[0]) & (x <= edges[-1])
    counts = torch.bincount(idx[valid], minlength=nb)[:nb]
    return counts.to(torch.int64), edges


@register_op("shape_array")
def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@register_op("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


@register_op("space_to_depth")
def space_to_depth(data, block_size):
    """(N, C, H, W) -> (N, C * b^2, H / b, W / b) (tensor.py:543), the
    inverse of ``depth_to_space``."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register_op("khatri_rao")
def khatri_rao(*args):
    """Column-wise Kronecker product (tensor.py:625)."""
    out = args[0]
    for b in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, b).reshape(-1, out.shape[1])
    return out


register_op("cumsum", cumulate("cumsum"))


@register_op("relu6")
def relu6(data):
    """``min(max(x, 0), 6)`` (tensor.py:829), its gradient split at the
    ties as ``jnp.clip``'s."""
    return torch.minimum(torch.maximum(data, data.new_zeros(())),
                         data.new_full((), 6))


@register_op("mish")
def mish(data):
    return data * torch.tanh(F.softplus(data))


@register_op("silu")
def silu(data):
    return F.silu(data)


def _nd_tuple(v, nd, default):
    v = default if v is None else v
    return (v,) * nd if isinstance(v, int) else tuple(v)


def _windows(x, kernel, stride, dilate):
    """(N, C, *L, *k) sliding windows of a padded (N, C, *spatial)
    tensor."""
    nd = len(kernel)
    for i, (k, s, d) in enumerate(zip(kernel, stride, dilate)):
        x = x.unfold(2 + i, (k - 1) * d + 1, s)
        if d > 1:
            x = x[..., ::d]
    # unfold appends each window dim last: (N, C, *L, *k) already
    return x, x.shape[2:2 + nd]


@register_op("im2col")
def im2col(data, kernel, stride=None, dilate=None, pad=None):
    """(N, C, *spatial) -> (N, C * prod(kernel), L) columns of the
    sliding windows, channel-major (tensor.py:845)."""
    nd = data.dim() - 2
    kernel = _nd_tuple(kernel, nd, 1)
    stride = _nd_tuple(stride, nd, 1)
    dilate = _nd_tuple(dilate, nd, 1)
    pad = _nd_tuple(pad, nd, 0)
    xp = F.pad(data, [p for q in reversed(pad) for p in (q, q)])
    win, out_sp = _windows(xp, kernel, stride, dilate)
    n, c = data.shape[:2]
    perm = (0, 1) + tuple(range(2 + nd, 2 + 2 * nd)) + tuple(range(2,
                                                                   2 + nd))
    return win.permute(perm).reshape(n, c * math.prod(kernel),
                                     math.prod(out_sp))


@register_op("col2im")
def col2im(data, output_size, kernel, stride=None, dilate=None, pad=None):
    """The adjoint of :func:`im2col` (tensor.py:872): each column entry is
    added back onto the image position it was read from."""
    nd = len(output_size)
    kernel = _nd_tuple(kernel, nd, 1)
    stride = _nd_tuple(stride, nd, 1)
    dilate = _nd_tuple(dilate, nd, 1)
    pad = _nd_tuple(pad, nd, 0)
    n = data.shape[0]
    c = data.shape[1] // math.prod(kernel)
    padded = tuple(s + 2 * p for s, p in zip(output_size, pad))
    where = torch.arange(c * math.prod(padded), device=data.device).reshape(
        (1, c) + padded)
    win, out_sp = _windows(where, kernel, stride, dilate)
    perm = (0, 1) + tuple(range(2 + nd, 2 + 2 * nd)) + tuple(range(2,
                                                                   2 + nd))
    idx = win.permute(perm).reshape(-1)
    flat = torch.zeros((n, c * math.prod(padded)), dtype=data.dtype,
                       device=data.device)
    flat = flat.index_add(1, idx, data.reshape(n, -1))
    img = flat.reshape((n, c) + padded)
    for i, (s, p) in enumerate(zip(output_size, pad)):
        img = img.narrow(2 + i, p, s)
    return img


# ---------------------------------------------------------------------------
# the loss-output ops: forward as written, backward the reference's fixed
# gradient whatever the head gradient (tensor.py:658-790)
# ---------------------------------------------------------------------------

class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        ctx.meta = (data.shape, data.dtype, data.device)
        return data.clone()

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004 - the head gradient is ignored
        shape, dtype, device = ctx.meta
        return torch.full(shape, ctx.grad_scale, dtype=dtype,
                          device=device), None


@register_op("make_loss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0,
              normalization="null"):  # noqa: ARG001
    """Forward identity; backward ``grad_scale`` everywhere, whatever the
    head gradient (tensor.py:675)."""
    return _MakeLoss.apply(data, grad_scale)


register_op("MakeLoss", make_loss)


def _one_hot_class_axis(label, out):
    """The one-hot of ``label`` over ``out``'s axis 1."""
    lab = label.to(torch.int64)
    oh = (lab.unsqueeze(-1) == torch.arange(out.shape[1],
                                             device=out.device)).to(out.dtype)
    return oh.movedim(-1, 1) if out.dim() > 2 else oh


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore):
        out = torch.softmax(data, dim=1)
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, ignore_label, use_ignore)
        return out

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004 - the head gradient is ignored
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore = ctx.args
        grad = out - _one_hot_class_axis(label, out)
        if use_ignore:
            keep = (label.to(torch.int64) != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(1)
        return grad * grad_scale, None, None, None, None


@register_op("SoftmaxOutput")
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1,
                   use_ignore=False, multi_output=False,  # noqa: ARG001
                   normalization="null", **kwargs):  # noqa: ARG001
    """Softmax over axis 1; backward ``(p - onehot(label)) * grad_scale``
    whatever the head gradient, rows whose label is ``ignore_label``
    zeroed under ``use_ignore`` (tensor.py:713). ``normalization`` is
    accepted and, as in the JAX package, scales nothing."""
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore)


register_op("softmax_output", softmax_output)


class _RegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004 - the head gradient is ignored
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.args
        diff = out - label.reshape(out.shape).to(out.dtype)
        grad = torch.sign(diff) if kind == "mae" else diff
        return grad * grad_scale, None, None, None


@register_op("LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0):
    """Identity; backward ``(out - label) * grad_scale`` (tensor.py:750)."""
    return _RegressionOutput.apply(data, label, grad_scale, "linear")


@register_op("LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0):
    """Sigmoid; backward ``(out - label) * grad_scale`` (tensor.py:755)."""
    return _RegressionOutput.apply(data, label, grad_scale, "logistic")


@register_op("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0):
    """Identity; backward ``sign(out - label) * grad_scale``
    (tensor.py:760)."""
    return _RegressionOutput.apply(data, label, grad_scale, "mae")


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.args = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004 - the head gradient is ignored
        x, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.args
        y = 2.0 * _one_hot_class_axis(label, x) - 1.0
        viol = (margin - y * x) > 0
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if use_linear:
            grad = torch.where(viol, -y * reg, zero)
        else:
            grad = torch.where(viol, -2.0 * reg * (margin - y * x) * y, zero)
        return grad.to(x.dtype), None, None, None, None


@register_op("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Identity; backward the hinge loss's gradient, squared unless
    ``use_linear`` (tensor.py:765)."""
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


for _name in ("and", "or", "xor"):
    register_op(f"_npi_logical_{_name}", _OPS[f"broadcast_logical_{_name}"])
