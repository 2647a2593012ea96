"""``mx.np``'s functions (counterpart of mxnet_tpu/numpy/multiarray.py).

The JAX package generates its corpus over ``jax.numpy`` from four name
lists (``_UNARY``, ``_BINARY``, ``_REDUCE``, ``_OTHER``, :113-139). The
same lists generate this one over torch: each name maps to a function over
tensors with numpy's semantics (:data:`_UNARY_FNS` ... :data:`_OTHER_FNS`,
where torch's name or behaviour differs), and :data:`MISSING` lists the
names that have no function here yet. Every generated function unwraps the
NDArrays among its arguments (in lists and tuples too) and runs through
``apply_op``, so it is recorded inside ``autograd.record()``.

The creation functions are written by hand and honor the device scope
(``with mx.cpu():``); outside one they create on ``cuda:0``, or raise
without a card.
"""
from __future__ import annotations

import builtins
import functools

import numpy as _np
import torch

from ..base import normalize_dtype, numpy_dtype
from ..ndarray.ndarray import NDArray, apply_op, creation_device
from ..ndarray.ndarray import array as _nd_array
from ..ops import promote as _promote
from ..ops import tensor as _ops

ndarray = NDArray

pi = _np.pi
e = _np.e
euler_gamma = _np.euler_gamma
inf = _np.inf
nan = _np.nan
newaxis = None

# -- the JAX package's lists (multiarray.py:113-139) ---------------------------
_UNARY = """
abs absolute arccos arccosh arcsin arcsinh arctan arctanh bitwise_invert
bitwise_not cbrt ceil conj conjugate cos cosh degrees exp exp2 expm1 fabs
floor invert isfinite isinf isnan isneginf isposinf log log10 log1p log2
logical_not negative positive radians reciprocal rint sign signbit sin sinh
sqrt square tan tanh trunc angle real imag i0 sinc nan_to_num
acos acosh asin asinh atan atanh deg2rad rad2deg
""".split()

_BINARY = """
add arctan2 bitwise_and bitwise_or bitwise_xor copysign divide equal
float_power floor_divide fmax fmin fmod gcd greater greater_equal heaviside
hypot lcm ldexp left_shift less less_equal logaddexp logaddexp2 logical_and
logical_or logical_xor maximum minimum mod multiply not_equal power remainder
right_shift subtract true_divide divmod pow
atan2 bitwise_left_shift bitwise_right_shift nextafter vecdot
""".split()

_REDUCE = """
all any amax amin argmax argmin cumprod cumsum max mean median min nanargmax
nanargmin nancumprod nancumsum nanmax nanmean nanmedian nanmin nanprod nanstd
nansum nanvar prod ptp std sum var count_nonzero average quantile percentile
""".split()

_OTHER = """
reshape ravel transpose swapaxes moveaxis rollaxis squeeze expand_dims
broadcast_to broadcast_arrays flip fliplr flipud rot90 roll
concatenate stack vstack hstack dstack column_stack split array_split hsplit
vsplit dsplit tile repeat pad
take take_along_axis put_along_axis choose compress extract searchsorted
argsort sort lexsort partition argpartition flatnonzero nonzero argwhere where
diag diagflat diagonal trace tril triu tri eye identity vander
dot vdot inner outer matmul tensordot einsum kron cross
clip round around floor_divide
unique union1d intersect1d setdiff1d setxor1d in1d isin
atleast_1d atleast_2d atleast_3d
meshgrid indices unravel_index ravel_multi_index diag_indices
tril_indices triu_indices
histogram histogram2d histogramdd bincount digitize corrcoef cov
convolve correlate interp gradient diff ediff1d trapezoid
polyval polyfit roots
sort_complex real_if_close
isclose allclose array_equal array_equiv
cumulative_sum
flatnonzero packbits unpackbits
apply_along_axis
nanquantile nanpercentile
insert delete append resize trim_zeros
fill_diagonal
select piecewise
permute_dims matrix_transpose unique_all unique_counts unique_inverse
unique_values
""".split()


#: numpy's float functions: an int or bool input computes in
#: promote.inexact_dtype (float64 from int64, else float32)
_FLOAT_FNS = {
    "arccos": torch.acos, "acos": torch.acos,
    "arccosh": torch.acosh, "acosh": torch.acosh,
    "arcsin": torch.asin, "asin": torch.asin,
    "arcsinh": torch.asinh, "asinh": torch.asinh,
    "arctan": torch.atan, "atan": torch.atan,
    "arctanh": torch.atanh, "atanh": torch.atanh,
    "cbrt": _ops.cbrt, "cos": torch.cos, "cosh": torch.cosh,
    "degrees": torch.rad2deg, "rad2deg": torch.rad2deg,
    "radians": torch.deg2rad, "deg2rad": torch.deg2rad,
    "exp": torch.exp, "exp2": torch.exp2, "expm1": torch.expm1,
    "fabs": torch.abs, "log": torch.log, "log10": torch.log10,
    "log1p": torch.log1p, "log2": torch.log2,
    "reciprocal": torch.reciprocal, "sin": torch.sin, "sinh": torch.sinh,
    "sqrt": torch.sqrt, "tan": torch.tan, "tanh": torch.tanh,
    "i0": torch.i0, "sinc": torch.sinc,
}


def _angle(z, deg=False):
    # numpy's arctan2(imag, real): -0.0 is pi, where torch.angle gives 0
    if not (z.is_floating_point() or z.is_complex()):
        z = z.to(torch.float64)
    out = (torch.angle(z) if z.is_complex()
           else torch.atan2(torch.zeros_like(z), z))
    return torch.rad2deg(out) if deg else out


_UNARY_FNS = {name: _promote.float_fn(fn) for name, fn in _FLOAT_FNS.items()}
_UNARY_FNS.update({
    "abs": _promote.bool_same(torch.abs), "absolute": _promote.bool_same(torch.abs),
    "ceil": _promote.bool_same(torch.ceil), "floor": _promote.bool_same(torch.floor),
    "trunc": _promote.bool_same(torch.trunc),
    "bitwise_invert": torch.bitwise_not, "bitwise_not": torch.bitwise_not,
    "invert": torch.bitwise_not,
    "conj": torch.conj_physical, "conjugate": torch.conj_physical,
    "isfinite": torch.isfinite, "isinf": torch.isinf,
    "isnan": torch.isnan, "isneginf": torch.isneginf,
    "isposinf": torch.isposinf,
    "logical_not": torch.logical_not, "negative": torch.neg,
    "positive": torch.clone, "rint": _promote.default_float(torch.round),
    "sign": _promote.no_bool(torch.sign, "sign"), "signbit": torch.signbit,
    "square": lambda x: torch.square(
        x.to(_promote.numeric_dtype(x.dtype))),
    "angle": _angle,
    "real": torch.clone, "imag": torch.zeros_like,
    "nan_to_num": torch.nan_to_num,
})


def _ldexp(x1, x2):
    # the JAX package's own (multiarray.py:_ldexp_ref): x1 * exp2(x2), with
    # float exponents too; exp2 of a Python number stays a weak float
    e = 2.0 ** x2 if _promote.is_weak(x2) else _UNARY_FNS["exp2"](x2)
    return _BINARY_FNS["multiply"](x1, e)


def _vecdot(a, b, axis=-1):
    if a.is_floating_point() or a.is_complex():
        return torch.linalg.vecdot(a, b, dim=axis)
    return (a * b).sum(axis).to(a.dtype)


#: name -> (function over tensors of one dtype, promote kind)
_PROMOTED = {
    "add": (torch.add, "same"), "subtract": (torch.sub, "same"),
    "multiply": (torch.mul, "same"), "maximum": (torch.maximum, "same"),
    "minimum": (torch.minimum, "same"), "fmax": (torch.fmax, "same"),
    "fmin": (torch.fmin, "same"), "vecdot": (_vecdot, "same"),
    "floor_divide": (torch.floor_divide, "numeric"),
    "mod": (torch.remainder, "numeric"),
    "remainder": (torch.remainder, "numeric"),
    "fmod": (torch.fmod, "numeric"),
    "divmod": (_promote.divmod_pair, "numeric"),
    "left_shift": (torch.bitwise_left_shift, "numeric"),
    "bitwise_left_shift": (torch.bitwise_left_shift, "numeric"),
    "right_shift": (torch.bitwise_right_shift, "numeric"),
    "bitwise_right_shift": (torch.bitwise_right_shift, "numeric"),
    "power": (torch.pow, "power"), "pow": (torch.pow, "power"),
    "divide": (torch.true_divide, "inexact"),
    "true_divide": (torch.true_divide, "inexact"),
    "arctan2": (torch.atan2, "inexact"), "atan2": (torch.atan2, "inexact"),
    "copysign": (torch.copysign, "inexact"),
    "float_power": (torch.pow, "inexact"),
    "heaviside": (torch.heaviside, "inexact"),
    "hypot": (torch.hypot, "inexact"),
    "logaddexp": (torch.logaddexp, "inexact"),
    "logaddexp2": (torch.logaddexp2, "inexact"),
    "nextafter": (torch.nextafter, "inexact"),
}

_BINARY_FNS = {name: _promote.binary(fn, kind)
               for name, (fn, kind) in _PROMOTED.items()}
_BINARY_FNS.update({
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
    "greater_equal": torch.ge, "less": torch.lt, "less_equal": torch.le,
    "gcd": torch.gcd, "lcm": torch.lcm, "ldexp": _ldexp,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
})

_REDUCE_FNS = dict(_ops.NP_REDUCE)
for _name in ("cumsum", "cumprod", "nancumsum", "nancumprod"):
    _REDUCE_FNS[_name] = _ops.cumulate(_name)


# -- _OTHER: shape, joining, indexing, linear algebra, sets --------------------

def _transpose(a, axes=None):
    return a.permute(*(axes if axes is not None
                       else range(a.dim() - 1, -1, -1)))


def _squeeze(a, axis=None):
    return a.squeeze() if axis is None else a.squeeze(
        _ops.np_axes(a.dim(), axis))


def _expand_dims(a, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    nd = a.dim() + len(axes)
    for ax in sorted(x % nd for x in axes):
        a = a.unsqueeze(ax)
    return a


def _rollaxis(a, axis, start=0):
    axis %= a.dim()
    start = start % (a.dim() + 1)
    if start > axis:
        start -= 1
    return torch.movedim(a, axis, start)


def _flip(m, axis=None):
    return torch.flip(m, _ops.np_axes(m.dim(), axis))


def _cast_all(seq, dtype):
    seq = list(seq)
    if dtype is None:
        return seq
    dt = normalize_dtype(dtype)
    return [t.to(dt) for t in seq]


def _concatenate(seq, axis=0, dtype=None):
    seq = _cast_all(seq, dtype)
    if axis is None:
        return torch.cat([t.reshape(-1) for t in seq])
    return torch.cat(seq, dim=axis)


def _stacker(fn):
    def stack(tup, dtype=None):
        return fn(_cast_all(tup, dtype))
    return stack


def _stack(arrays, axis=0, dtype=None):
    return torch.stack(_cast_all(arrays, dtype), dim=axis)


def _reshape(a, newshape=None, order="C", shape=None):
    if (newshape is None) == (shape is None):
        raise TypeError("reshape takes one of newshape and shape")
    shape = newshape if shape is None else shape
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if order == "C":
        return a.reshape(shape)
    if order != "F":
        raise ValueError(f"order must be 'C' or 'F', got {order!r}")
    # column-major: reverse the axes, fill row-major, reverse back
    rev = tuple(range(a.dim() - 1, -1, -1))
    out = a.permute(rev).reshape(shape[::-1])
    return out.permute(tuple(range(out.dim() - 1, -1, -1)))


def _ravel(a, order="C"):
    return _reshape(a, -1, order)


def _split(a, indices_or_sections, axis=0):
    if isinstance(indices_or_sections, int) \
            and a.shape[axis] % indices_or_sections:
        raise ValueError("array split does not result in an equal division")
    return _array_split(a, indices_or_sections, axis)


def _array_split(a, indices_or_sections, axis=0):
    if not isinstance(indices_or_sections, int):
        indices_or_sections = [int(i) for i in indices_or_sections]
    return tuple(torch.tensor_split(a, indices_or_sections, dim=axis))


def _repeat(a, repeats, axis=None):
    return torch.repeat_interleave(a, repeats, dim=axis)


def _pairs(value, nd):
    """numpy's per-axis ``(before, after)`` pairs from a scalar, a pair or
    one pair an axis."""
    arr = _np.asarray(value, dtype=object)
    return [tuple(p) for p in _np.broadcast_to(arr, (nd, 2)).tolist()]


def _pad_reflect(a, ax, before, after, symmetric, odd):
    """``jnp.pad``'s 'reflect' and 'symmetric' along ``ax``, chunk by chunk
    (lax_numpy.py:_pad_symmetric_or_reflect): each chunk mirrors what is
    already there; 'odd' reflects about the edge value."""
    n = a.shape[ax]
    offset = 1 if (not symmetric and n > 1) else 0
    for padding, first in ((before, True), (after, False)):
        edge = a.narrow(ax, 0 if first else a.shape[ax] - 1, 1)
        while padding > 0:
            cur = builtins.min(padding, n - offset)
            padding -= cur
            if first:
                x = a.narrow(ax, offset, cur)
            else:
                stop = a.shape[ax] - (0 if (symmetric or n == 1) else 1)
                x = a.narrow(ax, stop - cur, cur)
            x = x.flip(ax)
            if odd:
                x = 2 * edge - x
                if n > 1:
                    edge = x.narrow(ax, 0 if first else cur - 1, 1)
            a = torch.cat([x, a] if first else [a, x], ax)
    return a


def _pad_ramp(a, ax, before, after, ends):
    """'linear_ramp' along ``ax``: from each end value to the edge, the edge
    excluded, by ``jnp.linspace``'s formula (floored for integers)."""
    dt = _promote.inexact_dtype(a.dtype)
    parts = []
    for num, end, at, first in ((before, ends[0], 0, True),
                                (after, ends[1], a.shape[ax] - 1, False)):
        edge = a.narrow(ax, at, 1).to(dt)
        step = torch.arange(num, dtype=dt, device=a.device) / torch.tensor(
            num, dtype=dt, device=a.device) if num else \
            torch.empty(0, dtype=dt, device=a.device)
        shape = [1] * a.dim()
        shape[ax] = num
        step = step.reshape(shape)
        start = torch.as_tensor(end, dtype=dt, device=a.device)
        ramp = start * (1 - step) + edge * step
        if not (a.is_floating_point() or a.is_complex()):
            ramp = ramp.floor()
        ramp = ramp.to(a.dtype)
        parts.append(ramp if first else ramp.flip(ax))
    return torch.cat([parts[0], a, parts[1]], ax)


_PAD_STATS = {"maximum": lambda t, ax: t.amax(ax, keepdim=True),
              "minimum": lambda t, ax: t.amin(ax, keepdim=True),
              "mean": lambda t, ax: _promote.inexact(t).mean(ax, keepdim=True),
              "median": None}


def _pad_stat(a, ax, before, after, lengths, mode):
    """'maximum', 'minimum', 'mean', 'median' along ``ax``: the statistic
    of the first (last) ``stat_length`` values, rounded for integers."""
    n = a.shape[ax]
    if lengths is None:
        slices = (a, a)
    else:
        lb, la = lengths
        if lb == 0 or la == 0:
            raise ValueError("stat_length of 0 yields no value for padding")
        lb, la = builtins.min(lb, n), builtins.min(la, n)
        slices = (a.narrow(ax, 0, lb), a.narrow(ax, n - la, la))
    stats = []
    for t in slices:
        if mode == "median":
            st = torch.quantile(_promote.inexact(t), 0.5, dim=ax,
                                keepdim=True)
        else:
            st = _PAD_STATS[mode](t, ax)
        if not (a.is_floating_point() or a.is_complex()):
            st = torch.round(st)
        stats.append(st.to(a.dtype))
    rep = [1] * a.dim()
    out = []
    for st, num in zip(stats, (before, after)):
        rep[ax] = num
        out.append(st.repeat(rep))
    return torch.cat([out[0], a, out[1]], ax)


def _pad(array, pad_width, mode="constant", constant_values=0,
         stat_length=None, end_values=0, reflect_type="even"):
    """``jnp.pad`` in every mode: 'constant' (per-axis values too), 'edge',
    'wrap', 'reflect' and 'symmetric' (``reflect_type`` 'even' or 'odd'),
    'linear_ramp' (``end_values``), 'maximum', 'minimum', 'mean',
    'median' (``stat_length``) and 'empty' (zeros, as in the JAX
    package)."""
    nd = array.dim()
    if nd == 0:
        return array
    pw = [(int(b), int(a)) for b, a in _pairs(pad_width, nd)]
    if builtins.any(b < 0 or a < 0 for b, a in pw):
        raise ValueError("index can't contain negative values")
    if mode == "constant":
        values = _pairs(constant_values, nd)
        out = array
        for ax, ((b, a), (vb, va)) in enumerate(zip(pw, values)):
            shape = list(out.shape)
            parts = []
            for num, v in ((b, vb), (a, va)):
                shape[ax] = num
                parts.append(torch.full(shape, v, dtype=out.dtype,
                                        device=out.device)
                             if not isinstance(v, torch.Tensor)
                             else v.to(out.dtype).expand(shape))
            out = torch.cat([parts[0], out, parts[1]], ax)
        return out
    if mode not in ("edge", "wrap", "reflect", "symmetric", "linear_ramp",
                    "maximum", "minimum", "mean", "median", "empty"):
        raise NotImplementedError(f"mode {mode!r} not implemented")
    if reflect_type not in ("even", "odd"):
        raise ValueError(f"reflect_type must be 'even' or 'odd', got "
                         f"{reflect_type!r}")
    ends = _pairs(end_values, nd) if mode == "linear_ramp" else None
    lengths = _pairs(stat_length, nd) if stat_length is not None else None
    out = array
    for ax, (b, a) in enumerate(pw):
        n = out.shape[ax]
        if mode == "edge":
            rep = [1] * nd
            rep[ax] = b
            head = out.narrow(ax, 0, 1).repeat(rep)
            rep[ax] = a
            tail = out.narrow(ax, n - 1, 1).repeat(rep)
            out = torch.cat([head, out, tail], ax)
        elif mode == "wrap":
            idx = torch.arange(-b, n + a, device=out.device).remainder(n)
            out = out.index_select(ax, idx)
        elif mode in ("reflect", "symmetric"):
            if b or a:
                out = _pad_reflect(out, ax, b, a, mode == "symmetric",
                                   reflect_type == "odd")
        elif mode == "linear_ramp":
            out = _pad_ramp(out, ax, b, a, ends[ax])
        elif mode == "empty":
            shape = list(out.shape)
            shape[ax] = b
            head = torch.zeros(shape, dtype=out.dtype, device=out.device)
            shape[ax] = a
            tail = torch.zeros(shape, dtype=out.dtype, device=out.device)
            out = torch.cat([head, out, tail], ax)
        else:
            out = _pad_stat(out, ax, b, a,
                            None if lengths is None else lengths[ax], mode)
    return out


def _take_fill(dtype):
    """What ``jnp.take`` puts where a 'fill' index is out of range."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if dtype.is_signed else info.max


def _take(a, indices, axis=None, mode=None):
    """``jnp.take``: 'fill' (the default) puts :func:`_take_fill` where an
    index is out of ``[-n, n)``, 'clip' clamps, 'wrap' wraps; 'raise'
    raises, as it does in the JAX package."""
    mode = "fill" if mode is None else mode
    if mode == "raise":
        raise NotImplementedError(
            "The 'raise' mode to take is not supported.")
    if mode not in ("fill", "clip", "wrap"):
        raise ValueError(f"Invalid mode {mode!r} for take")
    idx = torch.as_tensor(indices, device=a.device).long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    n = a.shape[axis]
    out_of_range = None
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = idx.remainder(n)
    else:
        out_of_range = (idx < -n) | (idx >= n)
        idx = torch.where(out_of_range, 0, idx.remainder(builtins.max(n, 1)))
    out = a.movedim(axis, 0)[idx]
    if out_of_range is not None:
        mask = out_of_range.reshape(out_of_range.shape
                                    + (1,) * (out.dim() - idx.dim()))
        out = torch.where(mask, torch.tensor(_take_fill(a.dtype),
                                             dtype=a.dtype,
                                             device=a.device), out)
    return out.movedim(tuple(range(idx.dim())),
                       tuple(range(axis, axis + idx.dim())))


def _take_along_axis(arr, indices, axis=-1):
    return torch.take_along_dim(arr, indices.long(), dim=axis)


def _extract(condition, arr):
    return arr.reshape(-1)[condition.reshape(-1).bool()]


def _searchsorted(a, v, side="left", sorter=None):
    if sorter is not None:
        a = a[sorter.long()]
    v = torch.as_tensor(v, dtype=a.dtype, device=a.device)
    return torch.searchsorted(a, v, right=side == "right").to(torch.int32)


def _sort(a, axis=-1, kind=None, order=None, stable=True,  # noqa: ARG001
          descending=False):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True,
                      descending=descending).values


def _argsort(a, axis=-1, kind=None, order=None, stable=True,  # noqa: ARG001
             descending=False):
    """A descending sort keeps equal elements in their order, as
    ``jnp.argsort(descending=True)`` does."""
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.argsort(a, dim=axis, stable=True, descending=descending)


def _where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    return torch.where(torch.as_tensor(condition).bool(), x, y)


def _diag(v, k=0):
    return torch.diag(v, k)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None):
    out = torch.diagonal(a, offset, axis1, axis2).sum(-1)
    return out if dtype is None else out.to(normalize_dtype(dtype))


def _tri(N, M=None, k=0, dtype=None):  # noqa: N803 - numpy's names
    m = N if M is None else M
    ones = torch.ones(N, m, dtype=normalize_dtype(dtype),
                      device=creation_device())
    return torch.tril(ones, k)


def _eye(N, M=None, k=0, dtype=None):  # noqa: N803
    m = N if M is None else M
    out = torch.zeros(N, m, dtype=normalize_dtype(dtype),
                      device=creation_device())
    out.diagonal(k).fill_(1)
    return out


def _identity(n, dtype=None):
    return _eye(n, dtype=dtype)


def _vander(x, N=None, increasing=False):  # noqa: N803
    return torch.vander(x, N, increasing)


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _tensordot(a, b, axes=2):
    return torch.tensordot(a, b, dims=axes)


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.broadcast_tensors(a.movedim(axisa, -1), b.movedim(axisb, -1))
    return torch.linalg.cross(a, b, dim=-1).movedim(-1, axisc)


def _round(a, decimals=0):
    # an integer array rounds to itself; jnp refuses decimals < 0 for one
    if not (a.is_floating_point() or a.is_complex() or a.dtype == torch.bool):
        if decimals < 0:
            raise NotImplementedError(
                "integer np.round not implemented for decimals < 0")
        return a.clone()
    return torch.round(a, decimals=decimals)


def _clip(a, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return a.clone()
    return torch.clamp(a, a_min, a_max)


def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None):
    """``np.unique`` with its three optional outputs; ``return_index``
    gives each value's first position, as numpy's."""
    if axis is None:
        flat = ar.reshape(-1)
        values, inverse, counts = torch.unique(
            flat, sorted=True, return_inverse=True, return_counts=True)
    else:
        values, inverse, counts = torch.unique(
            ar, sorted=True, return_inverse=True, return_counts=True,
            dim=axis)
    out = [values]
    if return_index:
        n = inverse.numel()
        first = torch.full((values.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=ar.device)
        pos = torch.arange(n, device=ar.device)
        out.append(first.scatter_reduce(0, inverse.reshape(-1), pos, "amin"))
    if return_inverse:
        out.append(inverse.reshape(ar.shape) if axis is None else inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def _union1d(a, b):
    return torch.unique(torch.cat([a.reshape(-1), b.reshape(-1)]))


def _intersect1d(a, b):
    u = torch.unique(a)
    return u[torch.isin(u, b)]


def _setdiff1d(a, b):
    u = torch.unique(a)
    return u[~torch.isin(u, b)]


def _setxor1d(a, b):
    ua, ub = torch.unique(a), torch.unique(b)
    return torch.unique(torch.cat([ua[~torch.isin(ua, ub)],
                                   ub[~torch.isin(ub, ua)]]))


def _in1d(ar1, ar2, assume_unique=False, invert=False):  # noqa: ARG001
    return torch.isin(ar1.reshape(-1), ar2, invert=invert)


def _isin(element, test_elements, assume_unique=False, invert=False):  # noqa: ARG001
    return torch.isin(element, test_elements, invert=invert)


def _unravel_index(indices, shape):
    return tuple(_ops.int_default(i, indices)
                 for i in torch.unravel_index(indices.long(), tuple(shape)))


def _diag_indices(n, ndim=2):
    i = torch.arange(n, device=creation_device())
    return (i,) * ndim


def _tril_indices(n, k=0, m=None):
    ij = torch.tril_indices(n, n if m is None else m, k,
                            device=creation_device())
    return ij[0], ij[1]


def _triu_indices(n, k=0, m=None):
    ij = torch.triu_indices(n, n if m is None else m, k,
                            device=creation_device())
    return ij[0], ij[1]


def _bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights, minlength)


def _digitize(x, bins, right=False):
    # numpy's right=False is bucketize's right=True, and the other way
    return torch.bucketize(x, bins, right=not right).to(torch.int32)


def _corrcoef(x, y=None, rowvar=True):
    if y is not None:
        x = torch.cat([x.reshape(-1, x.shape[-1]) if rowvar else x.T,
                       y.reshape(-1, y.shape[-1]) if rowvar else y.T])
    elif not rowvar:
        x = x.T
    return torch.corrcoef(x)


def _cov(m, y=None, rowvar=True, bias=False, ddof=None):
    if y is not None:
        m = torch.cat([torch.atleast_2d(m), torch.atleast_2d(y)])
    if not rowvar:
        m = m.T
    correction = ddof if ddof is not None else (0 if bias else 1)
    return torch.cov(m, correction=correction)


def _edge(a, value, axis):
    """``value`` as a slab of ``a`` along ``axis``: a scalar broadcasts
    (a Python number is weak, as in the JAX package)."""
    v = torch.as_tensor(value, device=a.device)
    v = v.to(_promote.result_dtype(a, value))
    if v.dim() == 0:
        shape = list(a.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    if prepend is not None or append is not None:
        parts = [a] if prepend is None else [_edge(a, prepend, axis), a]
        if append is not None:
            parts.append(_edge(a, append, axis))
        dt = functools.reduce(torch.promote_types, [p.dtype for p in parts])
        a = torch.cat([p.to(dt) for p in parts], dim=axis)
    return torch.diff(a, n=n, dim=axis)


def _ediff1d(ary, to_end=None, to_begin=None):
    out = torch.diff(ary.reshape(-1))
    parts = [out]
    if to_begin is not None:
        parts.insert(0, torch.as_tensor(to_begin, device=out.device)
                     .reshape(-1).to(out.dtype))
    if to_end is not None:
        parts.append(torch.as_tensor(to_end, device=out.device)
                     .reshape(-1).to(out.dtype))
    return torch.cat(parts) if len(parts) > 1 else out


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, x, dim=axis)


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    b = torch.as_tensor(b, device=a.device).to(a.dtype)
    return torch.isclose(a, b, rtol, atol, equal_nan)


def _allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _isclose(a, b, rtol, atol, equal_nan).all()


def _array_equal(a1, a2, equal_nan=False):  # noqa: ARG001
    if tuple(a1.shape) != tuple(a2.shape):
        return torch.tensor(False, device=a1.device)
    return (a1 == a2).all()


def _append(arr, values, axis=None):
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)])
    return torch.cat([arr, values], dim=axis)


def _meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    """``sparse=True`` gives each grid only its own axis, the others 1;
    ``copy=False`` raises, as in the JAX package."""
    if not copy:
        raise ValueError("meshgrid only supports copy=True")
    grids = torch.meshgrid(*xi, indexing=indexing)
    if not sparse:
        return tuple(grids)
    out = []
    for i, x in enumerate(xi):
        shape = [1] * len(xi)
        axis = i
        if indexing == "xy" and len(xi) > 1 and i < 2:
            axis = 1 - i
        shape[axis] = x.numel()
        out.append(x.reshape(shape))
    return tuple(out)


def _matrix_transpose(x):
    return x.transpose(-1, -2)


def _unique_counts(x):
    values, counts = torch.unique(x, sorted=True, return_counts=True)
    return values, counts


def _unique_inverse(x):
    values, inverse = torch.unique(x, sorted=True, return_inverse=True)
    return values, inverse


_OTHER_FNS = {
    "reshape": _reshape, "ravel": _ravel,
    "transpose": _transpose, "permute_dims": _transpose,
    "swapaxes": lambda a, axis1, axis2: a.transpose(axis1, axis2),
    "moveaxis": lambda a, source, destination: torch.movedim(
        a, source, destination),
    "rollaxis": _rollaxis, "squeeze": _squeeze, "expand_dims": _expand_dims,
    "broadcast_to": lambda array, shape: array.expand(tuple(shape)),
    "broadcast_arrays": lambda *args: tuple(torch.broadcast_tensors(*args)),
    "flip": _flip, "fliplr": torch.fliplr, "flipud": torch.flipud,
    "rot90": lambda m, k=1, axes=(0, 1): torch.rot90(m, k, list(axes)),
    "roll": lambda a, shift, axis=None: torch.roll(a, shift, axis),
    "concatenate": _concatenate,
    "stack": _stack, "vstack": _stacker(torch.vstack),
    "hstack": _stacker(torch.hstack), "dstack": _stacker(torch.dstack),
    "column_stack": lambda tup: torch.column_stack(list(tup)),
    "split": _split, "array_split": _array_split,
    "hsplit": lambda a, s: tuple(torch.hsplit(a, s)),
    "vsplit": lambda a, s: tuple(torch.vsplit(a, s)),
    "dsplit": lambda a, s: tuple(torch.dsplit(a, s)),
    "tile": lambda A, reps: torch.tile(A, (reps,) if isinstance(reps, int)
                                       else tuple(reps)),
    "repeat": _repeat, "pad": _pad, "take": _take,
    "take_along_axis": _take_along_axis, "extract": _extract,
    "searchsorted": _searchsorted, "argsort": _argsort, "sort": _sort,
    "flatnonzero": lambda a: torch.nonzero(a.reshape(-1)).reshape(-1),
    "nonzero": lambda a: torch.nonzero(a, as_tuple=True),
    "argwhere": torch.argwhere, "where": _where,
    "diag": _diag, "diagflat": lambda v, k=0: torch.diagflat(v, k),
    "diagonal": lambda a, offset=0, axis1=0, axis2=1: torch.diagonal(
        a, offset, axis1, axis2),
    "trace": _trace, "tril": lambda m, k=0: torch.tril(m, k),
    "triu": lambda m, k=0: torch.triu(m, k), "tri": _tri, "eye": _eye,
    "identity": _identity, "vander": _vander,
    "dot": _promote.product(_ops.np_dot), "vdot": _promote.product(_vdot),
    "inner": _promote.product(torch.inner), "outer": _outer,
    "matmul": _promote.product(torch.matmul),
    "tensordot": _promote.product(_tensordot),
    "kron": torch.kron, "cross": _cross, "clip": _clip,
    "round": _round, "around": _round,
    "unique": _unique, "unique_values": _unique,
    "unique_counts": _unique_counts, "unique_inverse": _unique_inverse,
    "union1d": _union1d, "intersect1d": _promote.set_fn(_intersect1d),
    "setdiff1d": _promote.set_fn(_setdiff1d),
    "setxor1d": _promote.set_fn(_setxor1d), "in1d": _promote.set_fn(_in1d),
    "isin": _promote.set_fn(_isin),
    "atleast_1d": torch.atleast_1d, "atleast_2d": torch.atleast_2d,
    "atleast_3d": torch.atleast_3d,
    "meshgrid": _meshgrid,
    "unravel_index": _unravel_index, "diag_indices": _diag_indices,
    "tril_indices": _tril_indices, "triu_indices": _triu_indices,
    "bincount": _bincount, "digitize": _digitize,
    "corrcoef": _promote.inexact_args(_corrcoef),
    "cov": _promote.inexact_args(_cov), "diff": _diff, "ediff1d": _ediff1d,
    "trapezoid": _promote.inexact_args(_trapezoid), "isclose": _isclose,
    "allclose": _allclose,
    "array_equal": _array_equal, "append": _append,
    "matrix_transpose": _matrix_transpose,
}
# -- the rest of _OTHER (the names MISSING listed until PR 19) -----------------

def _axis_last(a, axis):
    return a.movedim(axis % a.dim(), -1)


def _apply_along_axis(func1d, axis, arr, *args, **kwargs):
    """``func1d`` of every 1-D slice along ``axis`` (it gets tensors); its
    result's dims take ``axis``'s place."""
    axis %= arr.dim()
    moved = arr.movedim(axis, -1)
    lead = moved.shape[:-1]
    outs = []
    for row in moved.reshape(-1, moved.shape[-1]):
        r = func1d(row, *args, **kwargs)
        outs.append(torch.as_tensor(r._data if isinstance(r, NDArray)
                                    else r, device=arr.device))
    out = torch.stack(outs).reshape(tuple(lead) + tuple(outs[0].shape))
    k = outs[0].dim()
    return out.movedim(tuple(range(len(lead), len(lead) + k)),
                       tuple(range(axis, axis + k)))


def _partition_sort(a, axis):
    moved = _axis_last(a, axis)
    return moved, torch.sort(moved, dim=-1, stable=True)


def _partition(a, kth, axis=-1):
    """``jnp.partition``: the ``kth + 1`` smallest ascending, then the rest
    descending (lax.top_k's order)."""
    moved, (s, _) = _partition_sort(a, axis)
    kth %= moved.shape[-1]
    out = torch.cat([s[..., :kth + 1], s[..., kth + 1:].flip(-1)], -1)
    return out.movedim(-1, axis % a.dim())


def _argpartition(a, kth, axis=-1):
    """``jnp.argpartition``: the indices of the ``kth + 1`` smallest by value
    (ties by index), then the other indices ascending."""
    moved, (_, order) = _partition_sort(a, axis)
    n = moved.shape[-1]
    kth %= n
    bottom = order[..., :kth + 1]
    rest = torch.ones(moved.shape, dtype=torch.bool, device=a.device)
    rest.scatter_(-1, bottom, False)
    top = torch.argsort((~rest).to(torch.uint8), dim=-1,
                        stable=True)[..., :n - kth - 1]
    out = torch.cat([bottom, top], -1).to(torch.int32)
    return out.movedim(-1, axis % a.dim())


def _array_equiv(a1, a2):
    try:
        x, y = torch.broadcast_tensors(a1, a2)
    except RuntimeError:
        return torch.tensor(False, device=a1.device)
    return (x == y).all()


def _choose(a, choices, out=None, mode="raise"):
    if out is not None:
        raise NotImplementedError("The 'out' argument to choose is not "
                                  "supported.")
    if a.is_floating_point() or a.dtype == torch.bool:
        raise ValueError("`a` array must be integer typed")
    n = len(choices)
    if mode == "raise":
        if builtins.bool(((a < 0) | (a >= n)).any()):
            raise ValueError("invalid entry in choice array")
    elif mode == "wrap":
        a = a.remainder(n)
    elif mode == "clip":
        a = a.clamp(0, n - 1)
    else:
        raise ValueError(f"mode={mode!r} not understood. Must be 'raise', "
                         "'wrap', or 'clip'")
    choices = [torch.as_tensor(c, device=a.device) for c in choices]
    a, *choices = torch.broadcast_tensors(a, *choices)
    stacked = torch.stack(choices)
    return stacked.gather(0, a.long().unsqueeze(0)).squeeze(0)


def _compress(condition, a, axis=None):
    condition = torch.as_tensor(condition, device=a.device).bool()
    if condition.dim() != 1:
        raise ValueError("condition must be a 1D array")
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    if builtins.bool(condition[n:].any()):
        raise IndexError(f"condition contains entries that are out of "
                         f"bounds for axis {axis}")
    idx = torch.nonzero(condition[:n]).reshape(-1)
    return a.index_select(axis, idx)


def _conv1d(x, y, mode, correlate):
    """``jnp.convolve``/``jnp.correlate`` of 1-D arrays, in their inexact
    dtype."""
    if x.dim() != 1 or y.dim() != 1:
        raise ValueError("convolve/correlate take 1-D arrays")
    dt = _promote.inexact_dtype(torch.promote_types(x.dtype, y.dtype))
    x, y = x.to(dt), y.to(dt)
    reverse = False
    if correlate:
        y = y.conj()
        if x.shape[0] < y.shape[0]:
            x, y, reverse = y, x, True
    else:
        if x.shape[0] < y.shape[0]:
            x, y = y, x
        y = y.flip(0)
    m = y.shape[0]
    if mode == "valid":
        pads = (0, 0)
    elif mode == "same":
        pads = (m // 2, m - m // 2 - 1)
    elif mode == "full":
        pads = (m - 1, m - 1)
    else:
        raise ValueError(f"mode must be one of ['full', 'same', 'valid'], "
                         f"got {mode!r}")
    xp = torch.nn.functional.pad(x, pads)
    out = (xp.unfold(0, m, 1) * y).sum(-1)
    return out.flip(0) if reverse else out


def _cumulative_sum(x, axis=None, dtype=None, include_initial=False):
    if axis is None:
        if x.dim() != 1:
            raise ValueError("cumulative_sum: axis is required for arrays "
                             "of more than one dimension")
        axis = 0
    out = torch.cumsum(x, dim=axis, dtype=normalize_dtype(dtype)
                       if dtype is not None else None)
    if x.dtype == torch.bool and dtype is None:
        out = out.to(torch.int64)
    if include_initial:
        shape = list(out.shape)
        shape[axis] = 1
        out = torch.cat([torch.zeros(shape, dtype=out.dtype,
                                     device=out.device), out], axis)
    return out


def _delete(arr, obj, axis=None, assume_unique_indices=False):  # noqa: ARG001
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.dim()
    n = arr.shape[axis]
    if isinstance(obj, int) or (isinstance(obj, torch.Tensor)
                                and obj.dim() == 0 and not obj.is_floating_point()
                                and obj.dtype != torch.bool):
        obj = int(obj)
        if not -n <= obj < n:
            raise ValueError(f"index {obj} out of bounds for axis of size "
                             f"{n}")
        obj %= n
        keep = torch.ones(n, dtype=torch.bool, device=arr.device)
        keep[obj] = False
    elif isinstance(obj, slice):
        keep = torch.ones(n, dtype=torch.bool, device=arr.device)
        keep[obj] = False
    else:
        obj = torch.as_tensor(obj, device=arr.device)
        if obj.dtype == torch.bool:
            if tuple(obj.shape) != (n,):
                raise ValueError("np.delete(arr, obj): for boolean indices, "
                                 "obj must be one-dimensional with length "
                                 "matching specified axis.")
            keep = ~obj
        elif obj.is_floating_point():
            raise ValueError(f"np.delete(arr, obj): got obj.dtype="
                             f"{obj.dtype}; must be integer or bool.")
        else:
            keep = torch.ones(n, dtype=torch.bool, device=arr.device)
            keep[obj.reshape(-1).long()] = False
    return arr.index_select(axis, torch.nonzero(keep).reshape(-1))


def _fill_diagonal(a, val, wrap=False, inplace=True):  # noqa: ARG001
    """``jnp.fill_diagonal``: out of place only (``inplace=False``), as in
    the JAX package; ``wrap`` changes nothing there either."""
    if inplace:
        raise NotImplementedError("JAX arrays are immutable, must use "
                                  "inplace=False")
    if a.dim() < 2:
        raise ValueError("array must be at least 2-d")
    if a.dim() > 2 and builtins.any(n != a.shape[0] for n in a.shape[1:]):
        raise ValueError("All dimensions of input must be of equal length")
    n = builtins.min(a.shape)
    val = torch.as_tensor(val, dtype=a.dtype, device=a.device)
    if val.dim():
        val = val.reshape(-1).repeat(-(-n // val.numel()))[:n]
    idx = torch.arange(n, device=a.device)
    out = a.clone()
    out[(idx,) * a.dim()] = val
    return out


def _gradient(f, *varargs, axis=None, edge_order=None):
    """``jnp.gradient``: central differences inside, one-sided at the
    edges; a scalar or a coordinate array of spacing per axis."""
    if edge_order is not None:
        raise NotImplementedError("The 'edge_order' argument to gradient is "
                                  "not supported.")
    dt = _promote.result_dtype(f, *varargs)
    dt = _promote.inexact_dtype(dt)
    a = f.to(dt)

    def along(h, ax):
        def sl(start, stop):
            return a.narrow(ax, start, stop - start)
        n = a.shape[ax]
        upper = sl(1, 2) - sl(0, 1)
        lower = sl(n - 1, n) - sl(n - 2, n - 1)
        if not isinstance(h, torch.Tensor) or h.dim() == 0:
            inner = (sl(2, n) - sl(0, n - 2)) * 0.5 / h
            return torch.cat([upper / h, inner, lower / h], ax)
        h = h.to(dt)
        shape = [1] * a.dim()
        shape[ax] = h.shape[0]
        h = h.reshape(shape)

        def sx(start, stop):
            return h.narrow(ax, start, stop - start)
        upper = upper / (sx(1, 2) - sx(0, 1))
        lower = lower / (sx(n - 1, n) - sx(n - 2, n - 1))
        dx1 = sx(1, n - 1) - sx(0, n - 2)
        dx2 = sx(2, n) - sx(1, n - 1)
        ca = -dx2 / (dx1 * (dx1 + dx2))
        cb = (dx2 - dx1) / (dx1 * dx2)
        cc = dx1 / (dx2 * (dx1 + dx2))
        inner = ca * sl(0, n - 2) + cb * sl(1, n - 1) + cc * sl(2, n)
        return torch.cat([upper, inner, lower], ax)

    axes = tuple(range(a.dim())) if axis is None else tuple(
        x % a.dim() for x in ((axis,) if isinstance(axis, int) else axis))
    if not axes:
        return []
    if builtins.min(a.shape[x] for x in axes) < 2:
        raise ValueError("Shape of array too small to calculate a numerical "
                         "gradient, at least 2 elements are required.")
    dx = [1.0] * len(axes) if not varargs else (
        list(varargs) * len(axes) if len(varargs) == 1 else list(varargs))
    out = [along(h, ax) for ax, h in zip(axes, dx)]
    return out[0] if len(axes) == 1 else out


def _lin(start, stop, num, endpoint, dt, device):
    """``jnp.linspace``'s formula in ``dt``: ``start * (1 - step) + stop *
    step`` with ``step = iota / div``, the end appended."""
    start = torch.as_tensor(start, dtype=dt, device=device)
    stop = torch.as_tensor(stop, dtype=dt, device=device)
    if num == 1:
        return start.reshape(1)
    if num == 0:
        return torch.empty(0, dtype=dt, device=device)
    div = (num - 1) if endpoint else num
    step = torch.arange(div, dtype=dt, device=device) / torch.tensor(
        div, dtype=dt, device=device)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)]) if endpoint else out


def _bin_edges(a, bins, rng):
    dt = _promote.inexact_dtype(a.dtype)
    if isinstance(bins, torch.Tensor) and bins.dim() == 1:
        return bins.to(dt)
    if isinstance(bins, (list, tuple)):
        return torch.as_tensor(bins, dtype=dt, device=a.device)
    if rng is None:
        lo, hi = a.min().to(dt), a.max().to(dt)
    else:
        lo, hi = (torch.as_tensor(v, dtype=dt, device=a.device)
                  for v in rng)
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    return _lin(lo, hi, int(bins) + 1, True, dt, a.device)


def _histogram(a, bins=10, range=None, weights=None, density=None):  # noqa: A002
    """``jnp.histogram``: counts in ``a``'s inexact dtype (the weights'
    dtype where given), the last bin closed."""
    a = a.reshape(-1)
    edges = _bin_edges(a, bins, range)
    if weights is None:
        weights = torch.ones_like(a, dtype=edges.dtype)
    weights = weights.reshape(-1)
    idx = torch.searchsorted(edges, a.to(edges.dtype), right=True)
    idx = torch.where(a.to(edges.dtype) == edges[-1], edges.shape[0] - 1,
                      idx)
    counts = torch.zeros(edges.shape[0] + 1, dtype=weights.dtype,
                         device=a.device).index_add(0, idx, weights)
    counts = counts[1:edges.shape[0]]
    if density:
        widths = torch.diff(edges)
        counts = counts / widths / counts.sum()
    return counts, edges


def _histogramdd(sample, bins=10, range=None, weights=None, density=None):  # noqa: A002
    n, d = sample.shape
    per_dim = bins if isinstance(bins, (list, tuple)) else [bins] * d
    idxs, edges = [], []
    for i in builtins.range(d):
        col = sample[:, i].contiguous()
        e = _bin_edges(col, per_dim[i], None if range is None else range[i])
        j = torch.searchsorted(e, col.to(e.dtype), right=True)
        j = torch.where(col.to(e.dtype) == e[-1], j - 1, j)
        idxs.append(j)
        edges.append(e)
    nbins = [e.shape[0] + 1 for e in edges]
    flat = torch.zeros(n, dtype=torch.int64, device=sample.device)
    for j, nb in zip(idxs, nbins):
        flat = flat * nb + j.clamp(0, nb - 1)
    total = int(_np.prod(nbins))
    if weights is None:
        hist = torch.bincount(flat, minlength=total)
    else:
        hist = torch.zeros(total, dtype=weights.dtype,
                           device=sample.device).index_add(0, flat, weights)
    hist = hist.reshape(nbins)[(slice(1, -1),) * d]
    if density:
        hist = hist.to(sample.dtype)
        hist = hist / hist.sum()
        for k in builtins.range(d):
            shape = [1] * d
            shape[k] = nbins[k] - 2
            hist = hist / torch.diff(edges[k]).reshape(shape)
    return hist, edges


def _histogram2d(x, y, bins=10, range=None, weights=None, density=None):  # noqa: A002
    hist, edges = _histogramdd(torch.stack([x, y], 1), bins, range,
                               weights, density)
    return hist, edges[0], edges[1]


def _indices(dimensions, dtype=None, sparse=False):
    dt = normalize_dtype(dtype) if dtype is not None else torch.int64
    dev = creation_device()
    out = []
    for i, n in enumerate(dimensions):
        shape = [1] * len(dimensions)
        shape[i] = n
        r = torch.arange(n, dtype=dt, device=dev).reshape(shape)
        out.append(r if sparse else r.expand(tuple(dimensions)))
    return tuple(out) if sparse else torch.stack(out)


def _insert(arr, obj, values, axis=None):
    """``jnp.insert`` (numpy's rules): ``values`` at positions ``obj`` of
    ``axis`` (the flattened array without one)."""
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.dim()
    n_input = arr.shape[axis]
    if isinstance(obj, slice):
        indices = torch.arange(*obj.indices(n_input), device=arr.device)
    else:
        indices = torch.as_tensor(obj, device=arr.device)
    if indices.dim() > 1:
        raise ValueError("insert(): obj must be a slice, a one-dimensional "
                         f"array, or a scalar; got {obj}")
    if indices.is_floating_point() or indices.dtype == torch.bool:
        raise ValueError(f"insert(): index array must be integer typed; "
                         f"got {obj}")
    values = torch.as_tensor(values, device=arr.device).to(arr.dtype)
    while values.dim() < arr.dim():
        values = values.unsqueeze(0)
    if indices.numel() == 1:
        index = indices.reshape(-1)[0]
        if indices.dim() == 0:
            values = values.movedim(0, axis)
        indices = index.expand(values.shape[axis])
    n_insert = torch.broadcast_shapes(tuple(indices.shape),
                                      (values.shape[axis],))[0]
    indices = indices.long().expand(n_insert)
    indices = torch.where(indices < 0, indices + n_input, indices)
    indices = indices.clamp(0, n_input)
    order = torch.argsort(indices, stable=True)
    values_ind = indices.clone()
    values_ind[order] += torch.arange(n_insert, device=arr.device)
    mask = torch.ones(n_input + n_insert, dtype=torch.bool,
                      device=arr.device)
    mask[values_ind] = False
    arr_ind = torch.nonzero(mask).reshape(-1)
    shape = list(arr.shape)
    shape[axis] += n_insert
    out = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    vshape = list(arr.shape)
    vshape[axis] = n_insert
    out.index_copy_(axis, values_ind, values.expand(vshape).contiguous())
    out.index_copy_(axis, arr_ind, arr)
    return out


def _interp(x, xp, fp, left=None, right=None, period=None):
    """``jnp.interp``: ``left``/``right`` 'extrapolate' extend the end
    segments; ``period`` wraps."""
    if tuple(xp.shape) != tuple(fp.shape) or xp.dim() != 1:
        raise ValueError("xp and fp must be one-dimensional arrays of equal "
                         "size")
    dt = _promote.inexact_dtype(torch.promote_types(x.dtype, xp.dtype))
    x, xp = x.to(dt), xp.to(dt)
    fp = _promote.inexact(fp)
    if period is not None:
        period = builtins.abs(period)
        x, xp = x.remainder(period), xp.remainder(period)
        xp, order = torch.sort(xp, stable=True)
        fp = fp[order]
        xp = torch.cat([xp[-1:] - period, xp, xp[:1] + period])
        fp = torch.cat([fp[-1:], fp, fp[:1]])
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(_np.spacing(_np.finfo(numpy_dtype(dt)).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1, dx)) * df)
    if period is None and not isinstance(left, str):
        f = torch.where(x < xp[0], fp[0] if left is None else
                        torch.as_tensor(left, dtype=f.dtype,
                                        device=f.device), f)
    if period is None and not isinstance(right, str):
        f = torch.where(x > xp[-1], fp[-1] if right is None else
                        torch.as_tensor(right, dtype=f.dtype,
                                        device=f.device), f)
    return f


def _lexsort(keys, axis=-1):
    """Indices sorting by the last key, then the one before, ...: stable
    sorts from the first key to the last."""
    keys = list(keys)
    order = None
    for k in keys:
        k = k.movedim(axis, -1)
        if order is None:
            order = torch.argsort(k, dim=-1, stable=True)
        else:
            order = order.gather(-1, torch.argsort(k.gather(-1, order),
                                                   dim=-1, stable=True))
    return order.movedim(-1, axis)


def _packbits(a, axis=None, bitorder="big"):
    if a.is_floating_point() or a.is_complex():
        raise TypeError("Expected an input array of integer or boolean data "
                        "type")
    if bitorder not in ("little", "big"):
        raise ValueError("'order' must be either 'little' or 'big'")
    a = (a != 0).to(torch.uint8)
    bits = torch.arange(8, dtype=torch.uint8, device=a.device)
    if bitorder == "big":
        bits = bits.flip(0)
    if axis is None:
        a, axis = a.reshape(-1), 0
    a = a.movedim(axis, -1)
    rem = a.shape[-1] % 8
    if rem:
        a = torch.nn.functional.pad(a, (0, 8 - rem))
    a = a.reshape(a.shape[:-1] + (a.shape[-1] // 8, 8))
    packed = (a.to(torch.int32) << bits.to(torch.int32)).sum(-1)
    return packed.to(torch.uint8).movedim(-1, axis)


def _unpackbits(a, axis=None, count=None, bitorder="big"):
    if a.dtype != torch.uint8:
        raise TypeError("Expected an input array of unsigned byte data type")
    if bitorder not in ("little", "big"):
        raise ValueError("'order' must be either 'little' or 'big'")
    bits = (1 << torch.arange(8, device=a.device)).to(torch.uint8)
    if bitorder == "big":
        bits = bits.flip(0)
    if axis is None:
        a, axis = a.reshape(-1), 0
    a = a.movedim(axis, -1)
    out = ((a[..., None] & bits) > 0).to(torch.uint8)
    out = out.reshape(out.shape[:-2] + (-1,))
    if count is not None:
        if count > out.shape[-1]:
            out = torch.nn.functional.pad(out, (0, count - out.shape[-1]))
        else:
            out = out[..., :count]
    return out.movedim(-1, axis)


def _piecewise(x, condlist, funclist, *args, **kw):
    """``jnp.piecewise``: where several conditions hold the last wins; the
    default (``funclist`` one longer) where none does, else 0."""
    nc, nf = len(condlist), len(funclist)
    if nf == nc + 1:
        funclist = funclist[-1:] + funclist[:-1]
    elif nf == nc:
        funclist = [0] + list(funclist)
    else:
        raise ValueError(f"with {nc} condition(s), either {nc} or {nc + 1} "
                         f"functions are expected; got {nf}")
    conds = torch.stack([torch.as_tensor(c, device=x.device).bool()
                         .expand(x.shape) for c in condlist])
    which = torch.cat([torch.zeros_like(conds[:1], dtype=torch.int64),
                       conds.long()]).cumsum(0).argmax(0)
    out = torch.zeros_like(x)
    for i, f in enumerate(funclist):
        v = f(x, *args, **kw) if callable(f) else f
        v = torch.as_tensor(v._data if isinstance(v, NDArray) else v,
                            device=x.device).to(x.dtype)
        out = torch.where(which == i, v, out)
    return out


def _polyval(p, x, unroll=16):  # noqa: ARG001
    dt = _promote.inexact_dtype(torch.promote_types(p.dtype, x.dtype))
    p, x = p.to(dt), x.to(dt)
    y = torch.zeros(torch.broadcast_shapes(tuple(p.shape[1:]),
                                           tuple(x.shape)),
                    dtype=dt, device=x.device)
    for c in p:
        y = y * x + c
    return y


def _polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    """``jnp.polyfit`` by least squares over scaled Vandermonde columns."""
    dt = _promote.inexact_dtype(torch.promote_types(x.dtype, y.dtype))
    x, y = x.to(dt), y.to(dt)
    order = int(deg) + 1
    if rcond is None:
        rcond = x.shape[0] * float(torch.finfo(dt).eps)
    lhs = torch.vander(x, order)
    rhs = y
    if w is not None:
        w = w.to(dt)
        lhs = lhs * w[:, None]
        rhs = rhs * (w if rhs.dim() == 1 else w[:, None])
    scale = torch.sqrt((lhs * lhs).sum(0))
    lhs = lhs / scale
    # the card's solver is QR (full rank); the CPU's the SVD, as jnp's
    kw = dict(driver="gels") if lhs.is_cuda else dict(rcond=rcond,
                                                      driver="gelsd")
    sol = torch.linalg.lstsq(lhs, rhs if rhs.dim() == 2 else rhs[:, None],
                             **kw)
    c = sol.solution / scale[:, None]
    if rhs.dim() == 1:
        c = c[:, 0]
    if full:
        return c, sol.residuals, sol.rank, sol.singular_values, rcond
    if cov:
        raise NotImplementedError("polyfit(cov=True) is not ported")
    return c


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [torch.as_tensor(i) for i in multi_index]
    if len(idx) != len(dims):
        raise ValueError("len(multi_index) != len(dims)")
    for i in idx:
        if i.is_floating_point() or i.dtype == torch.bool:
            raise TypeError("only int indices permitted")
    if mode == "raise":
        if builtins.any(builtins.bool(((i < 0) | (i >= d)).any())
                        for i, d in zip(idx, dims)):
            raise ValueError("invalid entry in coordinates array")
    elif mode == "clip":
        idx = [i.clamp(0, d - 1) for i, d in zip(idx, dims)]
    elif mode == "wrap":
        idx = [i.remainder(d) for i, d in zip(idx, dims)]
    else:
        raise ValueError(f"invalid mode={mode!r}. Expected 'raise', 'wrap', "
                         "or 'clip'")
    dims = tuple(int(d) for d in dims)
    if order == "F":
        strides = _np.cumprod((1,) + dims[:-1])
    elif order == "C":
        strides = _np.cumprod((1,) + dims[1:][::-1])[::-1]
    else:
        raise ValueError(f"invalid order={order!r}. Expected 'C' or 'F'")
    out = torch.zeros((), dtype=idx[0].dtype, device=idx[0].device)
    for i, s in zip(idx, strides):
        out = out + i * int(s)
    return out


def _real_if_close(a, tol=100):
    """numpy's ``real_if_close`` (the JAX package has none): the real part
    of a complex array whose imaginary parts are all within ``tol``
    machine epsilons of 0, else the array."""
    if not a.is_complex():
        return a.clone()
    eps = torch.finfo(a.real.dtype).eps
    limit = tol * eps if tol > 1 else tol
    if builtins.bool((a.imag.abs() < limit).all()):
        return a.real.clone()
    return a.clone()


def _resize(a, new_shape):
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    a = a.reshape(-1)
    size = int(_np.prod(shape))
    if a.numel() == 0 or size == 0:
        return torch.zeros(shape, dtype=a.dtype, device=a.device)
    reps = -(-size // a.numel())
    return a.repeat(reps)[:size].reshape(shape)


def _roots(p, strip_zeros=True):
    """``jnp.roots``: the eigenvalues of the companion matrix, complex;
    leading zeros stripped, trailing ones give roots at 0."""
    p = _promote.inexact(torch.atleast_1d(p))
    if strip_zeros:
        nz = torch.nonzero(p).reshape(-1)
        if nz.numel() == 0:
            return torch.zeros(0, dtype=p.dtype, device=p.device)
        p = p[int(nz[0]):]
    trailing = 0
    while p.shape[0] > 1 and builtins.bool(p[-1] == 0):
        p, trailing = p[:-1], trailing + 1
    n = p.shape[0]
    if n < 2:
        r = torch.zeros(0, dtype=p.dtype, device=p.device)
    else:
        comp = torch.diag(torch.ones(n - 2, dtype=p.dtype,
                                     device=p.device), -1)
        comp[0, :] = -p[1:] / p[0]
        r = torch.linalg.eigvals(comp)
    if trailing:
        r = torch.cat([r.to(torch.promote_types(r.dtype, torch.complex64)
                            if not r.is_complex() else r.dtype),
                       torch.zeros(trailing, dtype=r.dtype if r.is_complex()
                                   else torch.complex64, device=p.device)])
    return r


def _select(condlist, choicelist, default=0):
    if len(condlist) != len(choicelist):
        raise ValueError("condlist must have length equal to choicelist")
    if not condlist:
        raise ValueError("condlist must be non-empty")
    out = torch.as_tensor(default, device=choicelist[0].device)
    dt = functools.reduce(torch.promote_types,
                          [c.dtype for c in choicelist])
    for c, v in zip(reversed(condlist), reversed(choicelist)):
        out = torch.where(c.bool(), v.to(dt), out.to(dt))
    return out


def _sort_complex(a):
    """Sorted along the last axis by real part, then imaginary part; a
    complex result."""
    if not a.is_complex():
        dt = torch.complex128 if a.dtype in (torch.float64, torch.int64) \
            else torch.complex64
        return torch.sort(a, dim=-1, stable=True).values.to(dt)
    order = torch.argsort(a.imag, dim=-1, stable=True)
    order = order.gather(-1, torch.argsort(a.real.gather(-1, order), dim=-1,
                                           stable=True))
    return a.gather(-1, order)


def _trim_zeros(filt, trim="fb"):
    nz = torch.nonzero(filt.reshape(-1)).reshape(-1)
    if nz.numel() == 0:
        return filt[:0]
    trim = trim.lower()
    start = int(nz[0]) if "f" in trim else 0
    end = int(nz[-1]) + 1 if "b" in trim else filt.shape[0]
    return filt[start:end]


def _unique_all(x):
    values, index, inverse, counts = _unique(
        x, return_index=True, return_inverse=True, return_counts=True)
    return values, index, inverse, counts


_OTHER_FNS.update({
    "apply_along_axis": _apply_along_axis, "argpartition": _argpartition,
    "partition": _partition, "array_equiv": _array_equiv,
    "choose": _choose, "compress": _compress,
    "convolve": lambda a, v, mode="full": _conv1d(a, v, mode, False),
    "correlate": lambda a, v, mode="valid": _conv1d(a, v, mode, True),
    "cumulative_sum": _cumulative_sum, "delete": _delete,
    "fill_diagonal": _fill_diagonal, "gradient": _gradient,
    "histogram": _histogram, "histogram2d": _histogram2d,
    "histogramdd": _histogramdd, "indices": _indices, "insert": _insert,
    "interp": _interp, "lexsort": _lexsort, "packbits": _packbits,
    "unpackbits": _unpackbits, "piecewise": _piecewise,
    "polyfit": _polyfit, "polyval": _polyval,
    "ravel_multi_index": _ravel_multi_index,
    "real_if_close": _real_if_close, "resize": _resize, "roots": _roots,
    "select": _select, "sort_complex": _sort_complex,
    "trim_zeros": _trim_zeros, "unique_all": _unique_all,
})


# quantiles and the floor division appear in _OTHER too
for _name in ("nanquantile", "nanpercentile"):
    _OTHER_FNS[_name] = _ops.NP_REDUCE[_name]
_OTHER_FNS["floor_divide"] = _BINARY_FNS["floor_divide"]


# -- generation -------------------------------------------------------------------

def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)) and builtins.any(
            isinstance(v, NDArray) for v in x):
        return type(x)(_unwrap(v) for v in x)
    return x


def _fix_kwargs(kwargs):
    for key in ("ctx", "device"):
        kwargs.pop(key, None)
    if kwargs.get("out", 0) is None:
        kwargs.pop("out")
    if "out" in kwargs:
        raise NotImplementedError("out= is not supported; assign the result")
    return kwargs


def _operand(a, device, weak=False):
    """A tensor from an operand of an elementwise function; host arrays
    take the creation defaults. A Python scalar stays one where ``weak``
    (:mod:`..ops.promote` decides what it promotes to), else it becomes a
    0-dim tensor of the JAX package's default dtype for it."""
    if isinstance(a, torch.Tensor) or (weak and _promote.is_weak(a)):
        return a
    if isinstance(a, (list, tuple, _np.ndarray)):
        return _nd_array(a, device=device)._data
    return torch.full((), a, dtype=_promote.result_dtype(a),
                      device=creation_device(device))


def _generated(fn, name, binary=False):
    """An ``mx.np`` function from ``fn`` over tensors (multiarray.py
    _wrap_jnp). The operands of an elementwise function that are not
    tensors go to the device of the one that is (or the current device);
    its ``dtype`` keyword casts the result."""
    n_operands = 2 if binary else 1 if name in _UNARY_FNS else 0
    weak = binary and (name in _PROMOTED or name == "ldexp")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        kwargs = _fix_kwargs(dict(kwargs))
        dtype = kwargs.pop("dtype", None) if n_operands else None
        args = [_unwrap(a) for a in args]
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        if n_operands:
            dev = next((a.device for a in args[:n_operands]
                        if isinstance(a, torch.Tensor)), None)
            args[:n_operands] = [_operand(a, dev, weak and dev is not None)
                                 for a in args[:n_operands]]

        def call():
            out = fn(*args, **kwargs)
            if dtype is not None:
                out = out.to(normalize_dtype(dtype))
            return out

        return apply_op(call)

    wrapped.__name__ = name
    wrapped.__qualname__ = name
    return wrapped


__all__ = ["ndarray", "array", "zeros", "ones", "full", "arange",
           "zeros_like", "ones_like", "full_like", "linspace", "dtype", "pi", "e", "inf", "nan", "newaxis", "euler_gamma",
           "float16", "float32", "float64", "bfloat16", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "put_along_axis", "einsum",
           "concat", "fix", "round_", "MISSING"]

_g = globals()
#: names of the JAX package's lists that have a counterpart here
GENERATED = {}
for _names, _fns, _binary in ((_UNARY, _UNARY_FNS, False),
                              (_BINARY, _BINARY_FNS, True),
                              (_REDUCE, _REDUCE_FNS, False),
                              (_OTHER, _OTHER_FNS, False)):
    for _name in _names:
        if _name in _fns and _name not in GENERATED:
            GENERATED[_name] = _g[_name] = _generated(_fns[_name], _name,
                                                      _binary)
            __all__.append(_name)
#: names of the JAX package's lists still without a counterpart
MISSING = sorted({n for n in _UNARY + _BINARY + _REDUCE + _OTHER
                  if n not in GENERATED
                  and n not in ("put_along_axis", "einsum")})
del _names, _fns, _binary, _name

concat = concatenate  # noqa: F821 - generated above
fix = trunc  # noqa: F821
round_ = round  # noqa: F821


def einsum(subscripts, *operands, **kwargs):
    """Einstein summation over the operands."""
    _fix_kwargs(kwargs)
    ops = [_unwrap(o) for o in operands]
    return apply_op(lambda: torch.einsum(subscripts, *ops))


def put_along_axis(arr, indices, values, axis):
    """numpy's in-place ``put_along_axis``: the new array is computed out of
    place and swapped into ``arr`` (multiarray.py:put_along_axis)."""
    idx = _unwrap(indices).long()

    def put(a, v=values):
        v = torch.as_tensor(v, dtype=a.dtype, device=a.device)
        return a.scatter(axis, idx, v.expand(idx.shape).contiguous())

    out = apply_op(put, arr, values) if isinstance(values, NDArray) \
        else apply_op(put, arr)
    arr._assign(out._data)


# -- dtypes ---------------------------------------------------------------------
float16 = _np.float16
float32 = _np.float32
float64 = _np.float64
int8 = _np.int8
int16 = _np.int16
int32 = _np.int32
int64 = _np.int64
uint8 = _np.uint8
bool_ = _np.bool_
bfloat16 = torch.bfloat16
dtype = _np.dtype


# -- creation (honors the device scope) -------------------------------------------

def _device_of(kwargs):
    dev = kwargs.pop("device", None)
    if dev is None:
        dev = kwargs.pop("ctx", None)
    return creation_device(dev)


def _float_default(dtype):
    if dtype is not None:
        return normalize_dtype(dtype)
    from ..numpy_extension import default_float_dtype

    return normalize_dtype(default_float_dtype())


def array(object, dtype=None, **kwargs):  # noqa: A002 - numpy's name
    """An array on the current device (multiarray.py:359): Python lists
    give float32, float64 gives float32 and int64 gives int32 unless
    ``dtype`` says otherwise; in pinned host memory for ``cpu_pinned()``."""
    dev = kwargs.pop("device", None)
    return _nd_array(object, dtype=dtype,
                     device=dev if dev is not None else kwargs.pop("ctx",
                                                                    None))




def _creation(factory):
    def create(shape, dtype=None, order="C", **kwargs):  # noqa: ARG001
        dev = _device_of(kwargs)
        return NDArray(factory(shape, dtype=_float_default(dtype),
                               device=dev))
    create.__name__ = factory.__name__
    return create


zeros = _creation(torch.zeros)
ones = _creation(torch.ones)


def full(shape, fill_value, dtype=None, order="C", **kwargs):  # noqa: ARG001
    """A Python-int fill gives int32 and a float fill float32, unless
    ``dtype`` says otherwise."""
    dev = _device_of(kwargs)
    if isinstance(fill_value, NDArray):
        fill_value = fill_value._data
    if dtype is None and isinstance(fill_value, builtins.bool):
        dtype = torch.bool
    elif dtype is None and isinstance(fill_value, int):
        from ..numpy_extension import default_int_dtype

        dtype = default_int_dtype()
    elif dtype is None and not isinstance(fill_value, torch.Tensor):
        dtype = _float_default(None)
    if isinstance(fill_value, torch.Tensor):
        return NDArray(fill_value.to(dev, normalize_dtype(dtype)
                                     if dtype is not None
                                     else fill_value.dtype)
                       .expand(shape).clone())
    return NDArray(torch.full(shape if not isinstance(shape, int)
                              else (shape,), fill_value,
                              dtype=normalize_dtype(dtype), device=dev))


def zeros_like(a, dtype=None, **kwargs):  # noqa: ARG001
    return NDArray(torch.zeros_like(_unwrap(a).detach(),
                                    dtype=normalize_dtype(dtype)
                                    if dtype is not None else None))


def ones_like(a, dtype=None, **kwargs):  # noqa: ARG001
    return NDArray(torch.ones_like(_unwrap(a).detach(),
                                   dtype=normalize_dtype(dtype)
                                   if dtype is not None else None))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, **kwargs):  # noqa: ARG001 - scalar bounds, axis 0
    """``num`` evenly spaced values from ``start`` to ``stop`` (its end
    included with ``endpoint``), computed in float64 and rounded to the
    default float dtype (multiarray.py:448); ``retstep`` also returns the
    step."""
    dev = _device_of(kwargs)
    step = (stop - start) / ((num - 1) if endpoint else num) if num > 1 \
        else 0.0
    out = start + step * torch.arange(num, dtype=torch.float64, device=dev)
    if endpoint and num > 1:
        out[-1] = stop
    out = NDArray(out.to(_float_default(dtype)))
    return (out, step) if retstep else out


def full_like(a, fill_value, dtype=None, **kwargs):  # noqa: ARG001
    return NDArray(torch.full_like(_unwrap(a).detach(), fill_value,
                                   dtype=normalize_dtype(dtype)
                                   if dtype is not None else None))




def arange(start, stop=None, step=1, dtype=None, **kwargs):
    """float32 by default, even for int arguments (multiarray.py:433);
    under ``npx.set_np(dtype=True)`` numpy's own defaults."""
    dev = _device_of(kwargs)
    if stop is None:
        start, stop = 0, start
    if dtype is None:
        from ..numpy_extension import is_np_default_dtype

        if is_np_default_dtype():
            ints = builtins.all(isinstance(v, int)
                                for v in (start, stop, step))
            dtype = torch.int64 if ints else torch.float64
        else:
            dtype = torch.float32
    return NDArray(torch.arange(start, stop, step,
                                dtype=normalize_dtype(dtype), device=dev))


# -- the rest of the JAX package's mx.np (multiarray.py:330-605) ---------------

uint16 = _np.uint16
uint32 = _np.uint32
uint64 = _np.uint64
_g["bool"] = _np.bool_

NAN = NaN = nan
NINF = -_np.inf
PINF = _np.inf
NZERO = -0.0
PZERO = 0.0

boolean_dtypes = (_np.bool_,)
integer_dtypes = (_np.int8, _np.int16, _np.int32, _np.int64,
                  _np.uint8, _np.uint16, _np.uint32, _np.uint64)
floating_dtypes = (_np.float16, _np.float32, _np.float64)
numeric_dtypes = integer_dtypes + floating_dtypes

row_stack = vstack  # noqa: F821 - generated above
empty = zeros


def empty_like(a, dtype=None, **kwargs):
    """Zeros: the JAX package has no uninitialized buffers either."""
    return zeros_like(a, dtype=dtype, **kwargs)


def asarray(a, dtype=None, **kwargs):
    """``a`` itself when it is an NDArray of ``dtype`` (or no dtype is
    asked), else :func:`array` of it."""
    if isinstance(a, NDArray) and (
            dtype is None or a._data.dtype == normalize_dtype(dtype)):
        return a
    return array(a, dtype=dtype, **kwargs)


ascontiguousarray = asarray


def frombuffer(buffer, dtype=float, **kwargs):
    return array(_np.frombuffer(buffer, dtype=dtype), **kwargs)


def genfromtxt(*args, **kwargs):
    return array(_np.genfromtxt(*args, **kwargs))


def copy(a):
    return a.copy() if isinstance(a, NDArray) else array(a)


def astype(a, dtype):
    return a.astype(dtype)


def shape(a):
    return a.shape if isinstance(a, NDArray) else _np.shape(a)


def ndim(a):
    return a.ndim if isinstance(a, NDArray) else _np.ndim(a)


def size(a, axis=None):
    if isinstance(a, NDArray):
        return a.size if axis is None else a.shape[axis]
    return _np.size(a, axis)


def may_share_memory(a, b, max_work=None):  # noqa: ARG001
    """Whether the two arrays' storage overlaps (a view shares its base's
    storage in the port; the JAX package answers whether they are the same
    buffer)."""
    if not (isinstance(a, NDArray) and isinstance(b, NDArray)):
        return _np.may_share_memory(a, b)
    sa, sb = a._data.untyped_storage(), b._data.untyped_storage()
    if sa.device != sb.device:
        return False
    pa, pb = sa.data_ptr(), sb.data_ptr()
    return pa < pb + sb.nbytes() and pb < pa + sa.nbytes()


shares_memory = may_share_memory


def set_printoptions(*args, **kwargs):
    _np.set_printoptions(*args, **kwargs)


def from_dlpack(x):
    """An NDArray sharing ``x``'s memory through DLPack."""
    return NDArray(torch.from_dlpack(x))


def _dtype_of(x):
    if isinstance(x, (NDArray, torch.Tensor, _np.ndarray, _np.generic)):
        x = x.dtype
    if isinstance(x, torch.dtype) or x is bfloat16 or x == "bfloat16":
        return torch.bfloat16 if x in (torch.bfloat16, "bfloat16") else x
    return _np.dtype(x)


def finfo(dtype):
    """Machine limits of a float dtype (``torch.finfo`` for bfloat16)."""
    dt = _dtype_of(dtype)
    if isinstance(dt, torch.dtype):
        return torch.finfo(dt)
    return _np.finfo(dt)


def iinfo(dtype):
    dt = _dtype_of(dtype)
    if isinstance(dt, torch.dtype):
        return torch.iinfo(dt)
    return _np.iinfo(dt)


def promote_types(type1, type2):
    """``jnp.promote_types``: an integer or bool with a float gives the
    float, bfloat16 with float16 gives float32; otherwise numpy's
    lattice."""
    a, b = _dtype_of(type1), _dtype_of(type2)
    if torch.bfloat16 in (a, b):
        other = b if a is torch.bfloat16 else a
        if other is torch.bfloat16 or other.kind in "biu":
            return bfloat16
        if other == _np.float16:
            return _np.dtype(_np.float32)
        return other
    if a.kind in "biu" and b.kind in "fc":
        return b
    if b.kind in "biu" and a.kind in "fc":
        return a
    return _np.promote_types(a, b)


def result_type(*arrays_and_dtypes):
    """``jnp.result_type``: :func:`promote_types` over the arguments; a
    Python int or float is weak (promote.result_dtype)."""
    strong = [x for x in arrays_and_dtypes if not _promote.is_weak(x)]
    weak = [x for x in arrays_and_dtypes if _promote.is_weak(x)]
    dt = functools.reduce(promote_types, [_dtype_of(x) for x in strong]) \
        if strong else None
    for x in weak:
        if isinstance(x, float):
            if dt is None or dt is not bfloat16 and dt.kind not in "fc":
                dt = _np.dtype(_np.float64)
        elif dt is None or dt is not bfloat16 and dt.kind == "b":
            dt = _np.dtype(_np.int64)
    return dt


def can_cast(from_, to, casting="safe"):
    return _np.can_cast(_dtype_of(from_), _dtype_of(to), casting)


def diag_indices_from(arr):
    a = _unwrap(arr)
    return tuple(NDArray(i) for i in _diag_indices(a.shape[0], a.dim()))


def tril_indices_from(arr, k=0):
    a = _unwrap(arr)
    ij = torch.tril_indices(a.shape[-2], a.shape[-1], k, device=a.device)
    return NDArray(ij[0]), NDArray(ij[1])


def triu_indices_from(arr, k=0):
    a = _unwrap(arr)
    ij = torch.triu_indices(a.shape[-2], a.shape[-1], k, device=a.device)
    return NDArray(ij[0]), NDArray(ij[1])


def _window(fn):
    def window(M, dtype=None, **kwargs):  # noqa: N803 - numpy's name
        return array(fn(M), dtype=dtype or _np.float32, **kwargs)
    window.__name__ = window.__qualname__ = fn.__name__
    return window


blackman = _window(_np.blackman)
hamming = _window(_np.hamming)
hanning = _window(_np.hanning)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, **kwargs):  # noqa: ARG001 - scalar bounds, axis 0
    """``base ** linspace(start, stop)``, computed in ``dtype`` by
    ``jnp.linspace``'s formula (jnp.logspace)."""
    dev = _device_of(kwargs)
    dt = normalize_dtype(dtype)
    ct = _promote.inexact_dtype(dt)
    lin = _lin(start, stop, num, endpoint, ct, dev)
    return NDArray(torch.pow(torch.tensor(base, dtype=ct, device=dev),
                             lin).to(dt))


def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              **kwargs):  # noqa: ARG001
    """Geometric steps from ``start`` to ``stop`` (jnp.geomspace: the
    sign of ``start`` times :func:`logspace` of the log10s)."""
    dev = _device_of(kwargs)
    dt = normalize_dtype(dtype)
    ct = _promote.inexact_dtype(dt)
    start = torch.as_tensor(start, dtype=ct, device=dev)
    stop = torch.as_tensor(stop, dtype=ct, device=dev)
    sign = torch.sign(start)
    lin = _lin(torch.log10(start / sign), torch.log10(stop / sign), num,
               endpoint, ct, dev)
    return NDArray((sign * torch.pow(torch.tensor(10.0, dtype=ct,
                                                  device=dev), lin)).to(dt))


def _block_tensor(arrays):
    """numpy's ``block`` over nested lists of tensors: the innermost lists
    join along the last axis, each outer level along the one before."""
    def depth(x):
        return 1 + depth(x[0]) if isinstance(x, list) else 0

    def leaves(x):
        return [t for e in x for t in leaves(e)] if isinstance(x, list) \
            else [x]

    d = depth(arrays)
    nd = builtins.max([d] + [t.dim() for t in leaves(arrays)])

    def build(x, level):
        if isinstance(x, list):
            return torch.cat([build(e, level + 1) for e in x],
                             dim=-(d - level))
        return x.reshape((1,) * (nd - x.dim()) + tuple(x.shape))

    return build(arrays, 0)


def block(arrays):
    """numpy's ``block``: arrays assembled from nested lists."""
    def unwrap(x):
        if isinstance(x, list):
            return [unwrap(e) for e in x]
        return _unwrap(x) if isinstance(x, NDArray) else torch.as_tensor(x)

    flat = []

    def collect(x):
        if isinstance(x, list):
            for e in x:
                collect(e)
        elif isinstance(x, NDArray):
            flat.append(x)

    collect(arrays)
    return apply_op(lambda *_: _block_tensor(unwrap(arrays)), *flat)


def _float_default_wrap(fn):
    """``fn`` with the default float dtype where no dtype is given, by
    keyword or by position (multiarray.py:578)."""
    import inspect

    params = list(inspect.signature(fn).parameters)
    pos = params.index("dtype") if "dtype" in params else None

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if "dtype" not in kwargs and (pos is None or len(args) <= pos):
            from ..numpy_extension import default_float_dtype

            kwargs["dtype"] = default_float_dtype()
        return fn(*args, **kwargs)

    return wrapped


for _name in ("eye", "identity", "linspace", "logspace", "geomspace",
              "tri", "hanning", "hamming", "blackman"):
    _g[_name] = _float_default_wrap(_g[_name])
del _name

__all__ += ["uint16", "uint32", "uint64", "bool", "NAN", "NaN", "NINF",
            "PINF", "NZERO", "PZERO", "boolean_dtypes", "integer_dtypes",
            "floating_dtypes", "numeric_dtypes", "row_stack", "empty",
            "empty_like", "asarray", "ascontiguousarray", "frombuffer",
            "genfromtxt", "copy", "astype", "shape", "ndim", "size",
            "may_share_memory", "shares_memory", "set_printoptions",
            "from_dlpack", "finfo", "iinfo", "promote_types", "result_type",
            "can_cast", "diag_indices_from", "tril_indices_from",
            "triu_indices_from", "blackman", "hamming", "hanning",
            "logspace", "geomspace", "block"]
