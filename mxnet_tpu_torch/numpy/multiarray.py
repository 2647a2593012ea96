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

from ..base import normalize_dtype
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


def _pad(array, pad_width, mode="constant", constant_values=0):
    if mode != "constant":
        raise NotImplementedError(f"pad mode {mode!r} is not ported; only "
                                  "'constant'")
    pw = _np.broadcast_to(_np.asarray(pad_width, dtype=_np.int64),
                          (array.dim(), 2))
    flat = [int(v) for pair in pw[::-1] for v in pair]
    return torch.nn.functional.pad(array, flat, value=constant_values)


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
                  if n not in GENERATED and n not in ("put_along_axis",
                                                      "einsum")})
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
    ``dtype`` says otherwise."""
    return _nd_array(object, dtype=dtype, device=_device_of(kwargs))




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
