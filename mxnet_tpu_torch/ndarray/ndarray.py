"""NDArray over a ``torch.Tensor`` (counterpart of
mxnet_tpu/ndarray/ndarray.py:46).

The array is a thin handle: one ``_data`` slot holds the tensor, and every
op unwraps its NDArray arguments, runs a torch function on the tensors
(:func:`apply_op`) and wraps what comes back. It is composition, not a
``torch.Tensor`` subclass, so no ``__torch_function__`` sits on the path of
the torch calls themselves.

Recording follows the JAX package: :func:`apply_op` records only inside
``autograd.record()`` (through ``torch.set_grad_enabled``, as
``Block.__call__`` does); outside it nothing is kept for backward.
``attach_grad`` gives the array a gradient buffer that ``backward`` fills by
``grad_req`` ('write' or 'add'), through ``autograd.mark_variables``.

Mutation swaps the handle, as the JAX package's does (``ndarray.py:598-620``,
``:715``): ``a[k] = v``, ``a += b`` and the like compute a new tensor out of
place, put it in ``_data`` and bump ``_version``. A tensor that autograd
saved for backward is never written, so ``backward`` after an in-place
NDArray op does not fail on torch's version check; an array with a
gradient buffer stays a variable across such a write.
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from .. import _checkpoint_io
from .. import autograd as _ag
from ..base import normalize_dtype, numpy_dtype
from ..device import current_device, is_pinned, pin, resolve
from ..ops import promote as _promote
from ..ops import tensor as _ops

__all__ = ["NDArray", "apply_op", "array", "waitall"]

# the arithmetic operators: jnp.add ... jnp.power as the JAX package's
# NDArray calls them (ndarray.py:_binary), dtypes from ops/promote.py
_ADD = _promote.binary(torch.add)
_SUB = _promote.binary(torch.sub)
_MUL = _promote.binary(torch.mul)
_DIV = _promote.binary(torch.true_divide, "inexact")
_FLOORDIV = _promote.binary(torch.floor_divide, "numeric")
_MOD = _promote.binary(torch.remainder, "numeric")
_POW = _promote.binary(torch.pow, "power")


class NDArray:
    """A mutable n-dim array over one ``torch.Tensor``."""

    __array_priority__ = 1000.0
    __slots__ = ("_data", "_grad", "_grad_req", "_version", "__weakref__")

    def __init__(self, data):
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._version = 0

    # -- metadata ------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``torch.bfloat16``, which numpy lacks, as is)."""
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def device(self):
        return self._data.device

    ctx = device
    context = device

    @property
    def stype(self):
        return "default"

    def tostype(self, stype):
        """This array in storage ``stype``: 'default' is itself, 'csr' and
        'row_sparse' the sparse arrays of ndarray/sparse.py, made on its
        device."""
        if stype == "default":
            return self
        from .sparse import cast_storage

        return cast_storage(self, stype)

    @property
    def grad(self):
        return self._grad

    # -- sync and host transfer ----------------------------------------------
    def wait_to_read(self):
        """Wait until the array's value is computed: a sync of the current
        stream of its card (nothing to wait for on the CPU)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A host numpy copy; bfloat16 comes back as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def item(self):
        return self._data.item()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.item()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.item())
        raise ValueError("The truth value of an array with more than one "
                         "element is ambiguous")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return f"{self.asnumpy()!r} <NDArray {self.shape} @{self.device}>"

    # -- numpy's protocols: numpy functions and ufuncs of NDArrays run as
    # the mx.np functions of the same name (ndarray.py:236, :260) --------------
    _NOOP_KWARGS = ("out", "where", "casting", "order", "subok",
                    "signature")

    @staticmethod
    def _np_impl(name):
        from .. import numpy as _mxnp

        fn = getattr(_mxnp, name, None)
        if fn is None:
            fn = getattr(_mxnp.linalg, name, None)
        return fn

    @staticmethod
    def _write_out(result, out):
        """``result`` into numpy's ``out=`` buffer, an NDArray or a numpy
        array of the result's shape."""
        target = out[0] if isinstance(out, tuple) else out
        rdata = result._data if isinstance(result, NDArray) \
            else torch.as_tensor(result)
        if tuple(rdata.shape) != tuple(target.shape):
            raise ValueError(
                f"non-broadcastable output operand with shape "
                f"{tuple(target.shape)} doesn't match the result shape "
                f"{tuple(rdata.shape)}")
        if isinstance(target, NDArray):
            target._assign(rdata.to(target._data.dtype))
            return target
        _np.copyto(target, NDArray(rdata).asnumpy().astype(target.dtype))
        return target

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """``numpy.exp(a)``, ``onp_array + a``: the ``mx.np`` function of
        the ufunc's name, on the arrays' device (ndarray.py:236). A method
        other than a call, a keyword other than ``axis``, a ufunc that
        ``mx.np`` lacks or an ``out=`` of another kind is NotImplemented."""
        if method != "__call__":
            return NotImplemented
        out = kwargs.pop("out", None)
        if out is not None:
            target = out[0] if isinstance(out, tuple) else out
            if not isinstance(target, (NDArray, _np.ndarray)):
                return NotImplemented
        for k in NDArray._NOOP_KWARGS:
            if kwargs.get(k) is None:
                kwargs.pop(k, None)
        dtype = kwargs.pop("dtype", None)
        if set(kwargs) - {"axis"}:
            return NotImplemented
        fn = NDArray._np_impl(ufunc.__name__)
        if fn is None:
            return NotImplemented
        result = fn(*inputs, **kwargs)
        if dtype is not None and isinstance(result, NDArray):
            result = result.astype(dtype)
        if out is not None:
            return NDArray._write_out(result, out)
        return result

    def __array_function__(self, func, types, args, kwargs):
        """``numpy.concatenate([a, b])``, ``numpy.mean(a)``: the ``mx.np``
        (or ``mx.np.linalg``) function of the same name (ndarray.py:260).
        A function ``mx.np`` lacks, an argument of another framework or an
        ``out=`` of another kind is NotImplemented."""
        if not all(issubclass(t, (NDArray, _np.ndarray))
                   or t in (int, float, bool, list, tuple) for t in types):
            return NotImplemented
        fn = NDArray._np_impl(func.__name__)
        if fn is None:
            return NotImplemented
        kwargs = dict(kwargs)
        out = kwargs.pop("out", None)
        if out is not None and not isinstance(
                out[0] if isinstance(out, tuple) else out,
                (NDArray, _np.ndarray)):
            return NotImplemented
        for k in NDArray._NOOP_KWARGS:
            if kwargs.get(k) is None:
                kwargs.pop(k, None)
        result = fn(*args, **kwargs)
        if out is not None:
            return NDArray._write_out(result, out)
        return result

    def __dlpack__(self, **kwargs):
        return self._data.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def tolist(self):
        return self.asnumpy().tolist()

    # -- autograd --------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):  # noqa: ARG002
        """Attach a zero gradient buffer that ``backward`` fills by
        ``grad_req`` ('write' replaces it, 'add' accumulates). On an array
        computed inside ``record()`` the buffer retains the gradient that
        flows through it, and the flow goes on (ndarray.py:290). The buffer
        is dense whatever ``stype`` says, as in the JAX package."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError(
                f"grad_req must be 'write', 'add' or 'null', got {grad_req!r}")
        self._grad = NDArray(torch.zeros_like(self._data.detach()))
        self._grad_req = grad_req
        self._mark()
        return self

    def _mark(self):
        t, buf, req = self._data, self._grad._data, self._grad_req
        if t.grad_fn is None:
            _ag.mark_variables(t, buf, req)
        elif req != "null":
            def land(g):
                with torch.no_grad():
                    if req == "add":
                        buf.add_(g)
                    else:
                        buf.copy_(g)
            t.register_hook(land)

    def drop_grad(self):
        if self._grad is not None and self._data.grad_fn is None:
            _ag.mark_variables(self._data, self._grad._data, "null")
        self._grad = None
        self._grad_req = "null"

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Backward from this array; a head without ``out_grad`` gets ones,
        whatever its shape (autograd.backward)."""
        _ag.backward(self, out_grad, retain_graph=retain_graph,
                     train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # -- in-place writes swap the handle -----------------------------------
    def _assign(self, data):
        self._data = data
        self._version += 1
        if self._grad is not None and data.grad_fn is None:
            self._mark()   # a fresh leaf stays a variable

    # -- copies and device movement -------------------------------------------
    def as_in_context(self, device):
        return self.as_in_ctx(device)

    def as_in_ctx(self, device):
        if is_pinned(device):
            t = self._data
            if t.device.type == "cpu" and (not torch.cuda.is_available()
                                           or t.is_pinned()):
                return self
            return self.copyto(device)
        if self.device == torch.device(device):
            return self
        return self.copyto(device)

    to_device = as_in_ctx

    def copyto(self, other):
        """A copy on a device (pinned host memory for ``cpu_pinned()``), or
        a copy written into another NDArray."""
        if isinstance(other, NDArray):
            other._assign(self._data.detach().to(other.device, copy=True))
            return other
        if is_pinned(other):
            return NDArray(pin(self._data.detach().to("cpu", copy=True)))
        return NDArray(self._data.detach().to(torch.device(other),
                                              copy=True))

    def copy(self):
        return apply_op(torch.clone, self)

    def astype(self, dtype, copy=True):
        dtype = normalize_dtype(dtype)
        if not copy and self._data.dtype == dtype:
            return self
        return apply_op(lambda x: x.to(dtype, copy=True), self)

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    # -- shape -----------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """numpy's reshape, and on the method the reference's codes too: 0
        copies a dim, -2 the rest, -3 merges two, -4 splits one, ``reverse``
        reads right to left (ndarray.py:376)."""
        reverse = bool(kwargs.pop("reverse", False))
        if not shape and "shape" in kwargs:
            shape = (kwargs.pop("shape"),)
        kwargs.pop("order", None)
        if kwargs:
            raise TypeError(f"reshape got unexpected kwargs {sorted(kwargs)}")
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(d) for d in shape)
        if reverse or any(d in (-2, -3, -4) for d in shape) \
                or (0 in shape and self.size != 0):
            shape = _ops.legacy_reshape_shape(self.shape, shape, reverse)
        return apply_op(lambda x: x.reshape(shape), self)

    def transpose(self, *axes, **kwargs):
        if not axes and kwargs.get("axes") is not None:
            axes = (kwargs.pop("axes"),)
        else:
            kwargs.pop("axes", None)
        if kwargs:
            raise TypeError(f"transpose got unexpected kwargs {sorted(kwargs)}")
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        axes = axes or tuple(range(self.ndim - 1, -1, -1))
        return apply_op(lambda x: x.permute(*axes), self)

    @property
    def T(self):  # noqa: N802
        return self.transpose()

    def flatten(self):
        return self.reshape((-1,))

    def squeeze(self, axis=None):
        return apply_op(lambda x: _ops.squeeze(x, axis), self)

    def expand_dims(self, axis):
        return apply_op(lambda x: x.unsqueeze(axis), self)

    def swapaxes(self, a1, a2):
        return apply_op(lambda x: x.transpose(a1, a2), self)

    def repeat(self, repeats, axis=None):
        return apply_op(lambda x: torch.repeat_interleave(x, repeats, axis),
                        self)

    def split(self, indices_or_sections=None, axis=None, num_outputs=None,
              squeeze_axis=False):
        """numpy's split (``indices_or_sections``, axis 0 by default), or
        the legacy one (``num_outputs``, ``squeeze_axis``, axis 1 by
        default) (ndarray.py:438)."""
        if num_outputs is not None:
            from .. import ndarray as _nd

            return _nd.split(self, num_outputs=num_outputs,
                             axis=1 if axis is None else axis,
                             squeeze_axis=squeeze_axis)
        if squeeze_axis:
            raise TypeError(
                "split: squeeze_axis requires the legacy num_outputs= "
                "spelling (a.split(num_outputs=2, squeeze_axis=True))")
        from ..numpy import split

        return split(self, indices_or_sections, 0 if axis is None else axis)

    def take(self, indices, axis=None, mode="clip"):
        """``jnp.take`` with the legacy default mode 'clip'; float indices
        are cast to int32 (ndarray.py:465)."""
        from ..numpy.multiarray import _take

        def pure(x, i):
            i = torch.as_tensor(i, device=x.device)
            if i.is_floating_point():
                i = i.to(torch.int32)
            return _take(x, i, axis, mode)

        return apply_op(pure, self, indices)

    def norm(self, ord=None, axis=None, keepdims=False):  # noqa: A002
        """``np.linalg.norm`` of the array (ndarray.py:563)."""
        from ..numpy import linalg

        return linalg.norm(self, ord=ord, axis=axis, keepdims=keepdims)

    def broadcast_to(self, shape):
        return apply_op(lambda x: x.expand(tuple(shape)), self)

    def clip(self, a_min=None, a_max=None):
        return apply_op(lambda x: _ops.clip(x, a_min, a_max), self)

    def zeros_like(self):
        return NDArray(torch.zeros_like(self._data.detach()))

    def ones_like(self):
        return NDArray(torch.ones_like(self._data.detach()))

    # -- reductions and math (numpy semantics, ops/tensor.py) ---------------
    def _reduce(self, name, **kwargs):
        return apply_op(lambda x: _ops.NP_REDUCE[name](x, **kwargs), self)

    def sum(self, axis=None, keepdims=False, dtype=None):
        return self._reduce("sum", axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, axis=None, keepdims=False, dtype=None):
        return self._reduce("mean", axis=axis, keepdims=keepdims, dtype=dtype)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        return self._reduce("any", axis=axis, keepdims=keepdims)

    def all(self, axis=None, keepdims=False):
        return self._reduce("all", axis=axis, keepdims=keepdims)

    def argmax(self, axis=None):
        return self._reduce("argmax", axis=axis)

    def argmin(self, axis=None):
        return self._reduce("argmin", axis=axis)

    def std(self, axis=None, ddof=0, keepdims=False):
        return self._reduce("std", axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return self._reduce("var", axis=axis, ddof=ddof, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None):
        return apply_op(lambda x: _ops.cumulate("cumsum")(x, axis, dtype),
                        self)

    def dot(self, other):
        return apply_op(_ops.np_dot, self, other)

    def abs(self):
        return apply_op(torch.abs, self)

    def sqrt(self):
        return apply_op(torch.sqrt, self)

    def exp(self):
        return apply_op(torch.exp, self)

    def log(self):
        return apply_op(torch.log, self)

    def round(self, decimals=0):
        return apply_op(lambda x: torch.round(x, decimals=decimals), self)

    def sigmoid(self):
        return apply_op(torch.sigmoid, self)

    def relu(self):
        return apply_op(torch.relu, self)

    def tanh(self):
        return apply_op(torch.tanh, self)

    # -- indexing --------------------------------------------------------------
    @staticmethod
    def _key_part(k):
        if isinstance(k, NDArray):
            k = k._data
        elif isinstance(k, _np.ndarray):
            k = torch.from_numpy(k)
        if isinstance(k, torch.Tensor) and not (
                k.dtype == torch.bool or not k.is_floating_point()):
            k = k.long()   # float index arrays cast, as the reference does
        return k

    def _index(self, key):
        if isinstance(key, tuple):
            return tuple(self._key_part(k) for k in key)
        return self._key_part(key)

    def __getitem__(self, key):
        key = self._index(key)
        return apply_op(lambda x: x[key], self)

    def __setitem__(self, key, value):
        """``a[key] = value``: a new tensor with the slice written, swapped
        in with a ``_version`` bump (ndarray.py:598)."""
        key = self._index(key)

        def put(x, v=value):
            out = x.clone()
            if isinstance(v, torch.Tensor):
                v = v.to(out.dtype)
            elif isinstance(v, _np.ndarray):
                v = torch.from_numpy(v).to(out.device, out.dtype)
            out[key] = v
            return out

        new = apply_op(put, self, value) if isinstance(value, NDArray) \
            else apply_op(put, self)
        self._assign(new._data)

    # -- operators ---------------------------------------------------------------
    def _binary(self, other, fn, reverse=False):
        """``fn(self, other)`` (``fn(other, self)`` when ``reverse``).
        The arithmetic operators pass :mod:`..ops.promote` functions, which
        keep a Python scalar weak and give the JAX package's dtype."""
        if isinstance(other, NDArray):
            return apply_op(fn, other, self) if reverse \
                else apply_op(fn, self, other)
        if isinstance(other, _np.ndarray):
            other = _host_to_tensor(other, None, self.device)
        if reverse:
            return apply_op(lambda x: fn(other, x), self)
        return apply_op(lambda x: fn(x, other), self)

    def __add__(self, o):
        return self._binary(o, _ADD)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, _SUB)

    def __rsub__(self, o):
        return self._binary(o, _SUB, reverse=True)

    def __mul__(self, o):
        return self._binary(o, _MUL)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, _DIV)

    def __rtruediv__(self, o):
        return self._binary(o, _DIV, reverse=True)

    def __floordiv__(self, o):
        return self._binary(o, _FLOORDIV)

    def __rfloordiv__(self, o):
        return self._binary(o, _FLOORDIV, reverse=True)

    def __mod__(self, o):
        return self._binary(o, _MOD)

    def __rmod__(self, o):
        return self._binary(o, _MOD, reverse=True)

    def __pow__(self, o):
        return self._binary(o, _POW)

    def __rpow__(self, o):
        return self._binary(o, _POW, reverse=True)

    def __matmul__(self, o):
        return self._binary(o, lambda a, b: a @ b)

    def __rmatmul__(self, o):
        return self._binary(o, lambda a, b: a @ b, reverse=True)

    def __neg__(self):
        return apply_op(torch.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        return apply_op(torch.abs, self)

    def __invert__(self):
        return apply_op(torch.bitwise_not, self)

    def __eq__(self, o):
        return self._binary(o, lambda a, b: a == b)

    def __ne__(self, o):
        return self._binary(o, lambda a, b: a != b)

    def __lt__(self, o):
        return self._binary(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._binary(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._binary(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._binary(o, lambda a, b: a >= b)

    __hash__ = object.__hash__

    def __and__(self, o):
        return self._binary(o, lambda a, b: a & b)

    def __or__(self, o):
        return self._binary(o, lambda a, b: a | b)

    def __xor__(self, o):
        return self._binary(o, lambda a, b: a ^ b)

    def _inplace(self, other, fn):
        self._assign(self._binary(other, fn)._data)
        return self

    def __iadd__(self, o):
        return self._inplace(o, lambda a, b: a + b)

    def __isub__(self, o):
        return self._inplace(o, lambda a, b: a - b)

    def __imul__(self, o):
        return self._inplace(o, lambda a, b: a * b)

    def __itruediv__(self, o):
        return self._inplace(o, lambda a, b: a / b)

    def __imod__(self, o):
        return self._inplace(o, lambda a, b: a % b)

    def __getattr__(self, name):
        """Any ``mx.nd`` op as a method: ``a.broadcast_add(b)`` is
        ``mx.nd.broadcast_add(a, b)`` (ndarray.py:740)."""
        if name.startswith("_"):
            raise AttributeError(name)
        from .. import ndarray as _nd

        fn = getattr(_nd, name, None)
        if callable(fn):
            return functools.partial(fn, self)
        raise AttributeError(f"'NDArray' object has no attribute {name!r}")


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return out


def apply_op(fn, *args, name=None):  # noqa: ARG001 - the reference's signature
    """Run ``fn`` over the tensors of the NDArray arguments (other arguments
    pass through) and wrap the tensors it returns (ndarray.py:783). Torch
    records for backward only inside ``autograd.record()``."""
    datas = [a._data if isinstance(a, NDArray) else a for a in args]
    recording = _ag.is_recording()
    if torch.is_grad_enabled() == recording:
        return _wrap(fn(*datas))
    with torch.set_grad_enabled(recording):
        return _wrap(fn(*datas))


def creation_device(device=None):
    """``device`` as a ``torch.device``; None is the current device scope's
    (device.current_device: ``cuda:0`` outside any scope, or raises)."""
    return current_device() if device is None else resolve(device)


def _host_to_tensor(source, dtype, device):
    """A tensor on ``device`` from array-like host data with the creation
    defaults: a Python list or scalar gives the default float dtype,
    float64 gives float32 and int64 gives int32 (ndarray.py:854)."""
    from_numpy = isinstance(source, _np.ndarray)
    arr = _np.asarray(source)
    if dtype is None:
        if not from_numpy and arr.dtype.kind in "iuf":
            from ..numpy_extension import default_float_dtype

            dtype = default_float_dtype()
        elif arr.dtype == _np.float64:
            dtype = torch.float32
        elif arr.dtype == _np.int64:
            dtype = torch.int32
    # np.ascontiguousarray would make a 0-d array 1-d: a scalar keeps its
    # shape (), as in the JAX package
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = _np.array(arr, order="C")
    t = torch.from_numpy(arr)
    # one copy: the host array is never aliased
    return t.to(device=device, dtype=normalize_dtype(dtype)
                if dtype is not None else t.dtype, copy=True)


def array(source, dtype=None, device=None, ctx=None):
    """An NDArray on ``device`` (default: the current device) from an
    array-like, a tensor or an NDArray (ndarray.py:854); in pinned host
    memory for ``cpu_pinned()``."""
    requested = device if device is not None else ctx
    if is_pinned(requested):
        return NDArray(pin(array(source, dtype, torch.device("cpu"))._data))
    device = creation_device(requested)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
        if dtype is None and t.dtype in (torch.float64, torch.int64):
            dtype = torch.float32 if t.dtype == torch.float64 \
                else torch.int32
        return NDArray(t.to(device=device, dtype=normalize_dtype(dtype)
                            if dtype is not None else t.dtype, copy=True))
    return NDArray(_host_to_tensor(source, dtype, device))


def waitall():
    """Wait for all work queued on the card (ndarray.py:884) and for every
    checkpoint write still on an IO thread (``_checkpoint_io``, as the JAX
    package's ``engine.waitall`` drains its IO); the first failed write's
    error is raised here."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _checkpoint_io.flush_all()
    _checkpoint_io.reap_idle()  # all IO drained: drop per-path bookkeeping
