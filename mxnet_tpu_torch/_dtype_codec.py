"""npz round-trip codec for accelerator dtypes (the port's own copy of
mxnet_tpu/_dtype_codec.py, written for torch tensors).

numpy has no bfloat16, so ``.npz`` cannot hold a bfloat16 array as such.
The JAX package's format, which this module reads and writes bit for bit:
each exotic array is stored as a bit-equal unsigned-int view, and the true
dtypes go in one reserved JSON key (:data:`DTYPE_KEY`). A file with no
exotic array is byte-identical to a plain ``np.savez`` and loads with plain
numpy; a file without the key decodes unchanged.

The port needs neither ``ml_dtypes`` nor a numpy bfloat16: a bfloat16
tensor goes out as ``tensor.view(torch.int16)`` read as numpy ``uint16``,
and a ``uint16`` payload named ``bfloat16`` in the sidecar comes back as
``torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)``. The other
exotic dtypes of the JAX package (float8 variants, int4, ...) have no torch
counterpart here: decoding one raises with a message that names it.

Pickles (``Trainer.save_states``) carry numpy arrays, and the JAX package
pickles a bf16 leaf as an ``ml_dtypes`` array, whose pickle names the
global ``ml_dtypes.bfloat16``. :func:`pickle_load` reads such a payload
without ``ml_dtypes``: its unpickler maps that global to a stand-in and
rebuilds each bf16 array from its raw bits as a bf16 tensor; every other
array comes back as a numpy array. :func:`pickle_leaf` writes a bf16
tensor as ``numpy.ndarray.view(<its uint16 bits>, "bfloat16")``, which a
process that has imported ``ml_dtypes`` (the JAX package) unpickles to a
bf16 array, and :func:`pickle_load` to a bf16 tensor.
"""
from __future__ import annotations

import importlib
import json
import pickle

import numpy as _np
import torch

__all__ = ["DTYPE_KEY", "to_numpy", "host_bits", "encode_payload",
           "read_sidecar", "decode_entry", "decode_npz", "dtype_name",
           "pickle_leaf", "pickle_load"]

DTYPE_KEY = "__mx_npz_dtypes__"

#: torch dtypes stored as a uint view, by their name in the sidecar
_EXOTIC = {torch.bfloat16: "bfloat16"}


def to_numpy(t):
    """``(array, sidecar dtype name or None)`` of a tensor, on the host: an
    exotic tensor as its bit-equal ``uint`` view, any other as itself.
    The array is a copy that shares no memory with ``t``, made once: a
    card tensor's device-to-host copy (synchronous, after the work queued
    on the current stream) is that copy."""
    src = t.detach()
    host = src.cpu().contiguous()
    if host.data_ptr() == src.data_ptr() and host.numel():
        host = host.clone()
    return host_bits(host)


def host_bits(a):
    """``(array, sidecar dtype name or None)`` of a numpy array or a CPU
    tensor, without a copy: a bf16 tensor as a ``uint16`` view of its bits,
    any other tensor as its numpy view, an array as itself."""
    if not isinstance(a, torch.Tensor):
        return a, None
    a = a.detach().contiguous()
    name = _EXOTIC.get(a.dtype)
    if name is None:
        return a.numpy(), None
    return a.view(torch.int16).numpy().view(_np.uint16), name


def encode_payload(arrays, copy=True):
    """A dict safe for ``np.savez`` from ``{name: numpy array or tensor}``:
    exotic tensors become bit-equal ``uint`` views and their true dtypes
    land in the :data:`DTYPE_KEY` sidecar. Nothing exotic: the numpy
    arrays, with no sidecar (the file is a plain npz). Tensors are copied
    to the host (:func:`to_numpy`); with ``copy=False`` they must be CPU
    tensors that nothing changes until the file is written, and are read
    in place (:func:`host_bits`)."""
    if DTYPE_KEY in arrays:
        raise ValueError(f"{DTYPE_KEY!r} is a reserved checkpoint key")
    out, sidecar = {}, {}
    for k, a in arrays.items():
        if isinstance(a, torch.Tensor):
            a, name = to_numpy(a) if copy else host_bits(a)
            if name is not None:
                sidecar[k] = name
        out[k] = a
    if sidecar:
        out[DTYPE_KEY] = _np.frombuffer(
            json.dumps(sidecar).encode("utf-8"), dtype=_np.uint8)
    return out


def read_sidecar(npz):
    """The parsed :data:`DTYPE_KEY` entry of an open NpzFile (or dict);
    ``{}`` for a plain file."""
    files = getattr(npz, "files", None)
    keys = files if files is not None else npz.keys()
    if DTYPE_KEY not in keys:
        return {}
    return json.loads(bytes(npz[DTYPE_KEY]).decode("utf-8"))


def decode_entry(name, arr, sidecar):
    """One stored array with its true dtype: a numpy array, or a bfloat16
    tensor where the sidecar names ``bfloat16``. Another exotic dtype
    raises ``TypeError`` naming it."""
    dt_name = sidecar.get(name)
    if dt_name is None:
        return arr
    if dt_name != "bfloat16":
        raise TypeError(
            f"array {name!r} is stored as {dt_name}, which has no torch "
            f"dtype in the port; only bfloat16 is decoded")
    arr = _np.ascontiguousarray(arr)
    if arr.dtype != _np.uint16:
        raise TypeError(f"array {name!r}: a bfloat16 payload must be "
                        f"uint16, got {arr.dtype}")
    return torch.from_numpy(arr.view(_np.int16).copy()).view(torch.bfloat16)


def decode_npz(npz):
    """``{name: array}`` of an open NpzFile (or dict), true dtypes restored
    and the sidecar key left out."""
    sidecar = read_sidecar(npz)
    files = getattr(npz, "files", None)
    keys = files if files is not None else list(npz.keys())
    return {k: decode_entry(k, npz[k], sidecar)
            for k in keys if k != DTYPE_KEY}


def dtype_name(dtype):
    """The JAX package's name of a torch dtype: ``'float32'``,
    ``'bfloat16'``, ``'int32'`` (never ``'torch.float32'``)."""
    return str(dtype).removeprefix("torch.")


def _bf16_tensor(bits):
    """A bf16 tensor from a numpy array of its uint16 bits."""
    bits = _np.ascontiguousarray(bits).view(_np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


class _Bf16Leaf:
    """A bf16 tensor on its way into a pickle (:func:`pickle_leaf`)."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        self.bits = bits

    def __reduce__(self):
        return (_np.ndarray.view, (self.bits, "bfloat16"))


def pickle_leaf(t):
    """What a tensor pickles as: a numpy array, or for bf16 a leaf that
    unpickles to a bf16 array where ``ml_dtypes`` is imported (module
    note)."""
    a, name = to_numpy(t)
    return a if name is None else _Bf16Leaf(a)


class _Bf16Global:
    """Stand-in for ``ml_dtypes.bfloat16`` while a pickle is read."""


class _Bf16Dtype:
    """Stand-in for ``numpy.dtype(ml_dtypes.bfloat16)``."""

    def __setstate__(self, state):  # the dtype's byte order and sizes
        pass


class _Array:
    """An array of a pickle, rebuilt by its ``__setstate__`` (the state
    ``numpy.ndarray.__reduce__`` gives) and swapped for :attr:`value`, a
    numpy array or a bf16 tensor, once the pickle is read."""

    def __init__(self, value=None):
        self.value = value

    def __setstate__(self, state):
        dtype = state[-3]
        if isinstance(dtype, _Bf16Dtype):
            shape, fortran, raw = state[-4], state[-2], state[-1]
            bits = _np.frombuffer(raw, dtype="<u2").reshape(
                shape, order="F" if fortran else "C")
            self.value = _bf16_tensor(bits)
            return
        a = _np.empty((0,), dtype=_np.int8)
        a.__setstate__(state)
        self.value = a


def _reconstruct(cls, shape, typecode):  # noqa: ARG001
    return _Array()


def _frombuffer(buf, dtype, shape, order):
    """Protocol 5's array: ``numpy.core.numeric._frombuffer``."""
    if isinstance(dtype, _Bf16Dtype):
        bits = _np.frombuffer(buf, dtype="<u2").reshape(shape, order=order)
        return _Array(_bf16_tensor(bits))
    return _Array(_np.frombuffer(buf, dtype=dtype).reshape(
        shape, order=order).copy())


def _dtype(obj, align=False, copy=False):
    if obj is _Bf16Global:
        return _Bf16Dtype()
    return _np.dtype(obj, align, copy)


def _view(arr, dtype=None):
    a = arr.value if isinstance(arr, _Array) else arr
    if dtype in ("bfloat16", _Bf16Global) or isinstance(dtype, _Bf16Dtype):
        if isinstance(a, torch.Tensor):
            return _Array(a)
        return _Array(_bf16_tensor(a))
    return _Array(a.view(dtype))


def _getattr(obj, name):
    if obj is _np.ndarray and name == "view":
        return _view
    raise pickle.UnpicklingError(
        f"a checkpoint pickle may not take the attribute {name!r} of {obj!r}")


#: the globals a checkpoint pickle may name besides those mapped above:
#: numpy's scalars and arrays, and the bytes codec of protocol-2 pickles
_ALLOWED = {("numpy", "ndarray"), ("numpy._core.multiarray", "scalar"),
            ("numpy.core.multiarray", "scalar"), ("_codecs", "encode")}


class _Unpickler(pickle.Unpickler):
    """Reads numpy arrays, ``ml_dtypes`` bf16 arrays among them, without
    ``ml_dtypes`` (module note). Any other global raises
    ``pickle.UnpicklingError``: a checkpoint holds containers, numbers,
    strings and arrays only, and a pickle that names a callable beyond
    them would run it."""

    def find_class(self, module, name):
        if module == "ml_dtypes":
            if name == "bfloat16":
                return _Bf16Global
            raise TypeError(
                f"the pickle holds an array of {name}, which has no torch "
                f"dtype in the port; only bfloat16 is decoded")
        if name == "_reconstruct" and module in ("numpy._core.multiarray",
                                                 "numpy.core.multiarray"):
            return _reconstruct
        if name == "_frombuffer" and module in ("numpy._core.numeric",
                                                "numpy.core.numeric"):
            return _frombuffer
        if module == "numpy" and name == "dtype":
            return _dtype
        if module == "builtins" and name == "getattr":
            return _getattr
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"a checkpoint pickle may not name {module}.{name}")
        if module.startswith("numpy._core"):
            try:
                importlib.import_module(module)
            except ImportError:  # a numpy 1 reader of a numpy 2 pickle
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _settle(obj):
    if isinstance(obj, _Array):
        return obj.value
    if isinstance(obj, dict):
        return {k: _settle(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_settle(v) for v in obj)
    return obj


def pickle_load(f):
    """The object pickled in the open file ``f``, its arrays numpy arrays
    and its bf16 arrays bf16 tensors, read without ``ml_dtypes``."""
    return _settle(_Unpickler(f).load())

