"""``mx.nd.save`` / ``mx.nd.load`` (counterpart of
mxnet_tpu/ndarray/utils.py): an NDArray, a list of them or a dict of
name -> NDArray in numpy's ``.npz`` container, a single array in ``.npy``.
bfloat16 travels through ``.npz`` by the JAX package's dtype sidecar
(``_dtype_codec``), so files cross between the two packages both ways."""
from __future__ import annotations

import os

import numpy as _np
import torch

from .. import _checkpoint_io
from .._dtype_codec import decode_npz, encode_payload
from .ndarray import NDArray, array

__all__ = ["save", "savez", "load"]

_LIST_PREFIX = "__mx_list__:"


def _to_np(a):
    """A tensor for an NDArray (the codec views exotic dtypes), a numpy
    copy of anything else."""
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, torch.Tensor):
        return a
    return _np.array(a)


def save(fname, data):
    """Save an NDArray, a list of NDArrays or a dict of str -> NDArray."""
    if isinstance(data, NDArray):
        if fname.endswith(".npy"):
            if data._data.dtype == torch.bfloat16:
                # .npy has nowhere to carry the dtype sidecar
                raise ValueError("dtype bfloat16 cannot round-trip through "
                                 ".npy; save to .npz instead")
            _np.save(fname, data.asnumpy())
            return
        data = [data]
    if isinstance(data, (list, tuple)):
        payload = {f"{_LIST_PREFIX}{i}": _to_np(a) for i, a in enumerate(data)}
    elif isinstance(data, dict):
        payload = {k: _to_np(v) for k, v in data.items()}
    else:
        raise ValueError("save expects an NDArray, a list of NDArrays or a "
                         f"dict of str -> NDArray, got {type(data)}")
    # through the path's IO chain, so that this write is ordered after any
    # save of the same path still in flight, then barrier: complete on
    # return (utils.py:save), for a reader outside the framework
    _checkpoint_io.async_save_npz(fname, payload)
    _checkpoint_io.wait_for_path(fname)


def savez(fname, *args, **kwargs):
    """numpy's ``savez``: positional arrays as ``arr_0``, ..., keyword
    arrays by name (utils.py:66); numpy appends ``.npz`` to a name without
    an extension."""
    payload = {f"arr_{i}": _to_np(a) for i, a in enumerate(args)}
    payload.update({k: _to_np(v) for k, v in kwargs.items()})
    _np.savez(fname, **encode_payload(payload))


def _array(v, device):
    return array(v, dtype=v.dtype, device=device)


def load(fname, device=None):
    """What :func:`save` (or the JAX package's) wrote, as NDArrays on
    ``device`` (default: the current device) with the stored dtypes,
    bfloat16 included. A save of this path still on its IO thread is
    waited for first."""
    _checkpoint_io.wait_for_path(fname)   # barrier on an in-flight save
    if fname.endswith(".npy"):
        raw = _np.load(fname)
        return array(raw, dtype=raw.dtype, device=device)
    if not os.path.exists(fname) and os.path.exists(fname + ".npz"):
        fname += ".npz"
    with _np.load(fname) as z:
        decoded = decode_npz(z)
    keys = list(decoded)
    if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
        keys.sort(key=lambda k: int(k[len(_LIST_PREFIX):]))
        return [_array(decoded[k], device) for k in keys]
    return {k: _array(v, device) for k, v in decoded.items()}
