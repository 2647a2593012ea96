"""``mx.nd.save`` / ``mx.nd.load`` (counterpart of
mxnet_tpu/ndarray/utils.py): an NDArray, a list of them or a dict of
name -> NDArray in numpy's ``.npz`` container, a single array in ``.npy``.
The dtype sidecar that carries bfloat16 through ``.npz`` is not ported:
saving a bfloat16 array raises."""
from __future__ import annotations

import os

import numpy as _np
import torch

from .ndarray import NDArray, array

__all__ = ["save", "load"]

_LIST_PREFIX = "__mx_list__:"


def _to_np(a):
    if isinstance(a, NDArray):
        if a._data.dtype == torch.bfloat16:
            raise ValueError("bfloat16 arrays need the dtype sidecar of the "
                             "checkpoint format, which is not ported yet")
        return a.asnumpy()
    return _np.array(a)


def save(fname, data):
    """Save an NDArray, a list of NDArrays or a dict of str -> NDArray."""
    if isinstance(data, NDArray):
        if fname.endswith(".npy"):
            _np.save(fname, _to_np(data))
            return
        data = [data]
    if isinstance(data, (list, tuple)):
        payload = {f"{_LIST_PREFIX}{i}": _to_np(a) for i, a in enumerate(data)}
    elif isinstance(data, dict):
        payload = {k: _to_np(v) for k, v in data.items()}
    else:
        raise ValueError("save expects an NDArray, a list of NDArrays or a "
                         f"dict of str -> NDArray, got {type(data)}")
    with open(fname, "wb") as f:
        _np.savez(f, **payload)


def load(fname, device=None):
    """What :func:`save` wrote, as NDArrays on ``device`` (default: the
    current device) with the stored dtypes."""
    if fname.endswith(".npy"):
        raw = _np.load(fname)
        return array(raw, dtype=raw.dtype, device=device)
    if not os.path.exists(fname) and os.path.exists(fname + ".npz"):
        fname += ".npz"
    with _np.load(fname) as z:
        keys = list(z.keys())
        if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
            keys.sort(key=lambda k: int(k[len(_LIST_PREFIX):]))
            return [array(z[k], dtype=z[k].dtype, device=device)
                    for k in keys]
        return {k: array(z[k], dtype=z[k].dtype, device=device)
                for k in keys}
