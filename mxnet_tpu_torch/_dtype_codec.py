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
"""
from __future__ import annotations

import json

import numpy as _np
import torch

__all__ = ["DTYPE_KEY", "to_numpy", "encode_payload", "read_sidecar",
           "decode_entry", "decode_npz"]

DTYPE_KEY = "__mx_npz_dtypes__"

#: torch dtypes stored as a uint view, by their name in the sidecar
_EXOTIC = {torch.bfloat16: "bfloat16"}


def to_numpy(t):
    """``(array, sidecar dtype name or None)`` of a tensor, on the host: an
    exotic tensor as its bit-equal ``uint`` view, any other as itself."""
    t = t.detach().cpu().contiguous()
    name = _EXOTIC.get(t.dtype)
    if name is None:
        return t.numpy().copy(), None
    return t.view(torch.int16).numpy().view(_np.uint16).copy(), name


def encode_payload(arrays):
    """A dict safe for ``np.savez`` from ``{name: numpy array or tensor}``:
    exotic tensors become bit-equal ``uint`` views and their true dtypes
    land in the :data:`DTYPE_KEY` sidecar. Nothing exotic: the numpy
    arrays, with no sidecar (the file is a plain npz)."""
    if DTYPE_KEY in arrays:
        raise ValueError(f"{DTYPE_KEY!r} is a reserved checkpoint key")
    out, sidecar = {}, {}
    for k, a in arrays.items():
        if isinstance(a, torch.Tensor):
            a, name = to_numpy(a)
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
