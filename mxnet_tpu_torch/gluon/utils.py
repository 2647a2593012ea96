"""Gluon utilities (counterpart of mxnet_tpu/gluon/utils.py): splitting a
batch over devices, global-norm clipping, file checks and hook handles.

Nothing here reaches the network: :func:`download` returns a file that is
already in place (checking its sha1) and raises otherwise, as the JAX
package's does.
"""
from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch

from .. import numpy as _mxnp
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download", "HookHandle", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; with
    ``even_split`` the batch must divide evenly, otherwise the last slice
    takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}; set "
            "even_split=False or adjust the batch size")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    if step == 0:
        raise ValueError(f"batch of {size} cannot feed {num_slice} slices")
    slices = []
    for i in range(num_slice):
        stop = size if i == num_slice - 1 else (i + 1) * step
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(i * step, stop)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of ``data`` a device of ``ctx_list``, on that device."""
    if not isinstance(data, NDArray):
        data = _mxnp.array(data)
    if len(ctx_list) == 1:
        return [data.as_in_ctx(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_ctx(ctx) for s, ctx in zip(slices, ctx_list)]


def _tensor(a):
    return a._data if isinstance(a, NDArray) else a


def _scale_(t, scale):
    """``t *= scale`` in place, computed in f32 for a narrower float."""
    with torch.no_grad():
        if t.dtype == torch.float32:
            t.mul_(scale)
        else:
            t.copy_(t.float() * scale)


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (NDArrays or tensors, e.g. ``Parameter.grad()``)
    in place so that their joint L2 norm is at most ``max_norm``, and
    return the norm before clipping.

    With ``check_isfinite`` the norm is read on the host as a float: a
    non-finite one leaves the arrays as they are and warns, naming the
    first array that holds a non-finite value. With
    ``check_isfinite=False`` nothing is read on the host: the arrays are
    multiplied by ``min(1, max_norm / (norm + 1e-8))`` on their device and
    the norm comes back as an NDArray."""
    if not arrays:
        raise ValueError("arrays is empty")
    tensors = [_tensor(a) for a in arrays]
    with torch.no_grad():
        total = torch.sqrt(sum(torch.sum(torch.square(t.float()))
                               for t in tensors))
        scale = torch.clamp(max_norm / (total + 1e-8), max=1.0)
    if not check_isfinite:
        for t in tensors:
            _scale_(t, scale)
        return NDArray(total)
    norm = float(total)
    if not math.isfinite(norm):
        offenders = [i for i, t in enumerate(tensors)
                     if not bool(torch.isfinite(t).all())]
        detail = ""
        if offenders:
            t = tensors[offenders[0]]
            detail = (f"; first non-finite array: #{offenders[0]} "
                      f"{tuple(t.shape)}/{str(t.dtype).removeprefix('torch.')}"
                      f" ({len(offenders)} of {len(arrays)} non-finite)")
        warnings.warn(
            f"nan or inf is detected. Clipping results will be undefined "
            f"(global norm = {norm}{detail})", stacklevel=2)
        return norm
    if norm > max_norm:
        for t in tensors:
            _scale_(t, scale)
    return norm


def check_sha1(filename, sha1_hash):
    """True if the file's sha1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,  # noqa: ARG001
             verify_ssl=True):  # noqa: ARG001
    """The local file for ``url`` (``path``, or the URL's last part in
    the directory ``path`` or the current one), checked against
    ``sha1_hash``. Nothing is fetched: a missing file raises ``OSError``
    that says where to put it."""
    fname = path if path and not os.path.isdir(path) else \
        os.path.join(path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite:
        if sha1_hash and not check_sha1(fname, sha1_hash):
            raise OSError(f"{fname} exists but sha1 mismatch")
        return fname
    raise OSError(
        f"cannot download {url}: nothing is fetched over the network. "
        f"Place the file at {fname} manually (sha1="
        f"{sha1_hash or 'unchecked'}).")


_hook_counter = [0]


class HookHandle:
    """A removable handle of a registered hook; keys come from a global
    counter, so one callable can be registered under several handles."""

    def __init__(self):
        self._hooks_dict = None
        self._id = None

    def attach(self, hooks_dict, hook):
        assert not self._hooks_dict, "already attached"
        _hook_counter[0] += 1
        self._id = _hook_counter[0]
        hooks_dict[self._id] = hook
        self._hooks_dict = hooks_dict

    def detach(self):
        if self._hooks_dict and self._id in self._hooks_dict:
            del self._hooks_dict[self._id]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


def shape_is_known(shape):
    """True if no dimension is unknown (None or negative)."""
    if shape is None:
        return False
    return all(d is not None and d >= 0 for d in shape)
