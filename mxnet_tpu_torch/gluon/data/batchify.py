"""Batchify functions (counterpart of mxnet_tpu/gluon/data/batchify.py).

Each function has two halves. ``host(samples)`` collates on the host and
returns numpy arrays (in tuples, lists and dicts as the samples have them;
NDArray samples are stacked as NDArrays where they live), and
:func:`place` makes NDArrays of the numpy leaves on a device with the
creation defaults of ``mx.np.array`` (int64 becomes int32, float64
float32; uint8 images and int32 labels keep their dtype). Calling the
function runs both on the current device, as the JAX package's does. The
DataLoader runs ``host`` in its worker threads and ``place`` in the
consumer, whose device scope (``with mx.cpu():``) is thread-local.
"""
from __future__ import annotations

import numpy as _np

from ...ndarray.ndarray import NDArray
from ...ndarray.ndarray import array as _array

__all__ = ["Stack", "Pad", "Group", "Append", "AsList",
           "default_batchify_fn"]


def map_leaves(batch, fn):
    """``batch`` with ``fn`` applied to each leaf of its tuples, lists and
    dicts; an :class:`AsList` field is handed on untouched."""
    if isinstance(batch, _AsIs):
        return list(batch)
    if isinstance(batch, tuple):
        return tuple(map_leaves(v, fn) for v in batch)
    if isinstance(batch, list):
        return [map_leaves(v, fn) for v in batch]
    if isinstance(batch, dict):
        return {k: map_leaves(v, fn) for k, v in batch.items()}
    return fn(batch)


def place(batch, device=None):
    """``batch`` with its numpy leaves made NDArrays on ``device`` (None:
    the current device); other leaves stay as they are."""
    return map_leaves(batch, lambda x: _array(x, device=device)
                      if isinstance(x, _np.ndarray) else x)


def _stack_host(arrs):
    if isinstance(arrs[0], NDArray):
        from ... import numpy as mnp

        return mnp.stack(arrs)
    return _np.stack([_np.asarray(a) for a in arrs])


def _default_host(data):
    if isinstance(data[0], (tuple, list)):
        return tuple(_default_host([d[i] for d in data])
                     for i in range(len(data[0])))
    if isinstance(data[0], dict):
        return {k: _default_host([d[k] for d in data]) for k in data[0]}
    return _stack_host(data)


def default_batchify_fn(data):
    """Stack samples; tuples batch field by field, dicts key by key."""
    return place(_default_host(data))


default_batchify_fn.host = _default_host


class _Batchify:
    def __call__(self, data):
        return place(self.host(data))


class Stack(_Batchify):
    def host(self, data):
        return _stack_host(data)


class Pad(_Batchify):
    """Pad samples to the batch's largest size in every dim (``axis`` is
    kept for the signature: the JAX package pads every ragged dim)."""

    def __init__(self, axis=0, val=0, dtype=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype

    def host(self, data):
        arrs = [_np.asarray(d) for d in data]
        ndim = arrs[0].ndim
        max_shape = [max(a.shape[d] for a in arrs) for d in range(ndim)]
        out = _np.stack([
            _np.pad(a, [(0, max_shape[d] - a.shape[d]) for d in range(ndim)],
                    constant_values=self._val) for a in arrs])
        return out.astype(self._dtype) if self._dtype else out


class Group(_Batchify):
    """One batchify function a tuple field."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = fns[0]
        self._fns = fns

    def host(self, data):
        assert len(data[0]) == len(self._fns)
        return tuple(host_fn(fn)([d[i] for d in data])
                     for i, fn in enumerate(self._fns))


class Append(_Batchify):
    """The samples as a list of arrays, each with a unit batch axis when
    ``expand``: for shapes that must not be stacked or padded."""

    def __init__(self, expand=True, batch_axis=0):
        self._expand = expand
        self._batch_axis = batch_axis

    def host(self, data):
        out = []
        for d in data:
            arr = _np.asarray(d)
            if self._expand:
                arr = _np.expand_dims(arr, self._batch_axis)
            out.append(arr)
        return out


class _AsIs(list):
    """A list that :func:`map_leaves` hands on untouched."""


class AsList:
    """The batch as a plain list, untouched (strings and other
    non-tensor fields)."""

    def __call__(self, data):
        return list(data)

    def host(self, data):
        return _AsIs(data)


def host_fn(fn):
    """The host half of a batchify function: its ``host`` attribute, else
    ``fn`` itself (a user's function then runs whole where it is
    called)."""
    return getattr(fn, "host", fn)
