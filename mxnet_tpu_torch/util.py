"""Small utilities (counterpart of mxnet_tpu/util.py): the np-semantics
decorators and scopes, the ``ctx=`` to ``device=`` shim, the card count
and its memory."""
from __future__ import annotations

import functools

import torch

__all__ = ["use_np_shape", "use_np_array", "use_np",
           "wrap_ctx_to_device_func", "get_gpu_count", "get_gpu_memory",
           "is_np_array", "is_np_shape", "np_array", "np_shape"]


def use_np_shape(func):
    return func


def use_np_array(func):
    return func


def use_np(func):
    return func


def wrap_ctx_to_device_func(func):
    """``func`` taking ``ctx=`` as its ``device=``."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        if "ctx" in kwargs and "device" not in kwargs:
            kwargs["device"] = kwargs.pop("ctx")
        return func(*args, **kwargs)

    return wrapped


def get_gpu_count():
    from .device import num_gpus

    return num_gpus()


def get_gpu_memory(dev_id=0):
    """``(bytes in use, bytes the card holds)`` of card ``dev_id`` as
    PyTorch's allocator sees it; ``(0, 0)`` without a card."""
    if not torch.cuda.is_available():
        return 0, 0
    return (torch.cuda.memory_allocated(dev_id),
            torch.cuda.get_device_properties(dev_id).total_memory)


def is_np_array():
    from .numpy_extension import is_np_array as _is

    return _is()


def is_np_shape():
    from .numpy_extension import is_np_shape as _is

    return _is()


class _NpSemanticsScope:
    """A scope that sets one np-semantics flag for this thread only."""

    def __init__(self, key, active):
        self._key = key
        self._active = bool(active)
        self._prev = None

    def __enter__(self):
        from .numpy_extension import _np_tls

        self._prev = getattr(_np_tls, self._key, None)
        setattr(_np_tls, self._key, self._active)
        return self

    def __exit__(self, *exc):
        from .numpy_extension import _np_tls

        setattr(_np_tls, self._key, self._prev)
        return False


def np_array(active=True):
    return _NpSemanticsScope("array", active)


def np_shape(active=True):
    return _NpSemanticsScope("shape", active)
