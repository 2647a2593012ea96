"""Devices as ``torch.device`` (counterpart of mxnet_tpu/device.py:124-139).

The port runs on the card: :func:`default_device` is ``cuda:0`` and raises
when CUDA is absent; nothing falls back to the CPU unless the caller asks
for :func:`cpu`. The JAX package's ``tpu()`` falls back to the CPU with a
warning; here it raises, because there is no TPU behind this package.

The current-device scope (``Device.__enter__`` :108 and ``current_device``
:165 there) is PyTorch's own: a ``torch.device`` is a context manager, so
``with mx.cpu():`` or ``with mx.gpu(0):`` makes that device the default of
torch's factory functions on this thread, and :func:`current_device`, which
the creation ops of ``mx.np``/``mx.nd`` read, answers it. Outside any scope
it is :func:`default_device`. Inside a scope torch routes every call
through a Python function mode: the main paths run without one.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "tpu", "num_gpus", "default_device",
           "current_device", "resolve"]


def cpu(device_id=0):  # noqa: ARG001 - one host device
    """The host CPU."""
    return torch.device("cpu")


def gpu(device_id=0):
    """The ``device_id``-th CUDA card."""
    return torch.device("cuda", int(device_id))


def tpu(device_id=0):  # noqa: ARG001
    raise MXNetError(
        "mxnet_tpu_torch runs on CUDA cards: use gpu(i), or cpu() for the "
        "plain PyTorch path")


def num_gpus():
    """Number of CUDA cards visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device():
    """``cuda:0``; raises when no CUDA card is present."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device=cpu() to run the "
            "plain PyTorch path on the CPU")
    return gpu(0)


def current_device():
    """The device of the innermost ``with device:`` scope on this thread
    (``torch.set_default_device`` counts as one), else
    :func:`default_device`."""
    from torch.overrides import _get_current_function_mode_stack
    from torch.utils._device import DeviceContext

    for mode in reversed(_get_current_function_mode_stack()):
        if isinstance(mode, DeviceContext):
            dev = mode.device
            if dev.type == "cuda" and dev.index is None:
                return gpu(torch.cuda.current_device())
            return dev
    return default_device()


def resolve(device=None):
    """A ``torch.device`` from None (the current device: the scope's, else
    the default device), a string or a ``torch.device``."""
    if device is None:
        return current_device()
    return torch.device(device)
