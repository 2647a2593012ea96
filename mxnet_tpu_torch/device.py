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

__all__ = ["Device", "Context", "cpu", "cpu_pinned", "gpu", "tpu",
           "num_gpus", "num_tpus", "default_device", "current_device",
           "resolve", "is_pinned"]


def cpu(device_id=0):  # noqa: ARG001 - one host device
    """The host CPU."""
    return torch.device("cpu")


def gpu(device_id=0):
    """The ``device_id``-th CUDA card."""
    return torch.device("cuda", int(device_id))


class PinnedDevice:
    """Page-locked host memory (``cpu_pinned``): the CPU, where arrays made
    or copied for it are pinned, so that copies to a card can run
    asynchronously. Without a card nothing can be pinned and it is the
    CPU. As a ``with`` scope it is the CPU's scope."""

    type = "cpu"
    index = None

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return isinstance(other, PinnedDevice)

    def __hash__(self):
        return hash("cpu_pinned")

    def __repr__(self):
        return f"cpu_pinned({self.device_id})"

    def __enter__(self):
        self._scope = torch.device("cpu")
        return self._scope.__enter__()

    def __exit__(self, *exc):
        return self._scope.__exit__(*exc)


def cpu_pinned(device_id=0):
    """Pinned host memory (device.py:150)."""
    return PinnedDevice(device_id)


def is_pinned(device):
    return isinstance(device, PinnedDevice)


def pin(tensor):
    """``tensor`` in pinned host memory where a card is present."""
    if torch.cuda.is_available() and not tensor.is_pinned():
        return tensor.pin_memory()
    return tensor


class _DeviceType(type):
    def __instancecheck__(cls, obj):
        return isinstance(obj, (torch.device, PinnedDevice))


class Device(metaclass=_DeviceType):
    """The JAX package's ``Device``/``Context`` (device.py:34): here a
    constructor of the port's devices, ``torch.device`` (and
    :class:`PinnedDevice`): ``Device('gpu', 1)`` is ``cuda:1``,
    ``Device('cpu')`` the CPU, ``Device('cpu_pinned')`` pinned host
    memory. Every port device is an instance, and a ``with`` scope."""

    def __new__(cls, device_type, device_id=0):
        if isinstance(device_type, (torch.device, PinnedDevice)):
            return device_type
        kind = str(device_type)
        if kind in ("gpu", "cuda"):
            return gpu(device_id)
        if kind in ("cpu", "cpu_shared"):
            return cpu(device_id)
        if kind == "cpu_pinned":
            return cpu_pinned(device_id)
        if kind == "tpu":
            return tpu(device_id)
        return torch.device(kind)


Context = Device


def tpu(device_id=0):  # noqa: ARG001
    raise MXNetError(
        "mxnet_tpu_torch runs on CUDA cards: use gpu(i), or cpu() for the "
        "plain PyTorch path")


def num_gpus():
    """Number of CUDA cards visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus():
    """No TPU is behind this package: 0."""
    return 0


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
    if isinstance(device, PinnedDevice):
        return torch.device("cpu")
    return torch.device(device)
