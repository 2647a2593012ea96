"""The legacy context module (counterpart of mxnet_tpu/context.py): an
alias layer over device.py, ``Context`` is ``Device``."""
from .device import (  # noqa: F401
    Device,
    Device as Context,
    cpu,
    cpu_pinned,
    current_device,
    current_device as current_context,
    gpu,
    num_gpus,
    tpu,
)

__all__ = ["Context", "Device", "cpu", "cpu_pinned", "gpu", "tpu",
           "current_context", "current_device", "num_gpus"]
