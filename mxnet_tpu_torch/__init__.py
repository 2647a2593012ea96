"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout and names so that each module's
counterpart is easy to find; imports torch, numpy and the standard library,
never JAX or mxnet_tpu. Entry points run on ``cuda:0`` unless the caller
passes a CPU device.
"""
from __future__ import annotations

from . import amp, autograd, env, gluon, lr_scheduler, optimizer
from .base import MXNetError
from .device import cpu, default_device, gpu, tpu

__all__ = ["amp", "autograd", "env", "gluon", "lr_scheduler", "optimizer",
           "MXNetError", "cpu", "gpu", "tpu",
           "default_device"]
