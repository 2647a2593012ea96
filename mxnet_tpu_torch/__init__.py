"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout and names so that each module's
counterpart is easy to find; imports torch, numpy and the standard library,
never JAX or mxnet_tpu. Entry points run on ``cuda:0`` unless the caller
passes a CPU device or opens a device scope (``with mx.cpu():``).
"""
from __future__ import annotations

from . import amp, autograd, env, gluon, initializer, io, lr_scheduler
from . import attribute, base, context, device, error, log, name
from . import kvstore, ndarray
from . import kvstore as kv
from . import ndarray as nd
from . import numpy as np
from . import numpy_extension as npx
from . import observability, optimizer, parallel, recordio, registry, rtc
from . import serving, test_utils, util
from . import checkpoint, contrib, elastic, sharding
from ._random import seed
from .attribute import AttrScope
from .base import MXNetError
from .device import (Context, Device, cpu, cpu_pinned, current_device,
                     default_device, gpu, num_gpus, num_tpus, tpu)
from .name import NameManager
from .ndarray import NDArray, waitall
from .numpy import random

#: the JAX package's version, which the port mirrors (checkpoint manifests
#: record it)
__version__ = "0.1.0"

__all__ = ["amp", "autograd", "checkpoint", "contrib", "env", "gluon", "initializer", "io", "kv",
           "kvstore",
           "lr_scheduler", "observability", "optimizer", "nd", "ndarray",
           "np", "npx", "parallel", "random", "recordio", "rtc", "serving",
           "seed", "waitall", "NDArray", "MXNetError", "Context", "Device",
           "cpu", "cpu_pinned", "gpu", "tpu", "num_gpus", "num_tpus",
           "current_device", "default_device", "attribute", "base",
           "context", "device", "error", "log", "name", "registry",
           "test_utils", "util", "AttrScope", "NameManager"]
