"""Framework errors and dtype names (counterpart of mxnet_tpu/base.py).

``MXNetError``, the deferred-init error, and the mapping from the JAX
package's dtype spellings ("float32", "bfloat16", numpy dtypes) to
``torch.dtype`` and back (:func:`numpy_dtype`).
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["MXNetError", "DeferredInitializationError", "normalize_dtype",
           "numpy_dtype"]


class MXNetError(RuntimeError):
    """Framework-level error (parity with the reference's MXNetError)."""


class DeferredInitializationError(MXNetError):
    """A deferred-init Parameter's data was read before its shape was
    known."""


_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64,
    "uint8": torch.uint8, "bool": torch.bool,
}


def normalize_dtype(dtype):
    """``torch.dtype`` for a dtype given as a torch dtype, a name, a numpy
    dtype or a numpy scalar type."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def numpy_dtype(dtype):
    """The numpy dtype of a ``torch.dtype``; ``torch.bfloat16``, which numpy
    lacks, is returned as it is."""
    if dtype == torch.bfloat16:
        return dtype
    return _np.dtype(str(dtype).replace("torch.", ""))
