"""The overflow check and per-array sums of squares of mixed-precision
training (counterpart of mxnet_tpu/ops/optimizer_ops.py:multi_all_finite
:188 and multi_sum_sq :197, which the JAX package leaves to XLA). Plain
PyTorch: the reductions run where the arrays lie, and nothing is read on
the host here."""
from __future__ import annotations

import torch

__all__ = ["multi_all_finite", "multi_sum_sq"]


def _tensor(a):
    return getattr(a, "_data", a)


def multi_all_finite(*arrays, num_arrays=None,
                     init_output=True):  # noqa: ARG001 - the op's signature
    """A ``(1,)`` f32 tensor: 1 when every element of every array is
    finite, else 0."""
    if not arrays:
        return torch.ones(1, dtype=torch.float32)
    flags = torch.stack([torch.isfinite(_tensor(a)).all() for a in arrays])
    return flags.all().to(torch.float32).reshape(1)


def multi_sum_sq(*arrays, num_arrays=None):  # noqa: ARG001
    """The sum of squares of each array, in f32, as a tuple of 0-dim
    tensors."""
    return tuple(torch.sum(torch.square(_tensor(a).float())) for a in arrays)
