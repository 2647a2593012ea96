"""Kernel dispatch: who decides, and how the decision is counted
(counterpart of mxnet_tpu/kernels/dispatch.py).

A call site that has a hand-written kernel and a plain PyTorch version (the
optimizer ladder, kernels/opt.py; BatchNorm training, kernels/norm.py)
decides between them from static
properties only, before anything is launched: where the tensors live
(:func:`platform_ok`), and what the kernel supports (the rule, the dtypes).
CUDA tensors that the kernel supports launch it, and a build or launch
failure raises; CPU tensors take the plain version. There is no mode
switch: the JAX package's ``MXTPU_KERNELS`` off/auto/force and its ``auto``
thresholds were tuned for another device, and on the card the kernel is the
faster path at every size and dtype measured (PERF.md).

Every decision is counted by ``(kernel, outcome)`` in :data:`COUNTS`, a
plain dict (the port's telemetry holds the serving instruments only). :func:`optimizer_region_bytes` and
:func:`norm_region_bytes` are the JAX package's byte models of one
parameter's update and of one BatchNorm site; here they gate nothing and
give the bytes a kernel moves, for a time bound.
"""
from __future__ import annotations

import threading

import torch

from . import build as _build

__all__ = ["platform_ok", "record", "COUNTS", "reset_counts", "add_counts",
           "optimizer_region_bytes", "norm_region_bytes"]

#: {(kernel, outcome): number of decisions}
COUNTS = {}
_LOCK = threading.Lock()


def platform_ok(*tensors):
    """True when the kernels can run on these tensors: every one is a CUDA
    tensor."""
    return all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


def record(kernel, outcome):
    """Count one decision (into the calling thread's capture tally while it
    captures a CUDA graph: kernels/build.py:captured_counts)."""
    tally = _build.capture_tally()
    if tally is not None:
        tally.count(tally.decisions, (kernel, outcome), 1)
        return
    with _LOCK:
        COUNTS[(kernel, outcome)] = COUNTS.get((kernel, outcome), 0) + 1


def reset_counts():
    with _LOCK:
        COUNTS.clear()


def add_counts(counts):
    """Add ``{(kernel, outcome): n}`` (a capture's decisions, once per
    replay)."""
    with _LOCK:
        for k, n in counts.items():
            COUNTS[k] = COUNTS.get(k, 0) + n


def optimizer_region_bytes(w_size, w_itemsize, n_state, mp):
    """``(plain_bytes, kernel_bytes)`` that ONE parameter's update chain
    moves through device memory (own copy of
    mxnet_tpu/passes/memory.py:optimizer_region_bytes).

    The floor both paths pay: read the gradient, read and write each state
    leaf, read and write the master or weight, write the low-precision
    weight copy (mp). Under mp the plain path additionally writes and reads
    the widened f32 gradient across the cast; without mp there is no
    widening, and the model predicts zero savings."""
    n = int(w_size)
    bw = int(w_itemsize)
    if mp:
        floor = (n * bw                 # read low-precision grad
                 + 2 * n * 4            # master read+write
                 + n_state * 2 * n * 4  # state leaves read+write (f32)
                 + n * bw)              # write low-precision weight copy
        return floor + 2 * n * 4, floor
    floor = n * bw + 2 * n * bw + n_state * 2 * n * bw
    return floor, floor


def norm_region_bytes(shape, x_itemsize, ew_itemsize,
                      resident=(False, False)):
    """``(plain_bytes, kernel_bytes)`` that ONE BatchNorm training site
    moves through device memory, forward and backward together (own copy
    of mxnet_tpu/passes/memory.py:norm_region_bytes; ``resident`` is the
    port's own: which of K1 and K2 run in the resident regime).

    Plain (XLA's fusion boundaries): the forward reads x, round-trips the
    centred population in the elementwise dtype across the sum/sum^2
    reduction, writes out; the backward reads x and dy, round-trips x-hat
    and the cast dy across the dbeta/dgamma reduction, writes dx. Kernel:
    the forward reads x twice (statistics, then normalize) and writes out;
    the backward reads x and dy twice and writes dx; a resident K1 or K2
    reads its inputs once. Per-channel vectors are ignored."""
    n = 1
    for d in shape:
        n *= int(d)
    bx, be = int(x_itemsize), int(ew_itemsize)
    plain_fwd = n * bx + 2 * n * be + n * bx
    plain_bwd = 2 * n * bx + 4 * n * be + n * bx
    k_fwd = (1 if resident[0] else 2) * n * bx + n * bx
    k_bwd = (1 if resident[1] else 2) * (2 * n * bx) + n * bx
    return plain_fwd + plain_bwd, k_fwd + k_bwd
