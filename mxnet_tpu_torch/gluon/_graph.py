"""CUDA-graph capture shared by ``gluon.TrainStep`` (one graph a training
step) and ``HybridBlock.call_cached_graph`` (one graph a served input
signature).

:class:`StaticGraph` holds one ``torch.cuda.CUDAGraph``, the static input
buffers it reads (copies of the capture's inputs on the card), the outputs
the capture made (static: every replay overwrites them) and what the
capture added to the launch counters, which a replay adds again
(kernels/build.py:captured_counts, add_deltas). A capture takes
:data:`CAPTURE_LOCK`, one for the process, and runs in
``capture_error_mode="thread_local"``: two engines on one card may warm up
and serve at once, and only the capturing thread is barred from the calls
a capture forbids, so another thread's launches neither fail the capture
nor land in it. A replay copies its arguments into the static inputs and
launches the graph on the caller's current stream.

A graph keeps the addresses it captured. :func:`storage_fingerprint` is
what its owner compares to know that the weights still live there; a
Parameter whose tensor is replaced moves gluon/parameter.py:storage_epoch,
so a caller can compare that one number first.
"""
from __future__ import annotations

import threading

import torch

from ..kernels import build as _build

__all__ = ["CAPTURE_LOCK", "StaticGraph", "storage_fingerprint"]

#: one capture at a time in the process (captures share the allocator's
#: capture bookkeeping and, by default, torch's capture stream)
CAPTURE_LOCK = threading.Lock()


def storage_fingerprint(tensors):
    """``(id, address, dtype)`` of each tensor: what a captured graph
    read, and how."""
    return tuple((id(t), t.data_ptr(), t.dtype) for t in tensors)


class StaticGraph:
    """One captured graph over static copies of ``inputs`` on ``device``;
    ``generators`` (torch.Generator on the device) are registered with it,
    so every replay draws anew from them."""

    def __init__(self, inputs, device, generators=()):
        self.inputs = [t.detach().to(device).clone() for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        self.outputs = None
        self.tally = None
        self.pool_bytes = None

    def capture(self, body, stream, pool=None):
        """Capture ``body(self.inputs)`` on ``stream`` into ``pool`` (None:
        a private pool of this graph's own); returns and keeps its
        outputs. ``pool_bytes`` is what the card's reserved memory grew by
        from the start of the capture (after torch's ``empty_cache`` at
        its entry) to its end: the pool's segments, plus whatever another
        thread reserved meanwhile."""
        dev = self.inputs[0].device if self.inputs else None
        with CAPTURE_LOCK, _build.captured_counts() as tally:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(dev)
                self.outputs = body(self.inputs)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.tally = tally
        return self.outputs

    def replay(self, inputs):
        """Copy ``inputs`` into the static inputs and replay, both on the
        current stream; the counters take the capture's launches."""
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        _build.add_deltas(self.tally)
