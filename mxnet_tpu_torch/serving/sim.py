"""Simulated slow device for serving-pipeline tests and benchmarks
(counterpart of mxnet_tpu/serving/sim.py).

Proving that the pipelined engine (engine.py) overlaps host assembly with
device compute, and that a request trace's phases add up, needs a device
whose per-batch latency is KNOWN and independent of host CPU contention.
:class:`SimulatedBlock` quacks like a hybridized ``HybridBlock`` as far as
the engine cares — ``call_cached_graph``, ``jit_trace_count``,
``capture_count``, ``device`` — but its "device" is a single daemon thread
executing batches FIFO, each taking ``device_ms`` of ``time.sleep`` (GIL
released, like a real device stream):

  * ``call_cached_graph`` ENQUEUES the batch and returns immediately —
    asynchronous, like a CUDA launch;
  * it returns :class:`_PendingResult` handles whose ``synchronize()``
    blocks until the device thread has finished that batch (a
    ``threading.Event``), the handle the engine's completer waits on, as
    it waits on a CUDA event for a batch on the card
    (engine.py:_ready_handle); sliced afterwards they give tensors;
  * one device thread + FIFO order = a serial compute stream: two batches
    in flight take ``2 * device_ms`` of device time but the SECOND batch's
    host assembly is hidden under the first's compute.

The block's device is the CPU, so the engine hands it the padded batch as
CPU tensors. Used by tests/test_torch_reqtrace.py.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as _np
import torch

__all__ = ["SimulatedBlock"]


class _PendingResult:
    """A future-ish output handle: shaped like the output, readable only
    after the simulated device finishes the batch."""

    __slots__ = ("_event", "_value", "shape", "dtype")

    def __init__(self, shape, dtype):
        self._event = threading.Event()
        self._value = None
        self.shape = tuple(shape)
        self.dtype = _np.dtype(dtype)

    def _set(self, value):
        self._value = value
        self._event.set()

    def synchronize(self):
        """Block until the device thread has finished this batch."""
        self._event.wait()
        return self

    def __getitem__(self, idx):
        if not self._event.is_set():
            raise RuntimeError(
                "simulated result sliced before synchronize() — the "
                "completer must wait before unpadding")
        return torch.from_numpy(_np.array(self._value[idx]))

    def __array__(self, dtype=None):
        self.synchronize()
        return _np.asarray(self._value, dtype=dtype)


class SimulatedBlock:
    """A fake hybridized block whose forward costs ``device_ms`` on a
    serial device stream and ``host_ms`` of synchronous host time.

    ``fn`` maps the padded input batch (numpy) to the output batch;
    default is identity — convenient because padded-row leak checks can
    compare against the input directly. ``host_ms`` models a
    non-overlappable host cost inside dispatch (tokenization, feature
    lookup); it burns wall-clock in the CALLER's thread before the
    enqueue, so sync mode pays it serially while pipelined mode overlaps
    it with the previous batch's device time.
    """

    device = torch.device("cpu")  # the engine hands it CPU tensors

    def __init__(self, device_ms=20.0, host_ms=0.0, fn=None):
        self.device_ms = float(device_ms)
        self.host_ms = float(host_ms)
        self._fn = fn if fn is not None else lambda *a: a[0]
        self._q = queue.Queue()
        self._calls = 0
        self._done = 0
        self._busy_s = 0.0
        self._calls_lock = threading.Lock()
        self._device = threading.Thread(
            target=self._device_loop, name="mxtpu-sim-device", daemon=True)
        self._device.start()

    # -- the serial device stream -----------------------------------------
    def _device_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            arrays, pending = item
            t0 = time.perf_counter()
            time.sleep(self.device_ms / 1e3)  # GIL released: "compute"
            out = self._fn(*arrays)
            pending._set(_np.asarray(out))
            with self._calls_lock:
                self._done += 1
                self._busy_s += time.perf_counter() - t0

    def close(self):
        self._q.put(None)

    # -- the HybridBlock surface the engine uses ---------------------------
    def call_cached_graph(self, *args):
        """Asynchronous dispatch: enqueue on the device stream and return
        a pending handle immediately."""
        if self.host_ms:
            t_end = time.perf_counter() + self.host_ms / 1e3
            while time.perf_counter() < t_end:  # busy host work
                pass
        arrays = [_np.asarray(a) for a in args]
        with self._calls_lock:
            self._calls += 1
        pending = _PendingResult(arrays[0].shape, arrays[0].dtype)
        self._q.put((arrays, pending))
        return pending

    def jit_trace_count(self, training=False):
        """Nothing underneath to trace: the shape vocabulary is trivially
        sealed."""
        return 0

    def capture_count(self):
        """No CUDA graphs: nothing is captured."""
        return 0

    # -- introspection -----------------------------------------------------
    @property
    def dispatches(self):
        with self._calls_lock:
            return self._calls

    @property
    def batches_done(self):
        """Batches the device stream has finished (vs ``dispatches``
        enqueued — the gap is the in-flight window)."""
        with self._calls_lock:
            return self._done

    @property
    def busy_ms(self):
        """Total device-stream busy time — the ground truth a traced
        request's ``device`` phase spans are checked against."""
        with self._calls_lock:
            return self._busy_s * 1e3
