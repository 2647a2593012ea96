"""Continuous-batching inference engine over a hybridized block
(counterpart of mxnet_tpu/serving/engine.py).

The same pipeline as the JAX engine:

  * the **assembler** thread pops the next micro-batch from the priority
    scheduler (scheduler.py), pads it to a bucket rung on the host, moves
    it to the block's device once, and issues the forward — CUDA launches
    are asynchronous, so the call returns while the card is still
    computing, and the assembler starts on the NEXT batch;
  * dispatched-but-unsettled batches sit in a bounded in-flight window
    (``max_inflight``, default 2 = double buffering);
  * the **completer** thread waits on the OLDEST in-flight batch's ready
    handle — on the card a CUDA event recorded on the stream right after
    its forward was issued — slices each request's rows off, and settles
    the futures: a request is "done" only when its output exists.

On the card the forward is ``call_cached_graph``: one CUDA graph per bucket
rung, which :meth:`InferenceEngine.warmup` captures (every rung is driven
twice: an eager run, then the capture) and every served batch replays. The
outputs a replay returns are the caller's own copies, so a result handed
to a client never changes when a later batch replays the same rung.

``mode="sync"`` keeps the serialized loop (collect → assemble → dispatch →
wait → settle on one thread) for A/B measurement. Bucket-ladder padding,
``warmup()`` with the proof that no served shape is new, bounded-queue
admission with typed ``Overloaded`` shedding, per-request deadlines, the
deadline-aware bounded drain in :meth:`stop`, the ``serve_*`` telemetry
(telemetry/instruments.py, which :meth:`stats` reads), the diagnostics
spans and the request traces with their SLO windows
(observability/reqtrace.py) are the JAX engine's contract. Defaults come
from the env registry: MXTPU_SERVE_MAX_BATCH, MXTPU_SERVE_QUEUE,
MXTPU_SERVE_MAX_WAIT_MS, MXTPU_SERVE_TIMEOUT_MS, MXTPU_SERVE_MODE,
MXTPU_SERVE_INFLIGHT, MXTPU_SERVE_DRAIN_MS.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as _np
import torch

from .. import env as _env
from ..diagnostics import spans as _spans
from ..observability import reqtrace as _reqtrace
from ..telemetry import instruments as _instr
from .buckets import assemble_batch, bucket_ladder, pad_rows, pick_bucket
from .errors import EngineStopped, Overloaded, RequestTimeout
from .scheduler import RequestScheduler

__all__ = ["InferenceEngine", "ServeRequest", "warm_and_seal"]


def _to_host(a):
    """Request input -> host numpy (one device transfer per BATCH, not
    per request, so assembly stays on the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return _np.asarray(a)


def _flatten_out(out):
    return out if isinstance(out, (list, tuple)) else (out,)


def _ready_handle(datas):
    """What the completer waits on before it slices ``datas``: a CUDA
    event recorded after the work that makes them, a device handle of the
    outputs' own (anything with ``synchronize()``, as serving/sim.py's
    pending results have), or None (CPU tensors: the forward already
    returned them)."""
    for d in datas:
        if isinstance(d, torch.Tensor):
            if d.is_cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d.device))
                return ev
        elif hasattr(d, "synchronize"):
            return d
    return None


def warm_and_seal(drive, rungs, trace_count, label="buckets"):
    """Warm a shape vocabulary and PROVE it sealed.

    Drives every rung once, snapshots the caller's trace counter, drives
    every rung AGAIN, and raises if the counter moved — a moving counter
    means some served shape is still new on the hot path. Returns the
    post-warm trace count (the ``recompiles_since_warmup`` baseline).
    """
    rungs = list(rungs)
    for r in rungs:
        drive(r)
    before = trace_count()
    for r in rungs:  # re-drive: everything must be a known shape now
        drive(r)
    added = trace_count() - before
    if added:
        raise RuntimeError(
            f"warmup failed to seal: {added} new signature(s) re-driving "
            f"{label} {rungs} — served shapes would be new online")
    return before


class ServeRequest:
    """One in-flight request: inputs, class, deadline, and a settable
    outcome.

    The outcome transition is atomic (first of {completer result, batch
    error, timeout, shed} wins), so the client and the engine can race
    on a deadline without double-counting or half-set results.
    """

    __slots__ = ("inputs", "rows", "signature", "cls", "t_submit",
                 "t_dispatch", "deadline", "_event", "_lock", "outcome",
                 "_result", "_error", "model", "trace")

    def __init__(self, inputs, rows, signature, deadline, cls="interactive"):
        self.inputs = inputs
        self.rows = rows
        self.signature = signature
        self.cls = cls
        self.t_submit = time.monotonic()
        self.t_dispatch = None  # stamped when the batch is issued
        self.deadline = deadline  # absolute monotonic seconds, or None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.outcome = None  # ok | timeout | error | shed (claimed once)
        self._result = None
        self._error = None
        self.model = ""    # owning engine name (SLO attribution)
        self.trace = None  # reqtrace.ReqTrace when sampled, else None

    def _finish(self, outcome, result=None, error=None):
        """Claim the outcome; True iff this call won the claim.

        Every settled request — served, timed out, errored, or shed —
        funnels through here, so this is also the reqtrace/SLO terminal
        chokepoint: the trace (when sampled) freezes into the ring with
        its terminal span, and the latency feeds the class SLO window."""
        with self._lock:
            if self.outcome is not None:
                return False
            self.outcome = outcome
            self._result = result
            self._error = error
        self._event.set()
        try:
            _reqtrace.finish(self, outcome, error)
        except Exception:
            pass
        return True

    @property
    def done(self):
        return self.outcome is not None

    def result(self, timeout=None):
        """Block until the outcome; return the model output (a tensor on
        the block's device, or a tuple for multi-output models) or raise
        the typed failure.

        ``timeout`` (seconds) overrides the request deadline for this
        wait; by default the wait extends to the deadline (forever when
        the request has none).
        """
        if timeout is None and self.deadline is not None:
            timeout = max(0.0, self.deadline - time.monotonic())
        self._event.wait(timeout)
        if not self.done:
            # nothing finished us in time — claim the timeout ourselves
            # (the engine skips claimed requests when it reaches them)
            self._finish("timeout",
                         error=RequestTimeout(
                             f"request not served within "
                             f"{timeout if timeout is not None else 0:.3f}s"))
        if self.outcome == "ok":
            return self._result
        raise self._error


class _Flight:
    """One dispatched-but-unsettled micro-batch in the pipeline window."""

    __slots__ = ("batch", "datas", "ready", "rows", "bucket", "t_dispatch",
                 "batch_id", "traced")

    def __init__(self, batch, datas, ready, rows, bucket, batch_id=None,
                 traced=()):
        self.batch = batch
        self.datas = datas
        self.ready = ready  # what the completer waits on (_ready_handle)
        self.rows = rows
        self.bucket = bucket
        self.t_dispatch = time.monotonic()
        self.batch_id = batch_id  # reqtrace causality id (None unsampled)
        self.traced = traced      # member ReqTraces sharing batch stamps


class InferenceEngine:
    """Thread-safe continuous-batching server around one hybridized
    block.

    ::

        net = ...HybridBlock...; net.initialize(); net.hybridize()
        eng = serving.InferenceEngine(net, name="bert", max_batch_size=8)
        eng.warmup(ids, segments)     # every bucket: eager run, capture
        eng.start()
        out = eng.predict(ids, segments)            # from any thread
        eng.stop()

    Lifecycle: construct -> (optional) warmup -> start -> serve -> stop.
    ``submit()`` works before ``start()`` (requests queue; admission
    control still applies).
    """

    def __init__(self, block, name="model", max_batch_size=None,
                 max_queue=None, max_wait_ms=None, timeout_ms=None,
                 buckets=None, mode=None, max_inflight=None,
                 classes=None, drain_timeout_ms=None):
        if not hasattr(block, "call_cached_graph"):
            raise TypeError(
                f"InferenceEngine needs a HybridBlock, got {type(block)}")
        self._block = block
        self.name = str(name)
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else _env.get("MXTPU_SERVE_MAX_BATCH"))
        self.max_queue = int(
            max_queue if max_queue is not None
            else _env.get("MXTPU_SERVE_QUEUE"))
        self.max_wait_s = float(
            max_wait_ms if max_wait_ms is not None
            else _env.get("MXTPU_SERVE_MAX_WAIT_MS")) / 1e3
        self.timeout_s = float(
            timeout_ms if timeout_ms is not None
            else _env.get("MXTPU_SERVE_TIMEOUT_MS")) / 1e3
        self.drain_timeout_s = float(
            drain_timeout_ms if drain_timeout_ms is not None
            else _env.get("MXTPU_SERVE_DRAIN_MS")) / 1e3
        self.mode = str(mode if mode is not None
                        else _env.get("MXTPU_SERVE_MODE")).lower()
        if self.mode not in ("pipelined", "sync"):
            raise ValueError(
                f"mode must be 'pipelined' or 'sync', got {self.mode!r}")
        self.max_inflight = max(1, int(
            max_inflight if max_inflight is not None
            else _env.get("MXTPU_SERVE_INFLIGHT")))
        self.buckets = bucket_ladder(self.max_batch_size, buckets)
        self._sched = RequestScheduler(self.name, classes=classes,
                                       max_queue=self.max_queue)
        self._lifecycle = threading.Lock()
        self._stopping = False
        self._force = False  # force-stop: window bound lifted, queue dropped
        self._threads = ()
        self._warm_traces = None
        self._warm_captures = None
        self._device = None  # the block's device, read at first dispatch
        # the pipeline window: dispatched-but-unsettled _Flights, bounded
        # at max_inflight (the assembler waits on _icond for a free slot)
        self._icond = threading.Condition()
        self._inflight = collections.deque()
        self._inflight_rows = 0
        self._max_inflight_seen = 0
        # cached label children: the hot path mutates gauges without
        # re-resolving labels (each child still honors enable/disable)
        self._g_inflight = _instr.serve_in_flight.labels(self.name)
        self._g_inflight_batches = _instr.serve_inflight_batches.labels(
            self.name)
        self._c_dispatch = _instr.serve_dispatch_total.labels(self.name)
        # dispatches by bucket rung (keys fixed here: only values change)
        self._bucket_dispatches = dict.fromkeys(self.buckets, 0)

    # -- lifecycle ---------------------------------------------------------
    @property
    def started(self):
        return any(t.is_alive() for t in self._threads)

    def start(self):
        """Start the pipeline threads (idempotent)."""
        with self._lifecycle:
            if self._stopping:
                raise EngineStopped(f"engine {self.name!r} was stopped")
            if not self.started:
                if self.mode == "sync":
                    self._threads = (threading.Thread(
                        target=self._loop_sync,
                        name=f"mxtpu-serve-{self.name}", daemon=True),)
                else:
                    self._threads = (
                        threading.Thread(
                            target=self._loop_assembler,
                            name=f"mxtpu-serve-{self.name}-asm",
                            daemon=True),
                        threading.Thread(
                            target=self._loop_completer,
                            name=f"mxtpu-serve-{self.name}-cpl",
                            daemon=True),
                    )
                for t in self._threads:
                    t.start()
        return self

    def stop(self, drain=True, drain_timeout_ms=None):
        """Stop accepting work; by default drain queued requests first.

        The drain is DEADLINE-AWARE and bounded: it never blocks past
        ``drain_timeout_ms`` (default MXTPU_SERVE_DRAIN_MS), nor past
        the latest deadline among queued requests (after which everything
        left would have expired anyway). Requests still queued when the
        drain deadline hits are force-dropped with
        :class:`EngineStopped` and counted in
        ``serve_drain_dropped_total``. With ``drain=False`` pending
        requests fail immediately.
        """
        with self._lifecycle:
            self._stopping = True
        self._sched.stop()
        if not drain:
            self._sched.stop(force=True)
            self._force = True
            with self._icond:
                self._icond.notify_all()
            dropped = self._sched.drain_all()
            for r in dropped:
                if r._finish("error",
                             error=EngineStopped(
                                 f"engine {self.name!r} stopped")):
                    _instr.record_serve_request(self.name, "error")
        elif not self.started:
            # never started (or already exited): nothing will ever serve
            # the queue — dropping now IS the bounded drain
            self._force_drop()
        else:
            timeout_s = (float(drain_timeout_ms) / 1e3
                         if drain_timeout_ms is not None
                         else self.drain_timeout_s)
            deadline = time.monotonic() + timeout_s
            latest = self._sched.latest_deadline()
            if latest is not None:
                deadline = min(deadline, latest)
            for t in self._threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            if any(t.is_alive() for t in self._threads):
                # drain deadline hit: force the scheduler empty and give
                # the pipeline a moment to settle what it already
                # dispatched (device work in flight completes on its own)
                self._sched.stop(force=True)
                self._force = True
                self._force_drop()
                with self._icond:
                    self._icond.notify_all()
                for t in self._threads:
                    t.join(timeout=2.0)
        self._fail_unsettled_inflight()
        return self

    def _force_drop(self):
        """Drop every queued request unserved (bounded-drain expiry)."""
        dropped = self._sched.drain_all()
        now = time.monotonic()
        for r in dropped:
            if r._finish("error",
                         error=EngineStopped(
                             f"engine {self.name!r} drain deadline hit; "
                             "request dropped unserved")):
                _instr.record_serve_request(self.name, "error",
                                            now - r.t_submit)
        if dropped:
            _instr.serve_drain_dropped_total.labels(self.name).inc(
                len(dropped))

    def _fail_unsettled_inflight(self):
        """Fail any dispatched-but-unsettled requests after the pipeline
        threads are gone (stop-path stragglers)."""
        if any(t.is_alive() for t in self._threads):
            return
        with self._icond:
            flights, self._inflight = list(self._inflight), \
                collections.deque()
            self._inflight_rows = 0
        stragglers = 0
        for fl in flights:
            if fl is None:
                continue
            for r in fl.batch:
                if r._finish("error", error=EngineStopped(
                        f"engine {self.name!r} stopped before the "
                        "dispatched batch settled")):
                    _instr.record_serve_request(self.name, "error")
                    stragglers += 1
        if stragglers:
            _instr.serve_drain_dropped_total.labels(self.name).inc(
                stragglers)
        self._g_inflight.set(0)
        self._g_inflight_batches.set(0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- warmup ------------------------------------------------------------
    def _block_device(self):
        if self._device is None:
            self._device = self._block.device
        return self._device

    def _to_device(self, arrays):
        """The padded host batch on the block's device. To a card each
        input goes from pinned host memory without blocking: a pageable
        copy would wait for the batch in flight to finish, and the
        assembler could never run ahead of the card."""
        dev = self._block_device()
        if dev.type != "cuda":
            return [torch.as_tensor(a, device=dev) for a in arrays]
        return [torch.from_numpy(_np.ascontiguousarray(a)).pin_memory().to(
            dev, non_blocking=True) for a in arrays]

    def warmup(self, *example_inputs, shapes=None):
        """Drive EVERY bucket, then prove no served shape is new.

        ``example_inputs`` is one example request (each array with a
        leading row dim; trailing dims and dtypes fix the served
        signature). For each ladder rung the example is tiled/padded to
        the rung's row count and pushed through ``call_cached_graph``,
        twice: on the card the first run is eager and the second captures
        the rung's CUDA graph. ``shapes`` overrides the rung list (row
        counts, each <= ``max_batch_size``). The proof (shared
        :func:`warm_and_seal`): after the first pass every rung is driven
        AGAIN and the block's signature counter must not move. Returns a
        summary dict; ``graphs`` gives the CUDA graphs captured per rung
        (1 each on the card, 0 on the CPU).
        """
        ex = [_to_host(a) for a in example_inputs]
        if not ex or any(a.ndim < 1 for a in ex):
            raise ValueError(
                "warmup needs one example request: arrays with a "
                "leading row dimension")
        rows = ex[0].shape[0]
        if any(a.shape[0] != rows for a in ex):
            raise ValueError("example inputs disagree on row count")
        if shapes is None:
            rungs = list(self.buckets)
        else:
            rungs = sorted({int(b) for b in shapes})
            if not rungs:
                raise ValueError("shapes must name at least one rung")
            if rungs[0] < 1 or rungs[-1] > self.max_batch_size:
                raise ValueError(
                    f"warmup shapes {rungs} outside "
                    f"1..{self.max_batch_size}")
        t0 = time.perf_counter()
        graphs = dict.fromkeys(rungs, 0)

        def drive(b):
            before = self._block.capture_count()
            out = self._block.call_cached_graph(*self._to_device(
                [pad_rows(a[:min(rows, b)], b) for a in ex]))
            graphs[b] += self._block.capture_count() - before
            ready = _ready_handle(_flatten_out(out))
            if ready is not None:
                ready.synchronize()

        warm_and_seal(drive, rungs,
                      lambda: self._block.jit_trace_count(False),
                      label="buckets")
        self._warm_traces = self._block.jit_trace_count(False)
        self._warm_captures = self._block.capture_count()
        return {
            "model": self.name,
            "buckets": rungs,
            "compile_traces": self._warm_traces,
            "graphs": graphs,
            "seconds": round(time.perf_counter() - t0, 4),
        }

    def recompiles_since_warmup(self):
        """New predict-variant signatures plus CUDA-graph captures since
        warmup() sealed — 0 is the steady-state invariant (a new shape
        online costs its eager first run and, on its next call, a
        capture; a weight whose storage moved costs a capture per rung
        served after it); None before warmup."""
        if self._warm_traces is None:
            return None
        return (self._block.jit_trace_count(False) - self._warm_traces
                + self._block.capture_count() - self._warm_captures)

    # -- client side -------------------------------------------------------
    def submit(self, *inputs, timeout_ms=None, priority=None):
        """Enqueue one request; returns a :class:`ServeRequest` handle.

        Each input must carry a leading row dimension (1 <= rows <=
        ``max_batch_size``). ``priority`` names a scheduler class
        (default: the highest-priority one, ``"interactive"`` under the
        stock two-class policy). Never blocks: a full queue sheds with
        :class:`Overloaded`, a class over its admission rate with
        :class:`RateLimited`, a stopped engine raises
        :class:`EngineStopped`. ``timeout_ms`` overrides the engine's
        per-request deadline (0 disables it).
        """
        arrays = [_to_host(a) for a in inputs]
        if not arrays or any(a.ndim < 1 for a in arrays):
            raise ValueError(
                "submit needs arrays with a leading row dimension")
        rows = arrays[0].shape[0]
        if any(a.shape[0] != rows for a in arrays):
            raise ValueError("request inputs disagree on row count")
        if rows < 1 or rows > self.max_batch_size:
            raise ValueError(
                f"request rows {rows} outside 1..{self.max_batch_size} "
                "(split oversized requests client-side)")
        signature = tuple(
            (tuple(a.shape[1:]), str(a.dtype)) for a in arrays)
        tmo = self.timeout_s if timeout_ms is None else float(
            timeout_ms) / 1e3
        deadline = (time.monotonic() + tmo) if tmo > 0 else None
        cls = str(priority) if priority is not None \
            else self._sched.default_class
        req = ServeRequest(tuple(arrays), rows, signature, deadline,
                           cls=cls)
        req.model = self.name
        try:  # head-based sampling decision: None on the unsampled path
            req.trace = _reqtrace.maybe_start(
                self.name, cls=cls, rows=rows, deadline=deadline)
        except Exception:
            req.trace = None
        if self._stopping:
            err = EngineStopped(f"engine {self.name!r} is stopped")
            req._finish("shed", error=err)  # terminal trace span
            raise err
        try:
            self._sched.offer(req)  # sheds with Overloaded / RateLimited
        except Overloaded as e:  # includes RateLimited
            req._finish("shed", error=e)  # terminal span with the reason
            raise
        return req

    def predict(self, *inputs, timeout_ms=None, priority=None):
        """Synchronous round-trip: submit + wait. Raises Overloaded /
        RequestTimeout / EngineStopped like submit()/result()."""
        req = self.submit(*inputs, timeout_ms=timeout_ms,
                          priority=priority)
        try:
            return req.result()
        except RequestTimeout:
            _instr.record_serve_request(self.name, "timeout")
            raise

    # -- pipeline: assemble + dispatch ------------------------------------
    def _assemble_dispatch(self, batch):
        """Pad the batch to its bucket on the host, move it to the device
        once, and issue the forward; returns a :class:`_Flight` (or None —
        the whole batch failed and was settled with the error)."""
        rows = sum(r.rows for r in batch)
        bucket = pick_bucket(self.buckets, rows)
        # sampled members share batch-wide boundary stamps (ONE
        # perf_counter read per boundary per batch) and a batch id —
        # the batch->request causality link; unsampled batches pay one
        # empty list comprehension here and nothing below
        traced = [r.trace for r in batch if r.trace is not None]
        batch_id = None
        if traced:
            batch_id = _reqtrace.next_batch_id()
            t_asm = time.perf_counter()
            for tr in traced:
                tr.stamp("assembling", t_asm)  # queue phase closes
                tr.batch_id = batch_id
                tr.bucket = bucket
        try:
            with _spans.span(self.name, cat="serve"):
                padded = assemble_batch([r.inputs for r in batch], bucket)
                nds = self._to_device(padded)
                if traced:
                    t_disp = time.perf_counter()
                    for tr in traced:
                        tr.stamp("dispatching", t_disp)
                out = self._block.call_cached_graph(*nds)
            datas = list(_flatten_out(out))
            ready = _ready_handle(datas)
            if traced:
                t_issued = time.perf_counter()
                for tr in traced:
                    tr.stamp("dispatched", t_issued)
            now = time.monotonic()
            for r in batch:
                r.t_dispatch = now
            self._c_dispatch.inc()
            self._bucket_dispatches[bucket] += 1
            return _Flight(batch, datas, ready, rows, bucket,
                           batch_id=batch_id, traced=traced)
        except Exception as e:  # noqa: BLE001 — batch failure -> per-request
            now = time.monotonic()
            for r in batch:
                if r._finish("error", error=e):
                    _instr.record_serve_request(
                        self.name, "error", now - r.t_submit)
            return None

    def _complete(self, flight):
        """Wait until the flight's outputs exist, slice each request's
        rows off, and settle the futures."""
        try:
            with _spans.span(self.name, cat="serve_complete"):
                if flight.ready is not None:
                    flight.ready.synchronize()
            if flight.traced:
                t_ready = time.perf_counter()
                for tr in flight.traced:
                    tr.stamp("ready", t_ready)  # device phase closes
            _instr.record_serve_batch(self.name, flight.rows,
                                      flight.bucket)
            off, now = 0, time.monotonic()
            for r in flight.batch:
                # slice off exactly this request's rows — bucket padding
                # never reaches a client
                sl = [d[off:off + r.rows] for d in flight.datas]
                res = sl[0] if len(sl) == 1 else tuple(sl)
                if r.trace is not None:
                    r.trace.stamp("sliced")
                if r._finish("ok", result=res):
                    _instr.record_serve_request(
                        self.name, "ok", now - r.t_submit)
                off += r.rows
            if flight.traced:
                _reqtrace.record_batch(
                    flight.batch_id, self.name, flight.traced,
                    flight.rows, flight.bucket)
        except Exception as e:  # noqa: BLE001 — batch failure -> per-request
            now = time.monotonic()
            for r in flight.batch:
                if r._finish("error", error=e):
                    _instr.record_serve_request(
                        self.name, "error", now - r.t_submit)

    # -- pipelined mode: assembler + completer threads ---------------------
    def _loop_assembler(self):
        while True:
            batch = self._sched.collect(self.max_batch_size,
                                        self.max_wait_s)
            if batch is None:
                break
            # host work (pad/concat) + async dispatch happen OUTSIDE the
            # window lock: this is exactly the overlap — the device is
            # still computing the previous flight(s) while we assemble
            flight = self._assemble_dispatch(batch)
            if flight is None:
                continue
            with self._icond:
                # the window bound holds even while draining — only a
                # FORCE stop lifts it (so a dead completer can't wedge
                # shutdown); a graceful drain keeps dispatch-ahead bounded
                while (len(self._inflight) >= self.max_inflight
                       and not self._force):
                    self._icond.wait(0.05)
                self._inflight.append(flight)
                self._inflight_rows += flight.rows
                depth = len(self._inflight)
                if depth > self._max_inflight_seen:
                    self._max_inflight_seen = depth
                self._g_inflight.set(self._inflight_rows)
                self._g_inflight_batches.set(depth)
                self._icond.notify_all()
        with self._icond:  # sentinel: completer exits after draining
            self._inflight.append(None)
            self._icond.notify_all()

    def _loop_completer(self):
        while True:
            with self._icond:
                while not self._inflight:
                    self._icond.wait(0.05)
                flight = self._inflight[0]
                if flight is None:
                    self._inflight.popleft()
                    self._g_inflight.set(0)
                    self._g_inflight_batches.set(0)
                    return
            self._complete(flight)  # blocks on device results, settles
            with self._icond:
                self._inflight.popleft()
                self._inflight_rows -= flight.rows
                self._g_inflight.set(self._inflight_rows)
                self._g_inflight_batches.set(len(self._inflight))
                self._icond.notify_all()

    # -- sync mode: the serialized baseline --------------------------------
    def _loop_sync(self):
        while True:
            batch = self._sched.collect(self.max_batch_size,
                                        self.max_wait_s)
            if batch is None:
                return
            flight = self._assemble_dispatch(batch)
            if flight is None:
                continue
            if not self._max_inflight_seen:
                self._max_inflight_seen = 1
            self._g_inflight.set(flight.rows)
            self._g_inflight_batches.set(1)
            self._complete(flight)
            self._g_inflight.set(0)
            self._g_inflight_batches.set(0)

    # -- observability -----------------------------------------------------
    def queue_depth(self):
        """Queued requests right now (mirrors serve_queue_depth)."""
        return self._sched.depth()

    def inflight_rows(self):
        """Rows inside dispatched-but-unsettled batches (mirrors
        serve_in_flight)."""
        with self._icond:
            return self._inflight_rows

    def load(self):
        """Least-loaded routing score for the front door: queued rows +
        in-flight rows (the same quantities the serve_queue_depth and
        serve_in_flight gauges publish)."""
        return self._sched.depth_rows() + self.inflight_rows()

    def _latency_quantile_ms(self, q):
        """Approximate latency quantile (ms) from the telemetry histogram
        (upper bound of the covering bucket); None when no samples or
        telemetry is disabled."""
        child = _instr.serve_request_latency_seconds.labels(self.name)
        count = child.count
        if not count:
            return None
        target = q * count
        cum = child.cumulative()
        for bound, acc in cum:
            if acc >= target:
                if bound == float("inf"):
                    bound = cum[-2][0] if len(cum) > 1 else 0.0
                return round(float(bound) * 1e3, 3)
        return None

    def admission_state(self):
        """What a submit() would meet right now: ``"ok"`` (admitted),
        ``"overloaded"`` (queue at bound — the next submit sheds with
        :class:`Overloaded`), or ``"stopped"``. The ops server's
        ``/readyz`` reports not-ready unless every registered engine is
        ``"ok"`` — a front door stops routing to a shedding replica and
        resumes once its queue drains."""
        if self._stopping:
            return "stopped"
        if self._sched.at_bound():
            return "overloaded"
        return "ok"

    def bucket_dispatches(self):
        """``{rung: dispatches}`` since the engine was made (the keys of
        ``stats()`` stay the JAX package's)."""
        return dict(self._bucket_dispatches)

    def stats(self):
        """Live snapshot: queue/in-flight, outcome counters, batch shape,
        latency p50/p99, per-class scheduler state, pipeline window, and
        the zero-recompile invariant."""
        outcomes = {
            lv[1]: c.value
            for lv, c in _instr.serve_request_total.series()
            if lv[0] == self.name}
        batches = _instr.serve_batch_total.labels(self.name).value
        bs = _instr.serve_batch_size.labels(self.name)
        with self._icond:
            inflight_batches = sum(
                1 for f in self._inflight if f is not None)
            inflight_rows = self._inflight_rows
            max_seen = self._max_inflight_seen
        return {
            "model": self.name,
            "started": self.started,
            "mode": self.mode,
            "buckets": list(self.buckets),
            "queue_depth": self._sched.depth(),
            "max_queue": self.max_queue,
            "in_flight": inflight_rows,
            "inflight_batches": inflight_batches,
            "max_inflight": self.max_inflight,
            "max_inflight_seen": max_seen,
            "classes": self._sched.class_stats(),
            "requests": outcomes,
            "batches": batches,
            "dispatches": self._c_dispatch.value,
            "avg_batch_rows": round(bs.sum / bs.count, 3) if bs.count
            else None,
            "padded_rows":
                _instr.serve_padded_rows_total.labels(self.name).value,
            "drain_dropped":
                _instr.serve_drain_dropped_total.labels(self.name).value,
            "p50_ms": self._latency_quantile_ms(0.50),
            "p99_ms": self._latency_quantile_ms(0.99),
            "recompiles_since_warmup": self.recompiles_since_warmup(),
            "trace_sample": self._trace_sample(),
            "slo": self._slo_status(),
        }

    def _trace_sample(self):
        try:
            return _reqtrace.sample_rate()
        except Exception:
            return 0.0

    def _slo_status(self):
        """This model's per-class SLO table (None when no class has a
        declared objective or no traffic has been observed)."""
        try:
            return _reqtrace.slo_status().get(self.name)
        except Exception:
            return None
