"""Priority-class request scheduler: strict-priority dequeue + per-class
token-bucket admission for the serving engine (a copy of
mxnet_tpu/serving/scheduler.py).

The continuous-batching pipeline (engine.py) separates *what to serve
next* from *how to execute it*; this module owns the first half. It is
the TF-Serving batch-queue generalized to priority classes (PAPERS.md
"TensorFlow", §serving):

  * every request belongs to a :class:`ServeClass` — by default
    ``interactive`` (priority 0, served first) and ``batch`` (priority
    10, rides along in spare capacity);
  * dequeue is STRICT priority: the next micro-batch's head is always
    the oldest request of the highest-priority non-empty class, so an
    overload of batch-class work can never starve interactive traffic
    (the inverse — batch starvation under interactive overload — is the
    documented, intended behavior; cap it with a rate on the
    interactive class);
  * admission is layered: a per-class token bucket (``rate``/``burst``)
    sheds with :class:`~mxnet_tpu_torch.serving.errors.RateLimited`
    BEFORE the shared queue bound sheds with
    :class:`~mxnet_tpu_torch.serving.errors.Overloaded` — both
    deterministic and immediate, never a blocked client;
  * batch fill stays signature-safe: after the head is chosen, only
    same-signature requests coalesce, scanned in priority order, so a
    lower class can fill spare rows of a higher-class batch but never
    reorder its own FIFO;
  * everything is observable per class: ``serve_class_queue_depth``
    gauges and ``serve_class_shed_total{reason=queue|rate}`` counters.

Stdlib-only (threading + time); telemetry is the only framework import,
mirroring buckets.py's layering.
"""
from __future__ import annotations

import collections
import threading
import time

from ..telemetry import instruments as _instr
from .errors import Overloaded, RateLimited, RequestTimeout

__all__ = ["ServeClass", "TokenBucket", "RequestScheduler",
           "DEFAULT_CLASSES"]


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.

    ``try_take`` is called under the scheduler lock, so refill
    bookkeeping needs no lock of its own. ``rate=None`` means unlimited
    (every take succeeds).
    """

    __slots__ = ("rate", "burst", "_tokens", "_t_last")

    def __init__(self, rate=None, burst=None):
        self.rate = None if rate is None else float(rate)
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0 or None, got {rate}")
        self.burst = float(burst if burst is not None
                           else max(1.0, self.rate or 1.0))
        self._tokens = self.burst
        self._t_last = time.monotonic()

    def try_take(self, n=1.0):
        if self.rate is None:
            return True
        now = time.monotonic()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t_last) * self.rate)
        self._t_last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class ServeClass:
    """One priority class: name, strict-priority rank (lower serves
    first), and an optional token-bucket admission rate."""

    __slots__ = ("name", "priority", "rate", "burst")

    def __init__(self, name, priority=0, rate=None, burst=None):
        self.name = str(name)
        self.priority = int(priority)
        self.rate = rate
        self.burst = burst


#: The default two-class policy: interactive traffic strictly first,
#: batch-class work fills the slack. No rate limits — defaults shed only
#: at the shared queue bound.
DEFAULT_CLASSES = (ServeClass("interactive", priority=0),
                   ServeClass("batch", priority=10))


class _ClassQueue:
    __slots__ = ("cls", "queue", "bucket", "g_depth")

    def __init__(self, cls, model):
        self.cls = cls
        self.queue = collections.deque()
        self.bucket = TokenBucket(cls.rate, cls.burst)
        self.g_depth = _instr.serve_class_queue_depth.labels(model,
                                                            cls.name)


class RequestScheduler:
    """Strict-priority, signature-aware micro-batch scheduler.

    Owns the per-class FIFO queues, the shared admission bound, deadline
    expiry sweeps, and the condition variable the engine's assembler
    blocks on. The engine calls :meth:`offer` from client threads and
    :meth:`collect` from exactly one assembler thread.
    """

    def __init__(self, model, classes=None, max_queue=256):
        self.model = str(model)
        self.max_queue = int(max_queue)
        classes = tuple(classes) if classes else DEFAULT_CLASSES
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")
        # stable sort: priority rank first, declaration order breaks ties
        self._classes = {
            c.name: _ClassQueue(c, self.model)
            for c in sorted(classes, key=lambda c: c.priority)}
        self.default_class = next(iter(self._classes))
        self.cond = threading.Condition()
        self._stopping = False
        self._forced = False

    # -- admission (client threads) ---------------------------------------
    def class_names(self):
        return list(self._classes)

    def offer(self, req):
        """Admit one request into its class queue, or shed.

        Sheds with :class:`RateLimited` when the class token bucket is
        empty, :class:`Overloaded` when the shared queue bound is hit —
        both recorded per class in ``serve_class_shed_total``. Never
        blocks."""
        cq = self._classes.get(req.cls)
        if cq is None:
            raise ValueError(
                f"unknown priority class {req.cls!r}; classes: "
                f"{list(self._classes)}")
        with self.cond:
            if not cq.bucket.try_take():
                self._record_shed(cq, "rate")
                raise RateLimited(
                    f"engine {self.model!r} class {req.cls!r} over its "
                    f"{cq.bucket.rate:g}/s admission rate; request shed")
            if self.depth_locked() >= self.max_queue:
                self._record_shed(cq, "queue")
                raise Overloaded(
                    f"engine {self.model!r} queue at bound "
                    f"{self.max_queue}; request shed")
            cq.queue.append(req)
            tr = getattr(req, "trace", None)
            if tr is not None:  # reqtrace: admission won — admit phase
                tr.stamp("admitted")  # closes, queue phase opens
            cq.g_depth.set(len(cq.queue))
            self._set_total_gauge()
            self.cond.notify_all()

    def _record_shed(self, cq, reason):
        _instr.record_serve_request(self.model, "shed")
        _instr.serve_class_shed_total.labels(
            self.model, cq.cls.name, reason).inc()

    # -- bookkeeping (call with self.cond held) ----------------------------
    def depth_locked(self):
        return sum(len(cq.queue) for cq in self._classes.values())

    def _set_total_gauge(self):
        _instr.serve_queue_depth.labels(self.model).set(self.depth_locked())

    def _expire_locked(self):
        """Drop finished (client-claimed) and past-deadline requests."""
        now = time.monotonic()
        changed = False
        for cq in self._classes.values():
            keep = collections.deque()
            for r in cq.queue:
                if r.done:
                    changed = True
                    continue  # client already claimed (timeout) — drop
                if r.deadline is not None and now >= r.deadline:
                    if r._finish("timeout", error=RequestTimeout(
                            "deadline elapsed while queued")):
                        _instr.record_serve_request(
                            self.model, "timeout", now - r.t_submit)
                    changed = True
                    continue
                keep.append(r)
            if len(keep) != len(cq.queue):
                cq.queue = keep
                cq.g_depth.set(len(keep))
        if changed:
            self._set_total_gauge()

    def _pop_head_locked(self):
        """Oldest request of the highest-priority non-empty class."""
        for cq in self._classes.values():
            if cq.queue:
                r = cq.queue.popleft()
                cq.g_depth.set(len(cq.queue))
                return r
        return None

    def _fill_locked(self, signature, room):
        """Same-signature requests that fit in ``room`` rows, scanned in
        priority order; per class only the head run is taken (never scan
        past a mismatched head — class FIFO order is preserved)."""
        taken = []
        for cq in self._classes.values():
            while room > 0 and cq.queue:
                nxt = cq.queue[0]
                if nxt.done or (nxt.deadline is not None
                                and time.monotonic() >= nxt.deadline):
                    self._expire_locked()
                    continue
                if nxt.signature != signature or nxt.rows > room:
                    break
                cq.queue.popleft()
                cq.g_depth.set(len(cq.queue))
                taken.append(nxt)
                room -= nxt.rows
        return taken

    # -- batching (the one assembler thread) -------------------------------
    def collect(self, max_rows, max_wait_s):
        """Block for the next micro-batch (list of requests, head first).

        The head is strict-priority FIFO; the batch fills with
        same-signature requests until ``max_rows`` or until the head has
        waited ``max_wait_s`` since submit. Returns None when the
        scheduler is stopped and (drained, or force-stopped)."""
        with self.cond:
            while True:
                self._expire_locked()
                if self._forced:
                    return None
                head = self._pop_head_locked()
                if head is not None:
                    break
                if self._stopping:
                    return None
                self.cond.wait(0.05)
            batch, rows = [head], head.rows
            launch_at = head.t_submit + max_wait_s
            while rows < max_rows:
                taken = self._fill_locked(head.signature, max_rows - rows)
                if taken:
                    batch.extend(taken)
                    rows += sum(r.rows for r in taken)
                    continue
                if self._next_head_locked() is not None:
                    break  # head-of-line mismatch: launch now, batch next
                remaining = launch_at - time.monotonic()
                if remaining <= 0 or self._stopping or self._forced:
                    break
                self.cond.wait(min(remaining, 0.05))
            self._set_total_gauge()
        return batch

    def _next_head_locked(self):
        for cq in self._classes.values():
            if cq.queue:
                return cq.queue[0]
        return None

    # -- shutdown ----------------------------------------------------------
    def stop(self, force=False):
        """Stop: collect() returns None once drained (or immediately
        when ``force``); offer() admission is the engine's job."""
        with self.cond:
            self._stopping = True
            if force:
                self._forced = True
            self.cond.notify_all()

    def drain_all(self):
        """Pop every queued request (stop paths); returns them oldest
        first in priority order."""
        with self.cond:
            out = []
            for cq in self._classes.values():
                out.extend(cq.queue)
                cq.queue.clear()
                cq.g_depth.set(0)
            self._set_total_gauge()
        return out

    def latest_deadline(self):
        """The latest absolute deadline among queued requests — the
        moment past which draining is pointless (everything left will
        have expired). None when the queue is empty or any queued
        request is deadline-less."""
        with self.cond:
            deadlines = []
            for cq in self._classes.values():
                for r in cq.queue:
                    if r.deadline is None:
                        return None
                    deadlines.append(r.deadline)
        return max(deadlines) if deadlines else None

    # -- introspection -----------------------------------------------------
    def depth(self):
        with self.cond:
            return self.depth_locked()

    def depth_rows(self):
        with self.cond:
            return sum(r.rows for cq in self._classes.values()
                       for r in cq.queue)

    def at_bound(self):
        with self.cond:
            return self.depth_locked() >= self.max_queue

    def class_stats(self):
        """{class: {priority, depth, rate, shed_queue, shed_rate}}."""
        sheds = {
            (lv[1], lv[2]): c.value
            for lv, c in _instr.serve_class_shed_total.series()
            if lv[0] == self.model}
        with self.cond:
            return {
                name: {
                    "priority": cq.cls.priority,
                    "depth": len(cq.queue),
                    "rate": cq.bucket.rate,
                    "shed_queue": sheds.get((name, "queue"), 0),
                    "shed_rate": sheds.get((name, "rate"), 0),
                }
                for name, cq in self._classes.items()}
