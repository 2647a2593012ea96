"""Request-level tracing + SLO plane for the serving tier (counterpart of
mxnet_tpu/observability/reqtrace.py).

Telemetry aggregates and the diagnostics spans answer "what is this
process doing"; this module answers "where did this REQUEST spend its
time" (the Dapper-style trace-propagation template of PAPERS.md). A trace
context minted at ``InferenceEngine.submit`` rides the ``ServeRequest``
through scheduler admission, batch assembly, the in-flight window and the
completer, accumulating BOUNDARY stamps that telescope into contiguous
phase spans:

    admit | queue | assemble | dispatch | device | slice | settle

Because consecutive phases share their boundary timestamp, the span
durations of one trace sum EXACTLY to its end-to-end latency — there is no
untraced gap for time to hide in. On the card the ``device`` phase closes
when the completer returns from waiting on the batch's CUDA event, which
the engine records on the stream right after the forward was issued: the
kernels have run, not merely been launched. Requests coalesced into one
padded micro-batch share the batch-wide stamps (one ``perf_counter`` read
per boundary per batch) and carry the same ``batch`` id; the batch itself
lands in a parallel ring with its member trace IDs — the batch->request
causality link. Shed and expired requests get a terminal span named after
the outcome with the shed reason, so dropped traffic stays visible.

Sampling is head-based and deterministic: ``MXTPU_TRACE_SAMPLE`` is the
sampled fraction, decided once at submit by a counter (no RNG — rates are
exact, runs are reproducible). At 0 (the default) ``maybe_start`` returns
None before touching anything and every engine hook degrades to one ``is
None`` check. Finished traces live in a bounded per-process ring
(``MXTPU_TRACE_RING``); span timestamps are ``perf_counter``, the clock of
the diagnostics spans.

On top rides the SLO plane, which sees EVERY request (objectives are
evaluated on the full population, never a sample):
``MXTPU_SLO_<CLASS>_MS`` declares a per-class latency objective;
:func:`slo_observe` folds each finished request into a rolling window
(``MXTPU_SLO_WINDOW_S``) as good/bad against the objective (sheds,
timeouts and errors are always bad); the burn rate is the windowed bad
fraction over the error budget ``1 - MXTPU_SLO_TARGET``. A class burning
hotter than ``MXTPU_SLO_BURN_MAX`` (with at least ``MXTPU_SLO_MIN_EVENTS``
events in window) is listed by :func:`slo_burning`, and recovers once the
window rolls the violations off. Burn rates are published as
``serve_slo_burn_rate`` gauges.

Stdlib-only; telemetry is reached lazily and guarded — a broken
observability layer must never take the serving path down with it.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time

__all__ = [
    "PHASES", "ReqTrace",
    "sample_rate", "enabled", "maybe_start", "next_batch_id",
    "finish", "record_batch",
    "traces", "batches", "phase_summary",
    "ring_capacity", "set_ring_capacity", "reset",
    "slo_objective_ms", "set_slo_objective", "slo_observe",
    "slo_status", "slo_burning",
]

#: Phase vocabulary, in pipeline order. Each phase is closed by the next
#: boundary stamp; the terminal phase (settle, or the failure outcome)
#: closes at finish time.
PHASES = ("admit", "queue", "assemble", "dispatch", "device", "slice",
          "settle")

# boundary stamp -> the phase it CLOSES (submit time opens "admit")
_PHASE_OF = {
    "admitted": "admit",        # scheduler.offer accepted the request
    "assembling": "queue",      # the assembler picked it into a batch
    "dispatching": "assemble",  # host pad/concat done, issuing dispatch
    "dispatched": "dispatch",   # async dispatch returned
    "ready": "device",          # the batch's outputs exist
    "sliced": "slice",          # this request's rows sliced off
}

_SHED_REASON = {  # error type -> the reason stamped on terminal spans
    "RateLimited": "rate",
    "Overloaded": "queue",
    "RequestTimeout": "deadline",
    "EngineStopped": "stopped",
}

_DEFAULT_RING = 1024
_BATCH_RING = 512

_ring = collections.deque(maxlen=_DEFAULT_RING)
_batch_ring = collections.deque(maxlen=_BATCH_RING)
_lock = threading.Lock()
_ring_synced = [False]

_trace_ids = itertools.count(1)
_batch_ids = itertools.count(1)
_sample_seq = itertools.count(1)

_slo_lock = threading.Lock()
_slo_windows = {}    # (model, cls) -> deque[(monotonic_t, good)]
_slo_overrides = {}  # cls -> objective ms (programmatic, beats env)


def _reinit_after_fork():
    # a fork landing inside the critical section would leave the lock
    # held forever in the child
    global _lock, _slo_lock
    _lock = threading.Lock()
    _slo_lock = threading.Lock()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_after_fork)


def _env_float(name, default):
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# sampling + the trace context
# ---------------------------------------------------------------------------


def sample_rate():
    """The head-based sample fraction from MXTPU_TRACE_SAMPLE, clamped
    to [0, 1]. 0 (default) = tracing fully off."""
    return min(1.0, max(0.0, _env_float("MXTPU_TRACE_SAMPLE", 0.0)))


def enabled():
    return sample_rate() > 0.0


def maybe_start(model, cls="interactive", rows=1, deadline=None):
    """Mint a :class:`ReqTrace` for this request, or None.

    The head-based sampling decision happens HERE, once, at submit:
    unsampled requests carry ``trace=None`` and every downstream hook
    is a single ``is None`` check. The sampler is a deterministic
    counter (request n is sampled iff ``floor(n*rate)`` advances), so a
    rate of 0.1 traces exactly every 10th request — no RNG, exact
    rates, reproducible runs."""
    rate = sample_rate()
    if rate <= 0.0:
        return None
    n = next(_sample_seq)
    if rate < 1.0 and int(n * rate) == int((n - 1) * rate):
        return None
    return ReqTrace(model, cls, rows, deadline)


def next_batch_id():
    """A fresh batch id for one assembled micro-batch (the causality
    link every member trace records)."""
    return next(_batch_ids)


class ReqTrace:
    """One sampled request's trace context: identity + boundary stamps.

    Mutated only by the engine pipeline (client thread at submit, the
    one assembler thread, the one completer thread — each boundary has
    exactly one writer); read only after :func:`finish` freezes it into
    the ring."""

    __slots__ = ("trace_id", "model", "cls", "rows", "deadline_ms",
                 "t_wall", "t0", "marks", "batch_id", "bucket", "extra")

    def __init__(self, model, cls, rows, deadline):
        self.trace_id = f"{os.getpid():x}-{next(_trace_ids):x}"
        self.model = str(model)
        self.cls = str(cls)
        self.rows = int(rows)
        self.deadline_ms = None if deadline is None else round(
            (deadline - time.monotonic()) * 1e3, 3)
        self.t_wall = time.time()
        self.t0 = time.perf_counter()
        self.marks = []          # [(boundary, perf_counter)]
        self.batch_id = None     # stamped by the assembler
        self.bucket = None
        self.extra = {}

    def stamp(self, boundary, t=None):
        """Close the current phase at ``t`` (a shared per-batch
        ``perf_counter`` read, or now)."""
        self.marks.append((boundary,
                           time.perf_counter() if t is None else t))

    def annotate(self, **fields):
        """Attach routing/context fields (FrontDoor stamps the chosen
        replica here)."""
        self.extra.update(fields)


# ---------------------------------------------------------------------------
# the finish chokepoint + rings
# ---------------------------------------------------------------------------


def finish(req, outcome, error=None):
    """The terminal chokepoint: called from ``ServeRequest._finish`` for
    EVERY settled outcome (ok / timeout / error / shed). Feeds the SLO
    window always; freezes the trace into the ring when the request was
    sampled. Never raises."""
    try:
        now = time.perf_counter()
        latency = time.monotonic() - req.t_submit
        slo_observe(getattr(req, "model", "") or "", req.cls, outcome,
                    latency)
        tr = getattr(req, "trace", None)
        if tr is None:
            return None
        reason = None
        if outcome != "ok":
            reason = _SHED_REASON.get(type(error).__name__,
                                      type(error).__name__
                                      if error is not None else outcome)
        spans, prev = [], tr.t0
        for boundary, t in tr.marks:
            spans.append({"phase": _PHASE_OF.get(boundary, boundary),
                          "t0": prev, "dur": t - prev})
            prev = t
        # terminal span: settle for served requests, the outcome (with
        # the shed reason) for everything dropped — contiguous with the
        # last boundary, so span durations still telescope to total
        spans.append({"phase": "settle" if outcome == "ok" else outcome,
                      "t0": prev, "dur": now - prev})
        rec = {
            "trace_id": tr.trace_id, "model": tr.model, "cls": tr.cls,
            "rows": tr.rows, "outcome": outcome, "reason": reason,
            "batch": tr.batch_id, "bucket": tr.bucket,
            "deadline_ms": tr.deadline_ms, "t_wall": tr.t_wall,
            "t0": tr.t0, "total_ms": (now - tr.t0) * 1e3,
            "spans": spans,
        }
        if tr.extra:
            rec["annotations"] = dict(tr.extra)
        _sync_ring()
        with _lock:
            _ring.append(rec)
        try:
            from ..telemetry import instruments as _instr

            _instr.record_serve_trace(tr.model, outcome)
        except Exception:
            pass
        return rec
    except Exception:
        return None


def record_batch(batch_id, model, traced, rows, bucket):
    """Freeze one completed micro-batch's shared span into the batch
    ring: the causality record linking ``batch_id`` to its member trace
    IDs, with the batch-wide assemble/dispatch/device phases (read off
    the first member's shared stamps). Never raises."""
    try:
        if not traced:
            return None
        stamps = dict(traced[0].marks)
        spans = []
        seq = [("assemble", "assembling", "dispatching"),
               ("dispatch", "dispatching", "dispatched"),
               ("device", "dispatched", "ready")]
        for phase, a, b in seq:
            if a in stamps and b in stamps:
                spans.append({"phase": phase, "t0": stamps[a],
                              "dur": stamps[b] - stamps[a]})
        rec = {
            "batch_id": batch_id, "model": str(model),
            "trace_ids": [tr.trace_id for tr in traced],
            "rows": int(rows), "bucket": int(bucket),
            "spans": spans,
        }
        with _lock:
            _batch_ring.append(rec)
        return rec
    except Exception:
        return None


def traces(n=None, cls=None, model=None):
    """Snapshot of finished request traces, oldest first, optionally
    filtered by class / model and trimmed to the newest ``n``."""
    with _lock:
        recs = list(_ring)
    if cls is not None:
        recs = [r for r in recs if r.get("cls") == str(cls)]
    if model is not None:
        recs = [r for r in recs if r.get("model") == str(model)]
    if n is not None:
        n = max(0, int(n))
        recs = recs[-n:] if n else []
    return recs


def batches(n=None):
    """Snapshot of batch causality records, oldest first."""
    with _lock:
        recs = list(_batch_ring)
    if n is not None:
        n = max(0, int(n))
        recs = recs[-n:] if n else []
    return recs


def phase_summary():
    """Per-phase aggregate over the ring: ``{phase: {avg_ms, n}}`` — the
    "where do requests spend time" answer."""
    agg = {}
    for rec in traces():
        for sp in rec.get("spans", ()):
            a = agg.setdefault(sp["phase"], [0.0, 0])
            a[0] += sp["dur"]
            a[1] += 1
    return {ph: {"avg_ms": round(s / c * 1e3, 4), "n": c}
            for ph, (s, c) in sorted(agg.items())}


def ring_capacity():
    return _ring.maxlen


def set_ring_capacity(n):
    """Rebound the trace ring, keeping the newest records; returns the
    previous capacity."""
    global _ring
    n = max(1, int(n))
    _ring_synced[0] = True  # an explicit call beats the env default
    with _lock:
        prev = _ring.maxlen
        _ring = collections.deque(_ring, maxlen=n)
    return prev


def _sync_ring():
    # one-time: honor MXTPU_TRACE_RING without import-order games
    if _ring_synced[0]:
        return
    _ring_synced[0] = True
    raw = os.environ.get("MXTPU_TRACE_RING")
    try:
        n = int(raw) if raw else _DEFAULT_RING
    except ValueError:
        n = _DEFAULT_RING
    if n != _ring.maxlen:
        set_ring_capacity(n)


def reset():
    """Test hygiene: drop traces, batch links, SLO windows, overrides,
    and the sampling counter (so deterministic head-based sampling
    restarts from request 1); re-arm the ring-capacity env sync."""
    global _sample_seq
    with _lock:
        _ring.clear()
        _batch_ring.clear()
    with _slo_lock:
        _slo_windows.clear()
        _slo_overrides.clear()
    _sample_seq = itertools.count(1)
    _ring_synced[0] = False


# ---------------------------------------------------------------------------
# the SLO plane
# ---------------------------------------------------------------------------


def slo_objective_ms(cls):
    """The latency objective for a class, in ms: a programmatic
    override (:func:`set_slo_objective`) beats ``MXTPU_SLO_<CLASS>_MS``.
    0 = no objective declared — the class is not SLO-tracked."""
    ob = _slo_overrides.get(str(cls))
    if ob is not None:
        return float(ob)
    return _env_float(f"MXTPU_SLO_{str(cls).upper()}_MS", 0.0)


def set_slo_objective(cls, ms):
    """Declare (or with ``ms=None`` clear) a class objective
    programmatically."""
    with _slo_lock:
        if ms is None:
            _slo_overrides.pop(str(cls), None)
        else:
            _slo_overrides[str(cls)] = float(ms)


def _slo_target():
    return min(0.9999, max(0.0, _env_float("MXTPU_SLO_TARGET", 0.99)))


def _slo_window_s():
    return max(0.001, _env_float("MXTPU_SLO_WINDOW_S", 60.0))


def _trim_locked(win, now):
    horizon = now - _slo_window_s()
    while win and win[0][0] < horizon:
        win.popleft()


def _burn_locked(win):
    """Windowed bad fraction over the error budget (1 - target)."""
    total = len(win)
    if not total:
        return None, 0
    bad = sum(1 for _, good in win if not good)
    budget = 1.0 - _slo_target()
    return (bad / total) / budget, total


def slo_observe(model, cls, outcome, latency_s=None):
    """Fold one finished request into its class's rolling SLO window.

    Good iff the request was served within its class objective; shed /
    timeout / error outcomes are always bad. Classes with no declared
    objective are ignored (zero bookkeeping on the default config).
    Publishes the fresh burn rate to ``serve_slo_burn_rate``."""
    obj = slo_objective_ms(cls)
    if obj <= 0:
        return None
    good = (outcome == "ok" and latency_s is not None
            and latency_s * 1e3 <= obj)
    now = time.monotonic()
    with _slo_lock:
        win = _slo_windows.setdefault((str(model), str(cls)),
                                      collections.deque())
        win.append((now, good))
        _trim_locked(win, now)
        burn, _ = _burn_locked(win)
    try:
        from ..telemetry import instruments as _instr

        _instr.set_slo_burn(model, cls, burn or 0.0)
        if not good:
            _instr.record_slo_violation(
                model, cls, outcome if outcome != "ok" else "latency")
    except Exception:
        pass
    return burn


def slo_status():
    """Live SLO table: ``{model: {cls: {objective_ms, target, window_s,
    events, bad, burn, burning}}}``. Reads re-trim the windows, so a
    replica RECOVERS (burn decays to None) once the window rolls its
    violations off — even with no new traffic."""
    burn_max = _env_float("MXTPU_SLO_BURN_MAX", 1.0)
    min_events = int(_env_float("MXTPU_SLO_MIN_EVENTS", 10))
    now = time.monotonic()
    out = {}
    with _slo_lock:
        items = [(k, collections.deque(v)) for k, v in
                 _slo_windows.items()]
    for (model, cls), win in items:
        _trim_locked(win, now)
        burn, total = _burn_locked(win)
        bad = sum(1 for _, good in win if not good)
        out.setdefault(model, {})[cls] = {
            "objective_ms": slo_objective_ms(cls),
            "target": _slo_target(),
            "window_s": _slo_window_s(),
            "events": total,
            "bad": bad,
            "burn": None if burn is None else round(burn, 4),
            "burning": bool(burn is not None and total >= min_events
                            and burn > burn_max),
        }
        try:
            from ..telemetry import instruments as _instr

            _instr.set_slo_burn(model, cls, burn or 0.0)
        except Exception:
            pass
    return out


def slo_burning():
    """``{"model/cls": burn}`` for every class currently burning past
    MXTPU_SLO_BURN_MAX (the set the JAX package's ops server turns into a
    503 on ``/readyz``). Empty dict = every declared objective is
    healthy."""
    out = {}
    for model, classes in slo_status().items():
        for cls, st in classes.items():
            if st["burning"]:
                out[f"{model}/{cls}"] = st["burn"]
    return out
