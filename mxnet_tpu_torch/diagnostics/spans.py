"""Span-based tracer: nested, thread-safe host spans in a ring buffer
(counterpart of mxnet_tpu/diagnostics/spans.py).

The telemetry registry answers "how many / how much"; spans answer "WHERE
did the milliseconds go". An instrumented layer wraps its hot region in
``diagnostics.span(name, cat=phase)``; the serving engine wraps each
batch's assembly and dispatch (``serve``) and the wait for its outputs
(``serve_complete``).

Records land in a bounded ring (``MXTPU_DIAG_RING_CAPACITY``, default
4096 — old spans fall off, memory stays bounded), each tagged with the
step index live at the time, so :func:`step_table` can pivot the ring into
a per-step phase breakdown and :func:`emit_chrome_spans` can replay it as
chrome-trace "X" events (``time.perf_counter()`` timestamps, the clock of
telemetry/chrome.py and observability/reqtrace.py).

``MXTPU_DIAGNOSTICS=0`` disables collection at import; every helper
early-outs on one bool check, so instrumented hot paths cost one branch
when off.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

from .. import env as _env

__all__ = [
    "span", "enabled", "enable", "disable", "reset",
    "records", "set_ring_capacity", "ring_capacity",
    "current_stack", "all_stacks",
    "mark_step", "current_step",
    "set_trace_context", "trace_context",
    "step_table", "format_step_table", "emit_chrome_spans",
    "PHASES",
]

# the phase vocabulary step_table pivots on, the JAX package's (free-form
# cats still record; they land in the 'other' column). "serve" is the
# serving engine's batch-execution phase (serving/engine.py).
PHASES = ("data", "fwd", "bwd", "collective", "optimizer", "sync",
          "compile", "checkpoint", "serve")

_enabled = bool(_env.get("MXTPU_DIAGNOSTICS"))

_DEFAULT_CAPACITY = int(_env.get("MXTPU_DIAG_RING_CAPACITY"))
_ring = collections.deque(maxlen=max(1, _DEFAULT_CAPACITY))
_ring_lock = threading.Lock()

_tls = threading.local()

# tid -> the thread's live span stack (shared view for all_stacks;
# entries are (name, cat, t0). The list object is the SAME one _tls holds,
# so reads here see pushes/pops without cross-thread bookkeeping.)
_open_stacks = {}
_open_lock = threading.Lock()


def _reinit_after_fork():
    # spans record from serving threads; a fork landing inside a
    # ring/stack critical section would leave the lock held forever in
    # the child
    global _ring_lock, _open_lock
    _ring_lock = threading.Lock()
    _open_lock = threading.Lock()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_after_fork)

_step = [0]  # step index, advanced by mark_step()

# cross-rank trace correlation: (job, rank) stamped onto every record; with
# the step index already on it, (job, step) aligns ranks
_trace_ctx = {}


def set_trace_context(job=None, rank=None):
    """Stamp (job, rank) onto every subsequently recorded span."""
    if job is not None:
        _trace_ctx["job"] = str(job)
    if rank is not None:
        _trace_ctx["rank"] = int(rank)


def trace_context():
    return dict(_trace_ctx)


def enabled():
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def set_ring_capacity(n):
    """Rebound the ring (existing records are kept up to the new cap);
    returns the previous capacity."""
    global _ring
    n = max(1, int(n))
    with _ring_lock:
        prev = _ring.maxlen
        _ring = collections.deque(_ring, maxlen=n)
    return prev


def ring_capacity():
    return _ring.maxlen


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        with _open_lock:
            # prune stacks of dead threads while we hold the lock anyway
            live = {t.ident for t in threading.enumerate()}
            for tid in [t for t in _open_stacks if t not in live]:
                del _open_stacks[tid]
            _open_stacks[threading.get_ident()] = st
    return st


@contextlib.contextmanager
def span(name, cat="host"):
    """Record a nested host span. Thread-safe; zero-ish cost when
    disabled. The record keeps wall times from ``time.perf_counter()``
    (the trace clock), the nesting depth, and the current step index."""
    if not _enabled:
        yield
        return
    st = _stack()
    t0 = time.perf_counter()
    st.append((name, cat, t0))
    try:
        yield
    finally:
        # record even when the body raises — the failing region is
        # exactly the one worth seeing
        t1 = time.perf_counter()
        st.pop()
        rec = {
            "name": name, "cat": cat,
            "t0": t0, "dur": t1 - t0,
            "tid": threading.get_ident(),
            "depth": len(st),
            "step": _step[0],
        }
        if _trace_ctx:
            rec.update(_trace_ctx)
        with _ring_lock:
            _ring.append(rec)


def records():
    """Snapshot of the ring, oldest first."""
    with _ring_lock:
        return list(_ring)


def reset():
    """Drop recorded spans and rewind the step counter (open spans on
    other threads keep running and will record on exit)."""
    with _ring_lock:
        _ring.clear()
    _step[0] = 0


def mark_step():
    """Advance the step index (spans recorded before the Nth call belong
    to step N)."""
    _step[0] += 1
    return _step[0]


def current_step():
    return _step[0]


def current_stack():
    """Names of the calling thread's open spans, outermost first."""
    return [name for name, _cat, _t0 in getattr(_tls, "stack", ())]


def all_stacks():
    """{thread_ident: [open span names]} across ALL threads — what
    everyone is inside right now."""
    with _open_lock:
        return {tid: [name for name, _c, _t in list(st)]
                for tid, st in _open_stacks.items() if st}


# ---------------------------------------------------------------------------
# per-step phase breakdown
# ---------------------------------------------------------------------------

def step_table(recs=None):
    """Pivot span records into {step: {phase: seconds}}.

    Only depth-0 spans of each category are summed (a ``fwd`` span nested
    under another ``fwd`` span would double-count its parent's time).
    Categories outside PHASES accumulate under ``other``.
    """
    recs = records() if recs is None else recs
    # innermost-per-category: keep a span unless an enclosing span of the
    # SAME category covers it (nested fwd under fwd); cheap approximation:
    # group by (step, cat) over minimum depth seen for that pair
    min_depth = {}
    for r in recs:
        key = (r["step"], r["cat"], r["tid"])
        d = min_depth.get(key)
        if d is None or r["depth"] < d:
            min_depth[key] = r["depth"]
    table = {}
    for r in recs:
        if r["depth"] != min_depth[(r["step"], r["cat"], r["tid"])]:
            continue
        phase = r["cat"] if r["cat"] in PHASES else "other"
        row = table.setdefault(r["step"], {})
        row[phase] = row.get(phase, 0.0) + r["dur"]
    return table


def format_step_table(recs=None):
    """The per-step breakdown as a fixed-width text table (milliseconds)."""
    table = step_table(recs)
    cols = list(PHASES) + ["other"]
    lines = [f"{'step':>6}" + "".join(f"{c:>12}" for c in cols)
             + f"{'total':>12}"]
    for step in sorted(table):
        row = table[step]
        total = sum(row.values())
        lines.append(
            f"{step:>6}"
            + "".join(f"{row.get(c, 0.0) * 1e3:>12.3f}" for c in cols)
            + f"{total * 1e3:>12.3f}")
    if len(lines) == 1:
        lines.append("  (no spans recorded)")
    return "\n".join(lines)


def emit_chrome_spans(sink=None):
    """The ring as chrome-trace "X" events (cat = ``diag.<phase>``, ts and
    dur in microseconds of ``time.perf_counter()``), ``sink.extend``-ed
    when a list is given; returns the events. The JAX package replays them
    into its profiler's host buffer; the port has no profiler module yet
    (telemetry/chrome.py does the same for the metrics)."""
    pid = os.getpid()
    events = [{"name": f"span::{r['name']}", "ph": "X", "pid": pid,
               "tid": r["tid"], "ts": r["t0"] * 1e6, "dur": r["dur"] * 1e6,
               "cat": f"diag.{r['cat']}",
               "args": {"step": r["step"], "depth": r["depth"]}}
              for r in records()]
    if sink is not None:
        sink.extend(events)
    return events
