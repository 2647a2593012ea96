"""Chrome-trace bridge: metrics as counter events on a trace timeline
(counterpart of mxnet_tpu/telemetry/chrome.py).

:func:`emit_chrome_counters` snapshots the registry into one chrome counter
event (``"ph": "C"``) per series at the current ``time.perf_counter()``
timestamp, the clock of the diagnostics spans
(diagnostics/spans.py:emit_chrome_spans), so the two land on one
chrome://tracing / Perfetto timeline. The JAX package appends the events to
its profiler's host buffer; the port has no profiler module yet, so the
events go into ``sink`` (any list) and are returned:
``json.dump({"traceEvents": events}, f)`` writes a loadable trace.

Series are named `name{label="v",...}`; histograms surface as two
counters, `name_count` and `name_sum` (chrome counters plot scalars, not
distributions).
"""
from __future__ import annotations

import os
import threading
import time

from .exporters import _label_str
from .registry import REGISTRY

__all__ = ["emit_chrome_counters"]


def _counter_event(name, value, ts_us):
    return {"name": name, "ph": "C", "ts": ts_us, "pid": os.getpid(),
            "tid": threading.get_ident(), "args": {"value": float(value)}}


def emit_chrome_counters(registry=None, sink=None):
    """One chrome counter event per series (``sink.extend``-ed when a list
    is given); returns the events."""
    registry = registry or REGISTRY
    ts = time.perf_counter() * 1e6
    events = []
    for m in registry.collect():
        for labelvalues, child in m.series():
            ls = _label_str(m, labelvalues)
            if m.typ == "histogram":
                events.append(_counter_event(f"{m.name}_count{ls}",
                                             child.count, ts))
                events.append(_counter_event(f"{m.name}_sum{ls}",
                                             child.sum, ts))
            else:
                events.append(_counter_event(f"{m.name}{ls}", child.value,
                                             ts))
    if sink is not None:
        sink.extend(events)
    return events
