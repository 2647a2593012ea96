"""mxnet_tpu_torch.telemetry — runtime counters/gauges/histograms and their
exporters (counterpart of mxnet_tpu/telemetry).

A process-wide, thread-safe metrics registry (registry.py) with three
sinks:

  * ``telemetry.dump()``            JSON snapshot
  * ``telemetry.prometheus_text()`` Prometheus text exposition format
  * ``telemetry.emit_chrome_counters()``  chrome-trace counter events

and the serving tier's instruments (instruments.py: the ``serve_*``
catalog, which the JAX engine and the port's engine record under the same
names and labels). ``MXTPU_TELEMETRY=0`` disables collection at import
(every record helper early-outs on one bool check);
``telemetry.disable()``/``enable()`` toggle at runtime,
``telemetry.reset()`` zeroes every series.
"""
from __future__ import annotations

from . import instruments, promparse  # noqa: F401
from .chrome import emit_chrome_counters  # noqa: F401
from .exporters import dump, prometheus_text, write_prometheus  # noqa: F401
from .instruments import record_serve_batch, record_serve_request  # noqa: F401
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    disable,
    enable,
    enabled,
    gauge,
    histogram,
    reset,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "DEFAULT_BUCKETS",
    "counter", "gauge", "histogram",
    "enable", "disable", "enabled", "reset",
    "dump", "prometheus_text", "write_prometheus", "emit_chrome_counters",
    "instruments", "promparse",
    "record_serve_batch", "record_serve_request",
]
