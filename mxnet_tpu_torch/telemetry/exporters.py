"""Telemetry sinks: JSON snapshot + Prometheus exposition text (a copy of
mxnet_tpu/telemetry/exporters.py).

Two of the three exporters (the chrome-trace bridge lives in chrome.py):

  * :func:`dump` — a plain-dict snapshot suitable for `json.dumps`,
    embedding in a tool's JSON line, or asserting in tests;
  * :func:`prometheus_text` — Prometheus text exposition format v0.0.4
    (`# HELP` / `# TYPE` comments, cumulative `_bucket{le=...}` series,
    `_sum`/`_count` for histograms) ready to serve from a /metrics
    endpoint or write to a node-exporter textfile.
"""
from __future__ import annotations

import math

from .registry import REGISTRY

__all__ = ["dump", "prometheus_text", "write_prometheus"]


def _labels_dict(metric, labelvalues):
    return dict(zip(metric.labelnames, labelvalues))


def dump(registry=None):
    """JSON-ready snapshot: {name: {type, help, samples: [...]}}.

    Counter/gauge samples are {labels, value}; histogram samples are
    {labels, count, sum, buckets} with cumulative bucket counts keyed by
    upper bound ('+Inf' last).
    """
    registry = registry or REGISTRY
    out = {}
    for m in registry.collect():
        samples = []
        for labelvalues, child in m.series():
            entry = {"labels": _labels_dict(m, labelvalues)}
            if m.typ == "histogram":
                entry["count"] = child.count
                entry["sum"] = child.sum
                entry["buckets"] = {
                    _le(bound): c for bound, c in child.cumulative()}
            else:
                entry["value"] = child.value
            samples.append(entry)
        out[m.name] = {"type": m.typ, "help": m.documentation,
                       "samples": samples}
    return out


def _le(bound):
    """Prometheus `le` rendering of a bucket upper bound."""
    if bound == float("inf"):
        return "+Inf"
    return _num(bound)


def _num(v):
    """Prometheus sample-value rendering (1.0 not 1, +Inf/-Inf/NaN)."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e17:
        return f"{v:.1f}"
    return repr(v)


def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _label_str(metric, labelvalues, extra=()):
    pairs = [(n, v) for n, v in zip(metric.labelnames, labelvalues)]
    pairs.extend(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{_escape_label(str(v))}"' for n, v in pairs)
    return "{" + inner + "}"


def prometheus_text(registry=None):
    """The registry in Prometheus text exposition format (one string)."""
    registry = registry or REGISTRY
    lines = []
    for m in registry.collect():
        if m.documentation:
            lines.append(f"# HELP {m.name} {_escape_help(m.documentation)}")
        lines.append(f"# TYPE {m.name} {m.typ}")
        for labelvalues, child in m.series():
            if m.typ == "histogram":
                for bound, cum in child.cumulative():
                    ls = _label_str(m, labelvalues,
                                    extra=[("le", _le(bound))])
                    lines.append(f"{m.name}_bucket{ls} {cum}")
                base = _label_str(m, labelvalues)
                lines.append(f"{m.name}_sum{base} {_num(child.sum)}")
                lines.append(f"{m.name}_count{base} {child.count}")
            else:
                ls = _label_str(m, labelvalues)
                lines.append(f"{m.name}{ls} {_num(child.value)}")
    return "\n".join(lines) + "\n" if lines else ""


def write_prometheus(path, registry=None):
    """Write the exposition text to `path` (node-exporter textfile
    collector pattern); returns the path."""
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return path
