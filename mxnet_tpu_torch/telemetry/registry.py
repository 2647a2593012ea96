"""Process-wide metrics registry: counters, gauges, histograms with labels
(a copy of mxnet_tpu/telemetry/registry.py).

Design (motivated by TensorFlow's production counters — PAPERS.md
"TensorFlow: A system for large-scale machine learning"):

  * one default :class:`Registry` per process, metrics get-or-created by
    name (`counter()`/`gauge()`/`histogram()` module helpers);
  * labels follow the Prometheus model — a metric owns a fixed
    `labelnames` tuple and `labels(...)` resolves a child time series per
    label-value combination;
  * thread-safe: one lock per child series (value updates) plus one per
    metric (child creation) and one per registry (metric creation);
  * near-zero overhead when disabled: every mutator early-outs on one
    attribute load + bool check, no lock taken, no time read.

This module is standalone (stdlib and the port's env registry only) so
every layer of the port can import it without cycles.
"""
from __future__ import annotations

import os
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram",
    "enable", "disable", "enabled", "reset",
    "DEFAULT_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus client defaults (seconds-scale latencies).
DEFAULT_BUCKETS = (.005, .01, .025, .05, .075, .1, .25, .5, .75,
                   1.0, 2.5, 5.0, 7.5, 10.0)


class _Child:
    """One time series (a metric under one label-value combination).

    Holds its registry so a cached `.labels(...)` handle still honors
    enable()/disable() — the disabled path is one attr load + bool check.
    """

    __slots__ = ("_lock", "_value", "_registry")

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._registry = registry

    def _off(self):
        r = self._registry
        return r is not None and not r.enabled

    @property
    def value(self):
        return self._value


class _CounterChild(_Child):
    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        if self._off():
            return
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value):
        if self._off():
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        if self._off():
            return
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        if self._off():
            return
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count",
                 "_registry")

    def __init__(self, buckets, registry=None):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * len(buckets)  # per-bucket (non-cumulative)
        self._sum = 0.0
        self._count = 0
        self._registry = registry

    def observe(self, value):
        r = self._registry
        if r is not None and not r.enabled:
            return
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self._buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break
            # above every finite bound: lands only in the implicit +Inf
            # bucket, which cumulative() derives from _count

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def cumulative(self):
        """[(upper_bound, cumulative_count)] ending with ('+Inf', count)."""
        with self._lock:
            acc, out = 0, []
            for bound, c in zip(self._buckets, self._counts):
                acc += c
                out.append((bound, acc))
            out.append((float("inf"), self._count))
            return out


class _Metric:
    """Base metric: name + help + labelnames + child series map."""

    typ = "untyped"
    _child_cls = _Child

    def __init__(self, name, documentation="", labelnames=(), registry=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._registry = registry
        self._lock = threading.Lock()
        self._children = {}  # labelvalues tuple -> child
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        return self._child_cls(self._registry)

    def labels(self, *labelvalues, **labelkwargs):
        """Child series for one label-value combination (get-or-create).

        Accepts positional values in `labelnames` order or keyword form,
        like prometheus_client."""
        if labelvalues and labelkwargs:
            raise ValueError("labels() takes positionals OR keywords")
        if labelkwargs:
            if set(labelkwargs) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels {self.labelnames}, "
                    f"got {sorted(labelkwargs)}")
            labelvalues = tuple(str(labelkwargs[n]) for n in self.labelnames)
        else:
            if len(labelvalues) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected {len(self.labelnames)} label "
                    f"values {self.labelnames}, got {len(labelvalues)}")
            labelvalues = tuple(str(v) for v in labelvalues)
        child = self._children.get(labelvalues)
        if child is None:
            with self._lock:
                child = self._children.get(labelvalues)
                if child is None:
                    child = self._new_child()
                    self._children[labelvalues] = child
        return child

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._children[()]

    def series(self):
        """Snapshot of (labelvalues, child) pairs, insertion-ordered."""
        with self._lock:
            return list(self._children.items())

    def clear(self):
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = self._new_child()


class Counter(_Metric):
    """Monotonically increasing count (e.g. `jit_compile_total`)."""

    typ = "counter"
    _child_cls = _CounterChild

    def inc(self, amount=1.0):
        self._unlabeled().inc(amount)

    @property
    def value(self):
        return self._unlabeled().value


class Gauge(_Metric):
    """Instantaneous value that can go up or down (e.g. `mfu_ratio`)."""

    typ = "gauge"
    _child_cls = _GaugeChild

    def set(self, value):
        self._unlabeled().set(value)

    def inc(self, amount=1.0):
        self._unlabeled().inc(amount)

    def dec(self, amount=1.0):
        self._unlabeled().dec(amount)

    @property
    def value(self):
        return self._unlabeled().value


class Histogram(_Metric):
    """Distribution with fixed buckets (cumulative on export) + sum/count."""

    typ = "histogram"

    def __init__(self, name, documentation="", labelnames=(), registry=None,
                 buckets=DEFAULT_BUCKETS):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket")
        if any(b != b or b == float("inf") for b in buckets):
            raise ValueError("buckets must be finite (+Inf is implicit)")
        self.buckets = buckets
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _HistogramChild(self.buckets, self._registry)

    def observe(self, value):
        self._unlabeled().observe(value)

    @property
    def count(self):
        return self._unlabeled().count

    @property
    def sum(self):
        return self._unlabeled().sum


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Named collection of metrics; `enabled` gates every mutation."""

    def __init__(self, enabled=True):
        self._lock = threading.Lock()
        self._metrics = {}  # name -> metric, insertion-ordered
        self.enabled = enabled

    def _get_or_create(self, cls, name, documentation, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.typ}{m.labelnames}, requested "
                        f"{cls.typ}{tuple(labelnames)}")
                return m
            m = cls(name, documentation, labelnames, registry=self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, documentation="", labelnames=()):
        return self._get_or_create(Counter, name, documentation, labelnames)

    def gauge(self, name, documentation="", labelnames=()):
        return self._get_or_create(Gauge, name, documentation, labelnames)

    def histogram(self, name, documentation="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, documentation,
                                   labelnames, buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def collect(self):
        """Snapshot of registered metrics, registration-ordered."""
        with self._lock:
            return list(self._metrics.values())

    def reset(self):
        """Zero every series; registrations (and label sets declared
        without labels) survive so dashboards keep their shape."""
        for m in self.collect():
            m.clear()


def _enabled_from_env():
    from .. import env as _env

    return bool(_env.get("MXTPU_TELEMETRY"))


# The process-wide default registry. MXTPU_TELEMETRY=0 ships the whole
# subsystem dark (every record_* in instruments.py early-outs).
REGISTRY = Registry(enabled=_enabled_from_env())


def _reinit_locks_after_fork():
    # serving threads mutate counters continuously; a fork from a
    # threaded parent landing inside a
    # registry/metric/series critical section would leave that lock held
    # forever in the child. Values may be mid-update (GIL keeps them
    # well-formed); the child only needs working locks.
    REGISTRY._lock = threading.Lock()
    for m in list(REGISTRY._metrics.values()):
        m._lock = threading.Lock()
        for child in list(m._children.values()):
            child._lock = threading.Lock()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_locks_after_fork)


def counter(name, documentation="", labelnames=()):
    return REGISTRY.counter(name, documentation, labelnames)


def gauge(name, documentation="", labelnames=()):
    return REGISTRY.gauge(name, documentation, labelnames)


def histogram(name, documentation="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, documentation, labelnames, buckets)


def enable():
    REGISTRY.enabled = True


def disable():
    REGISTRY.enabled = False


def enabled():
    return REGISTRY.enabled


def reset():
    REGISTRY.reset()
