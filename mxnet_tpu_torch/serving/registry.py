"""Multi-model registry: named InferenceEngines under one roof
(counterpart of mxnet_tpu/serving/registry.py).

A process that serves several models needs one place to register, look
up, and tear down engines — and one call that snapshots every engine's
stats for an ops endpoint. Engines stay fully independent (own queue, own
threads, own telemetry label series); the registry only owns the name ->
engine map.

Replica sets (:meth:`ModelRegistry.register_replicas`) register N engines
of the same model as ``name/0`` .. ``name/N-1`` — each replica is an
ordinary registry entry, so every replica is health-checked and reported
on its own — and return a
:class:`~mxnet_tpu_torch.serving.frontdoor.FrontDoor` routing across them,
retrievable later with :meth:`ModelRegistry.frontdoor`.
"""
from __future__ import annotations

import threading

from ..observability import reqtrace
from .engine import InferenceEngine
from .frontdoor import FrontDoor

__all__ = ["ModelRegistry", "REGISTRY"]


class ModelRegistry:
    """Thread-safe name -> :class:`InferenceEngine` map."""

    def __init__(self):
        self._lock = threading.Lock()
        self._engines = {}
        self._frontdoors = {}

    @staticmethod
    def _is_engine(obj):
        """A ready engine, duck-typed on the serving surface the registry
        consumes (submit / lifecycle / health / stats)."""
        if isinstance(obj, InferenceEngine):
            return True
        return all(hasattr(obj, a) for a in
                   ("submit", "start", "stop", "admission_state",
                    "stats", "load"))

    def register(self, name, block_or_engine, start=True, **engine_kwargs):
        """Register a model and return its engine.

        ``block_or_engine`` is either a ready engine — an
        :class:`InferenceEngine`, or anything exposing the same serving
        surface — adopted as-is
        (``engine_kwargs`` must be empty), or a hybridized block wrapped
        in a new :class:`InferenceEngine` built with ``engine_kwargs``.
        Duplicate names raise ValueError — replacing a live model is an
        explicit unregister + register, never a silent swap.
        """
        name = str(name)
        if self._is_engine(block_or_engine):
            if engine_kwargs:
                raise ValueError(
                    "engine_kwargs only apply when registering a block, "
                    f"got a ready engine plus {sorted(engine_kwargs)}")
            engine = block_or_engine
        else:
            engine = InferenceEngine(block_or_engine, name=name,
                                     **engine_kwargs)
        with self._lock:
            if name in self._engines:
                raise ValueError(f"model {name!r} already registered")
            self._engines[name] = engine
        if start and not engine.started:
            engine.start()
        return engine

    def register_replicas(self, name, engines, start=True,
                          health_check=None):
        """Register a replica set and return its :class:`FrontDoor`.

        ``engines`` is a list of ready :class:`InferenceEngine` replicas
        of the same model signature. Each is registered individually
        under ``name/i`` — so ``stats()`` sees every replica — and the
        front door routing
        across them is stored under ``name`` (:meth:`frontdoor` fetches
        it). Give replicas distinct engine names at construction time
        (e.g. ``m/0``, ``m/1``) so their telemetry label series don't
        collide.
        """
        name = str(name)
        engines = list(engines)
        if not engines:
            raise ValueError("register_replicas needs at least one engine")
        with self._lock:
            if name in self._frontdoors:
                raise ValueError(
                    f"replica set {name!r} already registered")
        for i, eng in enumerate(engines):
            self.register(f"{name}/{i}", eng, start=start)
        fd = FrontDoor(engines, name=name, health_check=health_check)
        with self._lock:
            self._frontdoors[name] = fd
        return fd

    def frontdoor(self, name):
        """The :class:`FrontDoor` of a registered replica set."""
        with self._lock:
            try:
                return self._frontdoors[name]
            except KeyError:
                raise KeyError(
                    f"no replica set {name!r}; registered: "
                    f"{sorted(self._frontdoors)}") from None

    def unregister_replicas(self, name, stop=True):
        """Remove a replica set: drops the front door and unregisters
        (by default stopping) every ``name/i`` replica."""
        with self._lock:
            fd = self._frontdoors.pop(name, None)
        if fd is None:
            raise KeyError(f"no replica set {name!r}")
        for eng in fd.engines:
            self.unregister(eng.name, stop=stop)
        return fd

    def get(self, name):
        with self._lock:
            try:
                return self._engines[name]
            except KeyError:
                raise KeyError(
                    f"no model {name!r}; registered: "
                    f"{sorted(self._engines)}") from None

    def __contains__(self, name):
        with self._lock:
            return name in self._engines

    def names(self):
        with self._lock:
            return sorted(self._engines)

    def unregister(self, name, stop=True):
        """Remove a model; by default also stop (drain) its engine."""
        with self._lock:
            engine = self._engines.pop(name, None)
        if engine is None:
            raise KeyError(f"no model {name!r}")
        if stop:
            engine.stop()
        return engine

    def stats(self):
        """{name: engine.stats()} for every registered model."""
        with self._lock:
            engines = dict(self._engines)
        return {n: e.stats() for n, e in sorted(engines.items())}

    def slo_status(self):
        """{name: per-class SLO table} for every registered model that
        has a declared objective and observed traffic — the registry
        slice of ``reqtrace.slo_status()``."""
        with self._lock:
            names = sorted(self._engines)
        table = reqtrace.slo_status()
        return {n: table[n] for n in names if n in table}

    def stop_all(self):
        """Unregister and drain every engine (process shutdown hook)."""
        with self._lock:
            engines, self._engines = dict(self._engines), {}
            self._frontdoors = {}
        for e in engines.values():
            e.stop()


# The process-wide default registry.
REGISTRY = ModelRegistry()
