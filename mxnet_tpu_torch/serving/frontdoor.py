"""Replica front door: N engines behind one ``submit()`` (counterpart of
mxnet_tpu/serving/frontdoor.py).

One :class:`InferenceEngine` serves one device's worth of traffic; a fleet
runs N replicas of the same model and routes each request to the replica
that will serve it soonest. :class:`FrontDoor` is that router,
deliberately thin:

  * **least-loaded dispatch** — each submit goes to the healthy replica
    with the smallest ``engine.load()`` (queued rows + in-flight rows, the
    same quantities the ``serve_queue_depth`` / ``serve_in_flight`` gauges
    publish, so the routing decision is exactly what the dashboards show);
  * **health-checking** — a replica is routable iff its health check
    passes. The default check is in-process: ``admission_state() ==
    "ok"`` (stopped and shedding replicas drop out, and recover
    automatically once their queue drains). For replicas behind an HTTP
    ops plane, :class:`OpsPlaneHealth` polls each one's ``/readyz`` (200 =
    ready) on a background thread, so out-of-process replicas are
    routable too;
  * **failover on shed** — if the chosen replica sheds with
    ``Overloaded`` the front door tries the remaining healthy replicas in
    load order before giving up; only when EVERY replica sheds does the
    caller see :class:`~mxnet_tpu_torch.serving.errors.Overloaded`.

The front door adds no queue of its own — admission control stays in the
engines, so the bounded-queue/shedding contract (errors.py) is unchanged,
and a front-door submit is one lock-free load scan plus the engine submit.
Register a replica set with ``serving.REGISTRY.register_replicas(name,
engines)``. Two replicas of one model may share one card: each warms up
(captures its CUDA graphs) while the other serves (gluon/_graph.py).
Streaming generation (``submit_stream``) comes with the decode engine,
which the port does not have yet.
"""
from __future__ import annotations

import threading
import urllib.request

from .errors import EngineStopped, Overloaded

__all__ = ["FrontDoor", "OpsPlaneHealth"]


def _default_healthy(engine):
    return engine.admission_state() == "ok"


class OpsPlaneHealth:
    """Health checker backed by an HTTP ops plane: polls each replica's
    ``/readyz`` (HTTP 200 = ready; the JAX package's
    observability/opsd.py serves it) on a daemon thread and caches the
    verdict.

    ``urls`` maps engine name -> base URL (e.g. ``http://host:9100``).
    Replicas without a URL fall back to the in-process
    ``admission_state()`` check. A replica whose endpoint errors or
    times out is unhealthy until a poll succeeds again — fail closed.
    """

    def __init__(self, urls, interval_s=1.0, timeout_s=0.5):
        self.urls = dict(urls)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._ready = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mxtpu-frontdoor-health", daemon=True)
        self._thread.start()

    def _poll_once(self):
        for name, base in self.urls.items():
            ok = False
            try:
                with urllib.request.urlopen(
                        base.rstrip("/") + "/readyz",
                        timeout=self.timeout_s) as resp:
                    ok = resp.status == 200
            except Exception:
                ok = False
            with self._lock:
                self._ready[name] = ok

    def _loop(self):
        while not self._stop.is_set():
            self._poll_once()
            self._stop.wait(self.interval_s)

    def __call__(self, engine):
        name = getattr(engine, "name", None)
        if name not in self.urls:
            return _default_healthy(engine)
        with self._lock:
            return self._ready.get(name, False)

    def close(self):
        self._stop.set()


class FrontDoor:
    """Least-loaded router over a replica set of engines serving the
    same model signature.

    ::

        fd = FrontDoor([eng0, eng1, eng2])
        req = fd.submit(x)          # routed to the least-loaded replica
        out = req.result()

    ``health_check`` is any callable ``engine -> bool``; default is the
    in-process ``admission_state() == "ok"``. Pass an
    :class:`OpsPlaneHealth` to route on an HTTP ops plane instead.
    """

    def __init__(self, engines, name="frontdoor", health_check=None):
        engines = list(engines)
        if not engines:
            raise ValueError("FrontDoor needs at least one engine")
        self.name = str(name)
        self.engines = engines
        self._healthy = health_check or _default_healthy
        self._routed = {e.name: 0 for e in engines}
        self._lock = threading.Lock()

    # -- routing -----------------------------------------------------------
    def _candidates(self):
        """Healthy replicas, least-loaded first (ties: declaration
        order, which keeps routing deterministic in tests)."""
        healthy = [e for e in self.engines if self._healthy(e)]
        return sorted(healthy, key=lambda e: e.load())

    def submit(self, *inputs, timeout_ms=None, priority=None):
        """Route one request to the best replica; returns that engine's
        :class:`~mxnet_tpu_torch.serving.engine.ServeRequest`.

        Raises :class:`Overloaded` only when every healthy replica
        sheds, :class:`EngineStopped` when no replica is healthy at
        all."""
        last = None
        for tries, eng in enumerate(self._candidates(), start=1):
            try:
                req = eng.submit(*inputs, timeout_ms=timeout_ms,
                                 priority=priority)
                with self._lock:
                    self._routed[eng.name] += 1
                if req.trace is not None:
                    # routing context on the sampled trace: which
                    # replica won and how many sheds it took to land
                    req.trace.annotate(frontdoor=self.name,
                                       replica=eng.name, tries=tries)
                return req
            except Overloaded as e:  # includes RateLimited
                last = e  # shed here — fail over to the next replica
            except EngineStopped as e:
                last = e  # stopped between health check and submit
        if isinstance(last, Overloaded):
            raise Overloaded(
                f"front door {self.name!r}: all "
                f"{len(self.engines)} replicas shed") from last
        raise EngineStopped(
            f"front door {self.name!r}: no healthy replica "
            f"(of {len(self.engines)})") from last

    def predict(self, *inputs, timeout_ms=None, priority=None):
        req = self.submit(*inputs, timeout_ms=timeout_ms,
                          priority=priority)
        return req.result()

    # -- streaming (decode replicas) ---------------------------------------
    def submit_stream(self, prompt, **kwargs):  # noqa: ARG002
        """Route one generation request to a decode replica: not ported
        yet (the JAX package's ``DecodeEngine`` has no counterpart in the
        port)."""
        raise NotImplementedError(
            "FrontDoor.submit_stream is not ported yet: it comes with the "
            "decode engine (mxnet_tpu/decode) in a later slice")

    def generate(self, prompt, **kwargs):
        """Submit + stream through the front door (see
        :meth:`submit_stream`)."""
        return self.submit_stream(prompt, **kwargs).stream()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        for e in self.engines:
            e.start()
        return self

    def stop(self, drain=True, drain_timeout_ms=None):
        for e in self.engines:
            e.stop(drain=drain, drain_timeout_ms=drain_timeout_ms)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- observability -----------------------------------------------------
    def healthy_names(self):
        return [e.name for e in self.engines if self._healthy(e)]

    def stats(self):
        """Routing table snapshot: per-replica health, load score, and
        requests routed, plus the replica the NEXT submit would pick."""
        cands = self._candidates()
        with self._lock:
            routed = dict(self._routed)
        return {
            "frontdoor": self.name,
            "replicas": {
                e.name: {
                    "healthy": self._healthy(e),
                    "load": e.load(),
                    "queue_depth": e.queue_depth(),
                    "inflight_rows": e.inflight_rows(),
                    "routed": routed.get(e.name, 0),
                    "state": e.admission_state(),
                }
                for e in self.engines},
            "next_pick": cands[0].name if cands else None,
        }
