"""The port's replica front door (mxnet_tpu_torch/serving/frontdoor.py) and
replica sets (registry.py) against the JAX package's, over each package's
``SimulatedBlock``: least-loaded routing, failover on shed then
``Overloaded``, ``register_replicas``, and ``OpsPlaneHealth`` polling a
stub ``/readyz`` server on localhost. Engines that are never started only
queue, so every load, and so every routing decision, is deterministic.
"""
import http.server
import threading
import time

import numpy as onp
import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttelemetry

PKGS = {"jax": jserving, "torch": tserving}
X = onp.zeros((1, 2), dtype=onp.float32)


@pytest.fixture(autouse=True)
def fresh():
    was = {k: tel.enabled() for k, tel in
           (("jax", jtelemetry), ("torch", ttelemetry))}
    for tel in (jtelemetry, ttelemetry):
        tel.enable()
        tel.reset()
    yield
    for k, tel in (("jax", jtelemetry), ("torch", ttelemetry)):
        tel.reset()
        tel.enable() if was[k] else tel.disable()


def _replicas(serving, n=2, **kw):
    kw.setdefault("max_queue", 8)
    return [serving.InferenceEngine(serving.SimulatedBlock(device_ms=1.0),
                                    name=f"m/{i}", max_batch_size=4,
                                    timeout_ms=0, **kw) for i in range(n)]


def _routing(serving):
    engines = _replicas(serving, 3)
    fd = serving.FrontDoor(engines, name="m")
    picks = []
    for rows in (2, 1, 1, 3, 1, 2, 4, 1):
        req = fd.submit(onp.zeros((rows, 2), dtype=onp.float32))
        picks.append(next(e.name for e in engines
                          if req in list(e._sched._classes[
                              "interactive"].queue)))
    st = fd.stats()
    fd.stop(drain=False)
    return picks, st


def test_least_loaded_routing_matches_the_jax_front_door():
    (tp, ts), (jp, js) = _routing(tserving), _routing(jserving)
    assert tp == jp
    assert tp[:3] == ["m/0", "m/1", "m/2"]
    assert ts == js
    assert sum(r["routed"] for r in ts["replicas"].values()) == 8


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_failover_on_shed_then_overloaded(pkg):
    serving = PKGS[pkg]
    engines = _replicas(serving, 2, max_queue=1)
    fd = serving.FrontDoor(engines)
    a = fd.submit(X)
    # m/0 is full now: healthy is m/1 only, which takes the next one
    assert engines[0].admission_state() == "overloaded"
    b = fd.submit(X)
    with pytest.raises(serving.EngineStopped, match="no healthy"):
        fd.submit(X)             # both at their bound: none healthy
    gate = serving.FrontDoor(engines, health_check=lambda e: True)
    with pytest.raises(serving.Overloaded, match="all 2 replicas shed"):
        gate.submit(X)           # both tried, both shed
    assert fd.stats()["replicas"]["m/0"]["routed"] == 1
    assert fd.stats()["replicas"]["m/1"]["routed"] == 1
    fd.start()
    for r in (a, b):
        assert onp.array_equal(onp.asarray(r.result(timeout=30)), X)
    fd.stop()
    assert fd.healthy_names() == []          # stopped replicas drop out
    with pytest.raises(serving.EngineStopped):
        fd.submit(X)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_register_replicas(pkg):
    serving = PKGS[pkg]
    reg = serving.ModelRegistry()
    engines = _replicas(serving, 2)
    fd = reg.register_replicas("m", engines, start=True)
    assert reg.names() == ["m/0", "m/1"] and reg.frontdoor("m") is fd
    assert all(e.started for e in engines)
    with pytest.raises(ValueError, match="already registered"):
        reg.register_replicas("m", engines)
    out = fd.predict(X)
    assert onp.array_equal(onp.asarray(out), X)
    assert sorted(reg.stats()) == ["m/0", "m/1"]
    reg.unregister_replicas("m")
    assert reg.names() == [] and not any(e.started for e in engines)
    with pytest.raises(KeyError):
        reg.frontdoor("m")


class _Ready(http.server.BaseHTTPRequestHandler):
    ready = {"/a/readyz": 200, "/b/readyz": 503}

    def do_GET(self):  # noqa: N802 — http.server's name
        code = self.ready.get(self.path, 404)
        self.send_response(code)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *args):
        pass


def test_ops_plane_health_polls_readyz_on_localhost():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Ready)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    engines = _replicas(tserving, 3)
    health = tserving.OpsPlaneHealth(
        {"m/0": base + "/a", "m/1": base + "/b"}, interval_s=0.02,
        timeout_s=2.0)
    try:
        deadline = time.monotonic() + 10
        while len(health._ready) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        fd = tserving.FrontDoor(engines, health_check=health)
        # m/1 answers 503; m/2 has no URL: the in-process check decides
        assert fd.healthy_names() == ["m/0", "m/2"]
        req = fd.submit(X)       # the least loaded healthy one: m/0
        assert req in list(engines[0]._sched._classes["interactive"].queue)
        assert engines[1].queue_depth() == 0
        _Ready.ready = {"/a/readyz": 503, "/b/readyz": 200}
        deadline = time.monotonic() + 10
        while fd.healthy_names() != ["m/1", "m/2"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert fd.healthy_names() == ["m/1", "m/2"]
    finally:
        health.close()
        srv.shutdown()
        srv.server_close()
        _Ready.ready = {"/a/readyz": 200, "/b/readyz": 503}
        for e in engines:
            e.stop(drain=False)


def test_submit_stream_is_not_ported_yet():
    fd = tserving.FrontDoor(_replicas(tserving, 1))
    with pytest.raises(NotImplementedError, match="decode"):
        fd.submit_stream([1, 2, 3])
    fd.stop(drain=False)
