"""The port's telemetry (mxnet_tpu_torch/telemetry) against the JAX
package's (mxnet_tpu/telemetry): the same instrument calls give the same
Prometheus series, names, labels, counts and help, the same JSON snapshot,
and the exposition text round-trips through both parsers. Every test
starts from zeroed registries and restores their on/off state.
"""
import json

import pytest

from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.telemetry import promparse as tpromparse

PKGS = {"jax": jtelemetry, "torch": ttelemetry}


@pytest.fixture(autouse=True)
def fresh():
    was = {k: tel.enabled() for k, tel in PKGS.items()}
    for tel in PKGS.values():
        tel.enable()
        tel.reset()
    yield
    for k, tel in PKGS.items():
        tel.reset()
        tel.enable() if was[k] else tel.disable()


def _script(tel):
    """The same serving instrument calls, in one order."""
    ins = tel.instruments
    for outcome, s in (("ok", 0.0007), ("ok", 0.004), ("shed", None),
                       ("timeout", 0.3), ("error", 12.0), ("ok", 0.02)):
        ins.record_serve_request("bert", outcome, s)
    ins.record_serve_request("resnet", "ok", 0.001)
    for rows, bucket in ((3, 4), (8, 8), (1, 1), (5, 8)):
        ins.record_serve_batch("bert", rows, bucket)
    ins.record_serve_trace("bert", "ok")
    ins.set_slo_burn("bert", "interactive", 2.5)
    ins.record_slo_violation("bert", "interactive", "latency")
    ins.serve_class_queue_depth.labels("bert", "batch").set(7)
    ins.serve_class_shed_total.labels("bert", "batch", "rate").inc()
    ins.serve_dispatch_total.labels("bert").inc(4)
    ins.serve_in_flight.labels("bert").set(12)
    ins.serve_drain_dropped_total.labels("bert").inc(2)


def _serve_families(text, parse):
    return {name: fam for name, fam in parse(text).items()
            if name.startswith("serve_")}


def test_same_calls_give_the_same_prometheus_series():
    texts = {}
    for k, tel in PKGS.items():
        _script(tel)
        texts[k] = tel.prometheus_text()
    port = _serve_families(texts["torch"], tpromparse.parse_text)
    ref = _serve_families(texts["jax"], jtelemetry.promparse.parse_text)
    assert port == ref
    assert sorted(port) == sorted(ttelemetry.instruments.__all__[:17])
    assert tpromparse.sample_value(
        port, "serve_request_total",
        {"model": "bert", "outcome": "ok"}) == 3.0
    assert tpromparse.sample_value(
        port, "serve_padded_rows_total", {"model": "bert"}) == 4.0
    assert tpromparse.sample_value(
        port, "serve_request_latency_seconds_bucket",
        {"model": "bert", "le": "0.005"}) == 2.0
    assert tpromparse.sample_value(
        port, "serve_request_latency_seconds_count",
        {"model": "bert"}) == 5.0


def test_same_calls_give_the_same_json_snapshot():
    dumps = {}
    for k, tel in PKGS.items():
        _script(tel)
        dumps[k] = {n: v for n, v in tel.dump().items()
                    if n.startswith("serve_")}
    assert json.dumps(dumps["torch"], sort_keys=True) == \
        json.dumps(dumps["jax"], sort_keys=True)


def test_promparse_round_trips_and_rejects_malformed_lines():
    _script(ttelemetry)
    text = ttelemetry.prometheus_text()
    port = tpromparse.parse_text(text)
    assert port == jtelemetry.promparse.parse_text(text)
    snap = ttelemetry.dump()
    for name, fam in snap.items():
        for sample in fam["samples"]:
            if fam["type"] == "histogram":
                assert tpromparse.sample_value(
                    port, f"{name}_count", sample["labels"]) == \
                    sample["count"]
            else:
                assert tpromparse.sample_value(
                    port, name, sample["labels"]) == sample["value"]
    for bad in ("serve_x{model=bert} 1",          # unquoted label value
                "# TYPE serve_y nonsense",
                "undeclared_total 1"):
        with pytest.raises(tpromparse.ExpositionError):
            tpromparse.parse_text(bad)


def test_registry_semantics_match_the_jax_package():
    for tel in PKGS.values():
        reg = tel.Registry()
        c = reg.counter("c_total", "a counter", ["a"])
        with pytest.raises(ValueError):
            c.labels("x").inc(-1)
        with pytest.raises(ValueError):
            reg.gauge("c_total", "now a gauge", ["a"])
        with pytest.raises(ValueError):
            reg.counter("bad name")
        c.labels(a="x").inc(2)
        reg.enabled = False
        c.labels("x").inc(5)                   # a disabled registry
        reg.enabled = True
        h = reg.histogram("h_seconds", "", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        assert c.labels("x").value == 2.0
        assert h._unlabeled().cumulative() == [(0.1, 1), (1.0, 2),
                                                (float("inf"), 3)]
        reg.reset()
        assert [m.name for m in reg.collect()] == ["c_total", "h_seconds"]
        assert h.count == 0 and c.series() == []
    assert ttelemetry.prometheus_text(ttelemetry.Registry()) == \
        jtelemetry.prometheus_text(jtelemetry.Registry()) == ""


def test_disabled_telemetry_records_nothing():
    ttelemetry.disable()
    _script(ttelemetry)
    assert all(c.value == 0 for _, c in
               ttelemetry.instruments.serve_request_total.series())
    ttelemetry.enable()


def test_chrome_counters_one_event_per_series():
    _script(ttelemetry)
    sink = []
    events = ttelemetry.emit_chrome_counters(sink=sink)
    assert events == sink
    n = 0
    for m in ttelemetry.REGISTRY.collect():
        n += len(m.series()) * (2 if m.typ == "histogram" else 1)
    assert len(events) == n
    names = {e["name"] for e in events}
    assert 'serve_batch_size_count{model="bert"}' in names
    assert {e["ph"] for e in events} == {"C"}


def test_engine_stats_read_the_registry():
    eng = tserving.InferenceEngine(tserving.SimulatedBlock(device_ms=1.0),
                                   name="reg", max_batch_size=4,
                                   max_wait_ms=1.0, timeout_ms=0)
    eng.start()
    for k in range(5):
        eng.predict([[float(k)]])
    eng.stop()
    st = eng.stats()
    ins = ttelemetry.instruments
    assert st["requests"] == {"ok": 5}
    assert st["batches"] == ins.serve_batch_total.labels("reg").value
    assert st["dispatches"] == ins.serve_dispatch_total.labels("reg").value
    assert st["batches"] >= 2
    assert st["p50_ms"] is not None and st["p99_ms"] >= st["p50_ms"]
