"""Request traces, SLO burn and diagnostics spans of the port's serving
tier (mxnet_tpu_torch/observability/reqtrace.py, diagnostics/spans.py)
against the JAX package's, both engines over their own ``SimulatedBlock``.

The same scripted requests go through both: a request that expires in the
queue of a stopped engine, two shed at a full queue, the rest served in
batches. The outcomes, the telemetry counts, each trace's phase names and
shed reason, and the SLO table under a declared objective must be equal;
every trace's phases must add up to its end-to-end latency within 1 us.
Only the order of events is scripted, never a duration: the objective is
far above any latency a served request can have here.
"""
import time

import numpy as onp
import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.diagnostics import spans as jspans
from mxnet_tpu.observability import reqtrace as jreqtrace
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.diagnostics import spans as tspans
from mxnet_tpu_torch.observability import reqtrace as treqtrace

PKGS = {"jax": (jserving, jreqtrace, jtelemetry, jspans),
        "torch": (tserving, treqtrace, ttelemetry, tspans)}
OBJECTIVE_MS = 60_000.0


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for var in ("MXTPU_TRACE_SAMPLE", "MXTPU_TRACE_RING",
                "MXTPU_SLO_INTERACTIVE_MS", "MXTPU_SLO_BATCH_MS",
                "MXTPU_SLO_WINDOW_S", "MXTPU_SLO_MIN_EVENTS",
                "MXTPU_SLO_TARGET", "MXTPU_SLO_BURN_MAX"):
        monkeypatch.delenv(var, raising=False)
    was = {k: (tel.enabled(), sp.enabled())
           for k, (_, _, tel, sp) in PKGS.items()}
    for _, rt, tel, sp in PKGS.values():
        tel.enable()
        tel.reset()
        rt.reset()
        sp.enable()
        sp.reset()
    yield
    for k, (_, rt, tel, sp) in PKGS.items():
        tel.reset()
        rt.reset()
        sp.reset()
        tel.enable() if was[k][0] else tel.disable()
        sp.enable() if was[k][1] else sp.disable()


def _script(pkg, mode="pipelined", n=6, max_queue=4, device_ms=2.0):
    """Run the scripted traffic through ``pkg``'s engine; returns the
    outcomes, the engine's stats and its request traces."""
    serving, rt, _, _ = PKGS[pkg]
    rt.set_slo_objective("interactive", OBJECTIVE_MS)
    eng = serving.InferenceEngine(
        serving.SimulatedBlock(device_ms=device_ms), name="sim",
        max_batch_size=4, max_queue=max_queue, max_wait_ms=1.0,
        timeout_ms=30_000.0, mode=mode)
    x = onp.arange(2 * n, dtype=onp.float32).reshape(n, 2)
    outcomes, reqs = [], []
    reqs.append((0, eng.submit(x[:1], timeout_ms=1)))
    time.sleep(0.02)             # it expires in the queue before start()
    for i in range(1, n):
        try:
            reqs.append((i, eng.submit(x[i:i + 1])))
        except serving.Overloaded as e:
            outcomes.append((i, type(e).__name__))
    eng.start()
    for i, r in reqs:
        try:
            out = r.result(timeout=30)
            assert onp.array_equal(onp.asarray(out), x[i:i + 1])
            outcomes.append((i, "ok"))
        except Exception as e:  # noqa: BLE001 — the outcome is the result
            outcomes.append((i, type(e).__name__))
    eng.stop()
    return sorted(outcomes), eng.stats(), rt.traces()


def _trace_shape(tr):
    return (tr["outcome"], tr["reason"], tr["rows"],
            [s["phase"] for s in tr["spans"]])


@pytest.mark.parametrize("mode", ["pipelined", "sync"])
def test_outcomes_phases_and_slo_burn_match_the_jax_engine(monkeypatch,
                                                           mode):
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "1")
    runs = {pkg: _script(pkg, mode) for pkg in PKGS}
    (jo, js, jt), (to, ts, tt) = runs["jax"], runs["torch"]
    assert to == jo
    assert [o for _, o in to].count("ok") == 3
    assert ts["requests"] == js["requests"] == {"ok": 3, "shed": 2,
                                                "timeout": 1}
    assert ts["slo"] == js["slo"]
    assert ts["slo"]["interactive"]["events"] == 6
    assert ts["slo"]["interactive"]["burn"] == pytest.approx(50.0)
    assert ts["trace_sample"] == js["trace_sample"] == 1.0
    assert sorted(map(_trace_shape, tt), key=str) == \
        sorted(map(_trace_shape, jt), key=str)
    ok = [tr for tr in tt if tr["outcome"] == "ok"]
    assert [s["phase"] for s in ok[0]["spans"]] == list(treqtrace.PHASES)
    for tr in tt:   # the phases telescope to the end-to-end latency
        total = sum(s["dur"] for s in tr["spans"]) * 1e3
        assert abs(total - tr["total_ms"]) <= 1e-3
        for a, b in zip(tr["spans"], tr["spans"][1:]):
            assert a["t0"] + a["dur"] == pytest.approx(b["t0"], abs=1e-9)


def test_device_phase_covers_the_simulated_device(monkeypatch):
    """The device phase closes when the completer's wait on the batch's
    ready handle returns, not when the dispatch does: it spans most of the
    simulated device's 50 ms (the dispatch stamp may trail the enqueue by
    a few thread switches)."""
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "1")
    _, _, traces = _script("torch", device_ms=50.0)
    ok = [tr for tr in traces if tr["outcome"] == "ok"]
    assert len(ok) == 3
    for tr in ok:
        dev = {s["phase"]: s["dur"] for s in tr["spans"]}["device"]
        assert dev >= 0.025


def test_batch_causality_matches_the_jax_engine(monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "1")
    shapes = {}
    for pkg, (_, rt, _, _) in PKGS.items():
        _script(pkg, n=9, max_queue=8)
        by_id = {tr["trace_id"]: tr for tr in rt.traces()}
        recs = rt.batches()
        for rec in recs:
            assert [s["phase"] for s in rec["spans"]] == \
                ["assemble", "dispatch", "device"]
            for tid in rec["trace_ids"]:
                assert by_id[tid]["batch"] == rec["batch_id"]
        shapes[pkg] = [(r["rows"], r["bucket"], len(r["trace_ids"]))
                       for r in recs]
    assert shapes["torch"] == shapes["jax"] == [(4, 4, 4), (3, 4, 3)]


@pytest.mark.parametrize("rate", ["0", "0.5"])
def test_head_sampling_counts_match_the_jax_engine(monkeypatch, rate):
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", rate)
    counts = {}
    for pkg, (_, rt, tel, _) in PKGS.items():
        _script(pkg)
        fam = tel.instruments.serve_trace_total.series()
        counts[pkg] = (len(rt.traces()),
                       sum(c.value for _, c in fam))
    assert counts["torch"] == counts["jax"] == \
        ((0, 0) if rate == "0" else (3, 3))


def test_slo_window_rolls_violations_off(monkeypatch):
    monkeypatch.setenv("MXTPU_SLO_WINDOW_S", "0.5")
    monkeypatch.setenv("MXTPU_SLO_MIN_EVENTS", "2")
    for pkg in PKGS:
        _, rt, _, _ = PKGS[pkg]
        rt.set_slo_objective("batch", 1.0)
        for outcome in ("shed", "timeout", "ok"):
            rt.slo_observe("m", "batch", outcome, 0.5)
        st = rt.slo_status()["m"]["batch"]
        assert (st["events"], st["bad"], st["burning"]) == (3, 3, True)
        assert rt.slo_burning() == {"m/batch": 100.0}
    time.sleep(0.7)
    for _, rt, _, _ in PKGS.values():
        assert rt.slo_status()["m"]["batch"]["burn"] is None
        assert rt.slo_burning() == {}


def test_engine_spans_pivot_like_the_jax_engine():
    """Each batch records one ``serve`` span (assembly and dispatch) and
    one ``serve_complete`` span (the wait for its outputs)."""
    tables, cats = {}, {}
    for pkg, (_, _, _, sp) in PKGS.items():
        _script(pkg)
        recs = sp.records()
        cats[pkg] = sorted((r["cat"], r["name"]) for r in recs)
        tables[pkg] = {step: sorted(row) for step, row in
                       sp.step_table(recs).items()}
    assert cats["torch"] == cats["jax"]
    assert ("serve", "sim") in cats["torch"]
    assert tables["torch"] == tables["jax"] == {0: ["other", "serve"]}
    events = tspans.emit_chrome_spans()
    assert len(events) == len(tspans.records())
    assert {e["ph"] for e in events} == {"X"}
