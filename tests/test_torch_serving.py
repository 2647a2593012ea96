"""The PyTorch port's InferenceEngine (mxnet_tpu_torch/serving) on the CPU
over a tiny BERTForQA whose weights come from the JAX package.

No test here depends on wall-clock timing: deadlines are off
(``timeout_ms=0``), shedding is shown on an engine that was never started,
and rate limiting with a burst-1 bucket whose refill is negligible.
Results of batched requests must equal a direct ``call_cached_graph`` of
the request's own rows within atol 1e-5 (the CPU matmul may block a
larger batch differently), and the JAX model's rows within atol 1e-4.
``stats()`` reads the port's telemetry registry, as the JAX engine reads
its own; every test starts from a zeroed registry and trace state.
"""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu_torch import cpu, observability, telemetry
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.serving import (EngineStopped, InferenceEngine,
                                     ModelRegistry, Overloaded, RateLimited,
                                     ServeClass, SimulatedBlock)

CFG = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
           hidden_size=128, num_heads=4)
S = 37


@pytest.fixture(scope="module")
def models():
    mx.seed(21)
    jnet = jbert.BERTForQA(jbert.get_bert_model("bert_12_768_12", **CFG))
    jnet.initialize()
    rs = onp.random.RandomState(9)
    tok = rs.randint(0, CFG["vocab_size"], (24, S)).astype("int32")
    seg = onp.zeros_like(tok)
    js, je = jnet(mx.np.array(tok), mx.np.array(seg))
    tnet = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **CFG))
    tnet.initialize(device=cpu())
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    tnet.hybridize()
    return tnet, tok, seg, js.asnumpy(), je.asnumpy()


@pytest.fixture(autouse=True)
def fresh_telemetry():
    was = telemetry.enabled()
    telemetry.enable()
    telemetry.reset()
    observability.reset()
    yield
    telemetry.reset()
    observability.reset()
    if not was:
        telemetry.disable()


def _engine(net, **kw):
    kw.setdefault("timeout_ms", 0)
    return InferenceEngine(net, name="qa", max_batch_size=4, **kw)


def test_call_cached_graph_requires_hybridize():
    net = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **CFG))
    net.initialize(device=cpu())
    with pytest.raises(RuntimeError, match="hybridize"):
        net.call_cached_graph(torch.zeros((1, 4), dtype=torch.int32))


def test_warmup_seals_every_bucket(models):
    net, tok, seg, _, _ = models
    eng = _engine(net)
    info = eng.warmup(tok[:1], seg[:1])
    assert info["buckets"] == [1, 2, 4]
    assert eng.recompiles_since_warmup() == 0
    net.call_cached_graph(torch.from_numpy(tok[:3]),
                          torch.from_numpy(seg[:3]))  # a new shape
    assert eng.recompiles_since_warmup() == 1


@pytest.mark.parametrize("mode", ["pipelined", "sync"])
def test_mixed_rows_from_two_threads_match_direct_and_jax(models, mode):
    net, tok, seg, js, je = models
    eng = _engine(net, mode=mode)
    eng.warmup(tok[:1], seg[:1])
    # rows 0..23 split into requests of 1..3 rows, two client threads
    spans, i = [], 0
    for n in [1, 3, 2, 1, 2, 3, 1, 2, 3, 1, 2, 3]:
        spans.append((i, i + n))
        i += n
    results = {}

    def client(my_spans):
        reqs = [(sp, eng.submit(tok[sp[0]:sp[1]], seg[sp[0]:sp[1]]))
                for sp in my_spans]
        for sp, r in reqs:
            results[sp] = r.result(timeout=60)

    eng.start()
    threads = [threading.Thread(target=client, args=(spans[k::2],))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    eng.stop()
    st = eng.stats()
    assert st["requests"] == {"ok": len(spans)}
    assert st["recompiles_since_warmup"] == 0
    assert st["dispatches"] == st["batches"] >= 24 // 4  # <= 4 rows each
    assert sorted(results) == sorted(spans)
    for (a, b), (start, end) in results.items():
        assert start.shape == (b - a, S)
        d_start, d_end = net.call_cached_graph(torch.from_numpy(tok[a:b]),
                                               torch.from_numpy(seg[a:b]))
        torch.testing.assert_close(start, d_start, atol=1e-5, rtol=0)
        torch.testing.assert_close(end, d_end, atol=1e-5, rtol=0)
        onp.testing.assert_allclose(start.numpy(), js[a:b], atol=1e-4,
                                    rtol=0)
        onp.testing.assert_allclose(end.numpy(), je[a:b], atol=1e-4, rtol=0)


def test_full_queue_sheds_overloaded(models):
    net, tok, seg, _, _ = models
    eng = _engine(net, max_queue=2)  # never started: the queue only fills
    queued = [eng.submit(tok[:1], seg[:1]) for _ in range(2)]
    assert eng.admission_state() == "overloaded"
    with pytest.raises(Overloaded):
        eng.submit(tok[:1], seg[:1])
    st = eng.stats()
    assert st["requests"] == {"shed": 1}
    assert st["classes"]["interactive"]["shed_queue"] == 1
    eng.stop()  # never started: the bounded drain drops the queue
    for r in queued:
        with pytest.raises(EngineStopped):
            r.result(timeout=5)
    assert eng.stats()["drain_dropped"] == 2
    with pytest.raises(EngineStopped):
        eng.submit(tok[:1], seg[:1])


def test_burst_one_bucket_rate_limits(models):
    net, tok, seg, _, _ = models
    eng = _engine(net, classes=[ServeClass("interactive", rate=1e-6,
                                           burst=1)])
    first = eng.submit(tok[:1], seg[:1])
    with pytest.raises(RateLimited):
        eng.submit(tok[:1], seg[:1])
    st = eng.stats()
    assert st["classes"]["interactive"]["shed_rate"] == 1
    eng.stop(drain=False)
    with pytest.raises(EngineStopped):
        first.result(timeout=5)


def test_registry_round_trip(models):
    net = models[0]
    reg = ModelRegistry()
    eng = reg.register("qa", net, max_batch_size=2, timeout_ms=0)
    assert "qa" in reg and reg.get("qa") is eng and eng.started
    with pytest.raises(ValueError, match="already registered"):
        reg.register("qa", net)
    assert reg.stats()["qa"]["max_queue"] == eng.max_queue
    reg.stop_all()
    assert reg.names() == [] and not eng.started


def test_held_result_survives_later_batches_of_its_rung(models):
    """A client's result is its own: serving other rows through the same
    rung afterwards leaves it as it was (on the card the rung is one CUDA
    graph whose static outputs every replay overwrites)."""
    net, tok, seg, _, _ = models
    eng = _engine(net)
    eng.warmup(tok[:1], seg[:1])
    eng.start()
    held = eng.predict(tok[:4], seg[:4])
    kept = [t.clone() for t in held]
    for k in (1, 2):
        other = eng.predict(tok[4 * k:4 * k + 4], seg[4 * k:4 * k + 4])
        assert not torch.equal(other[0], kept[0])
    eng.stop()
    assert eng.stats()["batches"] == 3
    for t, k in zip(held, kept):
        assert torch.equal(t, k)


def test_stats_keys_match_the_jax_engine():
    """The same snapshot surface as mxnet_tpu's engine: the same keys, per
    class too, over each package's simulated device."""
    jeng = jserving.InferenceEngine(jserving.SimulatedBlock(device_ms=1.0),
                                    name="keys", max_batch_size=4)
    teng = InferenceEngine(SimulatedBlock(device_ms=1.0), name="keys",
                           max_batch_size=4)
    js, ts = jeng.stats(), teng.stats()
    assert sorted(ts) == sorted(js)
    assert {c: sorted(v) for c, v in ts["classes"].items()} == \
        {c: sorted(v) for c, v in js["classes"].items()}
    assert ts["requests"] == js["requests"] == {}
    jeng.stop()
    teng.stop()
