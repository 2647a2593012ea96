"""The served forward as one CUDA graph per bucket rung
(``HybridBlock.call_cached_graph`` under ``serving.InferenceEngine``) on
the card. Marked ``cuda``; every test skips without a card. The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_serving_graph.py

A BERTForQA at full width with 2 layers, bf16, seq 384, rungs 1/2/4/8:
``warmup`` captures one graph per rung; a replay equals the eager forward
of the same batch bit for bit (the same kernels on the same inputs); a
result handed out never changes when its rung replays again; weights whose
storage is replaced are captured again (counted) and served; two engines
serve on one card while one of them captures; every replay counts its
attention launches (all on the tensor cores); mixed traffic after warmup
captures nothing.
"""
import threading

import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.ops import flash_attention as fa

SEQ = 384
LAYERS = 2
RUNGS = [1, 2, 4, 8]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA graphs and the kernels "
                    "have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _net(dev, seed=0):
    net = bert.BERTForQA(bert.bert_12_768_12(
        vocab_size=30522, max_length=512, num_layers=LAYERS,
        dtype="bfloat16"))
    net.initialize(device=dev, generator=torch.Generator().manual_seed(seed))
    net.hybridize()
    return net


def _ids(n, seed):
    return torch.randint(0, 30522, (n, SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def _eager(net, ids):
    """The forward without the graphs, on the same device tensors."""
    dev = net.device
    with mt.autograd.pause(), torch.inference_mode():
        return net(ids.to(dev), torch.zeros_like(ids).to(dev))


def _warm(net, name="bert"):
    eng = serving.InferenceEngine(net, name=name, max_batch_size=8,
                                  timeout_ms=0)
    ex = torch.zeros((1, SEQ), dtype=torch.int32)
    info = eng.warmup(ex, ex)
    assert info["graphs"] == {b: 1 for b in RUNGS}
    assert eng.recompiles_since_warmup() == 0
    return eng


@pytest.mark.cuda
def test_replay_equals_eager_bit_for_bit_at_every_rung(cuda_device):
    net = _net(cuda_device)
    _warm(net)
    assert net.capture_count() == len(RUNGS)
    pools = net.captured_graphs()
    assert sorted(g["shapes"][0][0] for g in pools) == RUNGS
    for b in RUNGS:
        ids = _ids(b, 10 + b)
        got = net.call_cached_graph(ids.to(cuda_device),
                                    torch.zeros_like(ids).to(cuda_device))
        want = _eager(net, ids)
        for g, w in zip(got, want):
            assert g.shape == (b, SEQ) and torch.equal(g, w), b
    assert net.capture_count() == len(RUNGS)


@pytest.mark.cuda
def test_held_result_survives_the_next_replay_of_its_rung(cuda_device):
    net = _net(cuda_device)
    eng = _warm(net)
    eng.start()
    held = eng.predict(_ids(8, 1), torch.zeros((8, SEQ), dtype=torch.int32))
    kept = [t.clone() for t in held]
    other = eng.predict(_ids(8, 2), torch.zeros((8, SEQ), dtype=torch.int32))
    torch.cuda.synchronize()
    eng.stop()
    assert not torch.equal(other[0], kept[0])
    for t, k in zip(held, kept):
        assert torch.equal(t, k)
    assert eng.stats()["recompiles_since_warmup"] == 0


@pytest.mark.cuda
def test_storage_swap_captures_again_and_serves_the_new_weights(
        cuda_device):
    net = _net(cuda_device)
    eng = _warm(net)
    ids = _ids(4, 3)
    dev_args = (ids.to(cuda_device), torch.zeros_like(ids).to(cuda_device))
    before = net.call_cached_graph(*dev_args)
    # values written in place: the graph reads them, nothing is captured
    for p in net.collect_params().values():
        p.set_data(p._tensor().detach() * 0.5)
    inplace = net.call_cached_graph(*dev_args)
    assert not torch.equal(inplace[0], before[0])
    assert all(torch.equal(a, b) for a, b in zip(inplace, _eager(net, ids)))
    assert eng.recompiles_since_warmup() == 0
    # new tensors: the rung is captured again, counted, and serves them
    net.initialize(force_reinit=True,
                   generator=torch.Generator().manual_seed(5))
    after = net.call_cached_graph(*dev_args)
    assert net.capture_count() == len(RUNGS) + 1
    assert eng.recompiles_since_warmup() == 1
    assert not torch.equal(after[0], inplace[0])
    assert all(torch.equal(a, b) for a, b in zip(after, _eager(net, ids)))
    assert len(net.captured_graphs()) == 1   # the old rungs were dropped


@pytest.mark.cuda
def test_two_engines_one_card_one_captures_while_the_other_serves(
        cuda_device):
    net_a, net_b = _net(cuda_device, 0), _net(cuda_device, 1)
    eng_a = _warm(net_a, "a")
    eng_a.start()
    results, stop = [], threading.Event()

    def client():            # closed loop: one request at a time
        k = 0
        while not stop.is_set() or k < 8:
            ids = _ids(1 + k % 8, 100 + k)
            req = eng_a.submit(ids, torch.zeros_like(ids))
            req.result(timeout=120)
            results.append((ids, req))
            k += 1

    th = threading.Thread(target=client)
    th.start()
    eng_b = _warm(net_b, "b")                 # captures while a serves
    stop.set()
    th.join(timeout=300)
    eng_a.stop()
    assert not th.is_alive()
    assert eng_a.stats()["recompiles_since_warmup"] == 0
    for ids, req in results:
        got = req.result(timeout=60)
        want = _eager(net_a, ids)
        for g, w in zip(got, want):
            scale = max(1.0, w.float().abs().max().item())
            assert (g.float() - w.float()).abs().max().item() <= 1e-2 * scale
    eng_b.start()
    ids = _ids(3, 7)
    got = eng_b.predict(ids, torch.zeros_like(ids))
    eng_b.stop()
    padded = torch.cat([ids, ids[-1:]])       # rung 4, the last row again
    want = _eager(net_b, padded)
    assert all(torch.equal(g, w[:3]) for g, w in zip(got, want))
    assert eng_b.stats()["recompiles_since_warmup"] == 0


@pytest.mark.cuda
def test_every_replay_counts_its_attention_launches(cuda_device):
    net = _net(cuda_device)
    _warm(net)
    variants = fa.VARIANT_LAUNCHES[fa.KERNEL]
    before = (fa.LAUNCHES.value, variants["mma"].value,
              variants["fp32"].value)
    ids = _ids(2, 4).to(cuda_device)
    for _ in range(5):
        net.call_cached_graph(ids, torch.zeros_like(ids))
    after = (fa.LAUNCHES.value, variants["mma"].value,
             variants["fp32"].value)
    assert [a - b for a, b in zip(after, before)] == \
        [5 * LAYERS, 5 * LAYERS, 0]


@pytest.mark.cuda
def test_mixed_traffic_after_warmup_captures_nothing(cuda_device):
    net = _net(cuda_device)
    for mode in ("pipelined", "sync"):
        eng = serving.InferenceEngine(net, name=mode, max_batch_size=8,
                                      timeout_ms=0, mode=mode)
        ex = torch.zeros((1, SEQ), dtype=torch.int32)
        eng.warmup(ex, ex)
        captures = net.capture_count()
        eng.start()
        reqs = [eng.submit(_ids(n, n), torch.zeros((n, SEQ),
                                                   dtype=torch.int32))
                for n in (1, 3, 2, 5, 1, 8, 4, 7, 2, 6)]
        outs = [r.result(timeout=120) for r in reqs]
        eng.stop()
        assert [o[0].shape[0] for o in outs] == [1, 3, 2, 5, 1, 8, 4, 7,
                                                 2, 6]
        assert net.capture_count() == captures
        st = eng.stats()
        assert st["recompiles_since_warmup"] == 0
        assert st["requests"] == {"ok": 10}


@pytest.mark.cuda
def test_a_caller_on_another_stream_waits_for_the_replay(cuda_device):
    net = _net(cuda_device)
    _warm(net)
    a, b = _ids(8, 20).to(cuda_device), _ids(8, 21).to(cuda_device)
    z = torch.zeros_like(a)
    want_a, want_b = _eager(net, a.cpu()), _eager(net, b.cpu())
    side = torch.cuda.Stream(cuda_device)
    for _ in range(3):
        got_a = net.call_cached_graph(a, z)       # the current stream
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            got_b = net.call_cached_graph(b, z)   # another stream
        torch.cuda.current_stream(cuda_device).wait_stream(side)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got_a, want_a))
        assert all(torch.equal(g, w) for g, w in zip(got_b, want_b))
