"""``gluon.TrainStep`` on the card: one CUDA graph per batch signature.
Marked ``cuda``; every test skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_train_step.py

Two nets from one generator take the same steps, one through the graph
(warm-up, capture, replays) and one phased (``MXTPU_WHOLE_STEP=0``): the
losses and parameters agree within 1e-5 relative (the same kernels on the
same inputs; cuBLAS and cuDNN may choose other algorithms on the capture
stream), under a changing LR and Adam's moving t with one capture; the
launch counters count each replay's launches; the ladder's device-scalar
entry is bit for bit its by-value entry; the attention layers' dropout
generators move on every replay; a storage swap after the capture raises.
"""
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.kernels import dispatch
from mxnet_tpu_torch.kernels import opt as kopt
from mxnet_tpu_torch.optimizer import optimizer as topt


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA graph and the kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _mlp(dev, seed=0):
    net = tnn.HybridSequential(
        tnn.Dense(64, activation="relu", in_units=32),
        tnn.BatchNorm(in_channels=64), tnn.Dropout(0.2),
        tnn.Dense(8, in_units=64))
    net.initialize(device=dev, generator=torch.Generator().manual_seed(seed))
    return net


def _pair(dev, opt, kw):
    """Two identical nets and their TrainSteps: graph and phased."""
    steps = []
    for _ in range(2):
        net = _mlp(dev)
        tr = mt.gluon.Trainer(net.collect_params(), opt, dict(kw))
        steps.append((net, tr, mt.gluon.TrainStep(
            net, mt.gluon.loss.L2Loss(), tr)))
    return steps


def _batch(dev, k):
    gen = torch.Generator().manual_seed(100 + k)
    return (torch.randn(16, 32, generator=gen).to(dev),
            torch.randn(16, 8, generator=gen).to(dev))


def _close(a, b, rel=1e-5):
    a, b = a.float(), b.float()
    scale = max(b.abs().max().item(), 1e-6)
    assert (a - b).abs().max().item() <= rel * scale


def _steps_agree(dev, monkeypatch, opt, kw, n, schedule=False):
    (gnet, gtr, gstep), (pnet, ptr, pstep) = _pair(dev, opt, kw)
    for k in range(n):
        if schedule:
            for tr in (gtr, ptr):
                tr.set_learning_rate(kw["learning_rate"] / (k + 1))
        x, y = _batch(dev, k)
        gl = gstep(x, y)
        monkeypatch.setenv("MXTPU_WHOLE_STEP", "0")
        pl = pstep(x, y)
        monkeypatch.delenv("MXTPU_WHOLE_STEP")
        assert gstep.last_path == "whole_step", gstep.ineligible_reason()
        assert pstep.last_path == "phased"
        _close(gl, pl)
    torch.cuda.synchronize()
    gp, pp = gnet.collect_params(), pnet.collect_params()
    for name, p in gp.items():
        _close(p._tensor().detach(), pp[name]._tensor().detach())
    assert gtr.optimizer._index_update_count == \
        ptr.optimizer._index_update_count
    return gstep


@pytest.mark.cuda
def test_cuda_graph_step_matches_phased(cuda_device, monkeypatch):
    """Dense, BatchNorm (K1/K2 on the card), Dropout from the net's
    generator (registered with the graph): 5 graph steps against 5 phased
    ones."""
    gstep = _steps_agree(cuda_device, monkeypatch, "sgd",
                         {"learning_rate": 0.05, "momentum": 0.9}, 5)
    assert gstep.jit_trace_count() == 1


@pytest.mark.cuda
def test_cuda_graph_follows_lr_schedule_and_adam_t(cuda_device,
                                                   monkeypatch):
    """An LR that changes every step and Adam's moving t reach the
    replays through the scalar rows: one capture, the phased results."""
    gstep = _steps_agree(cuda_device, monkeypatch, "adam",
                         {"learning_rate": 0.01, "wd": 0.01}, 6,
                         schedule=True)
    assert gstep.jit_trace_count() == 1


@pytest.mark.cuda
def test_cuda_graph_counts_launches_per_replay(cuda_device, monkeypatch):
    """After the warm-up and the capture, n replays count what n phased
    steps count: every launch counter (the ladder's n x its one f32
    bucket, BatchNorm's K1/K2), the tensors updated and the dispatch
    decisions."""
    counts = {}
    for label in ("graph", "phased"):
        net = _mlp(cuda_device)
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        step = mt.gluon.TrainStep(net, mt.gluon.loss.L2Loss(), tr)
        x, y = _batch(cuda_device, 0)
        if label == "phased":
            monkeypatch.setenv("MXTPU_WHOLE_STEP", "0")
        step(x, y)
        step(x, y)
        kbuild.reset_counters()
        kopt.TENSORS.reset()
        dispatch.reset_counts()
        for _ in range(4):
            step(x, y)
        torch.cuda.synchronize()
        monkeypatch.delenv("MXTPU_WHOLE_STEP", raising=False)
        counts[label] = ({c.name: c.value for c in kbuild.COUNTERS.values()
                          if c.value}, kopt.TENSORS.value,
                         dict(dispatch.COUNTS))
        assert step.jit_trace_count() == (1 if label == "graph" else 0)
    n_train = len(net.trainable_param_names())
    launches, tensors, decisions = counts["graph"]
    assert launches["opt_ladder"] == 4            # one f32 bucket
    assert tensors == 4 * n_train
    assert decisions[("opt_sgd", "kernel")] == 4 * n_train
    assert counts["graph"] == counts["phased"]


@pytest.mark.cuda
def test_cuda_ladder_device_scalars_equal_by_value(cuda_device):
    """bucket_step_dev (scalars read from the card) against bucket_step
    (scalars in the table) on the same members, lr, wd and t differing by
    member: every leaf bit for bit, SGD momentum in f32 and AdamW in bf16
    with f32 masters, a bucket split over two launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for cls, hyper, mp, n_state in (
            (topt.SGD, dict(momentum=0.9, rescale_grad=0.125), False, 1),
            (topt.AdamW, dict(beta1=0.9, beta2=0.999, eps=1e-8,
                              rescale_grad=0.125), True, 2)):
        sizes = [7, 4096, 9000, 1, 300] * 80        # 400: two launches
        steps = [(1e-3 * (1 + k % 3), 1e-4 * (k % 2), 1 + k % 5)
                 for k in range(len(sizes))]

        def members():
            out = []
            for n in sizes:
                master = torch.randn(n, device=cuda_device, generator=gen)
                leaves = [torch.rand(n, device=cuda_device, generator=gen)
                          for _ in range(n_state)]
                g = torch.randn(n, device=cuda_device, generator=gen)
                inner = leaves[0] if n_state == 1 else tuple(leaves)
                if mp:
                    out.append((master.to(torch.bfloat16), (master, inner),
                                g.to(torch.bfloat16)))
                else:
                    out.append((master, inner, g))
            return out
        a = members()
        b = [(w.clone(), _clone(st), g) for w, st, g in a]
        kopt.bucket_step(cls, None, False, mp,
                         [(w, st, g, *s) for (w, st, g), s in zip(a, steps)],
                         1.0, hyper)
        rows = kopt.ladder_scalars(cls, hyper, hyper["rescale_grad"], steps)
        kopt.bucket_step_dev(cls, None, mp, b,
                             torch.from_numpy(rows).to(cuda_device), hyper)
        torch.cuda.synchronize()
        for (wa, sa, _), (wb, sb, _) in zip(a, b):
            assert torch.equal(wa, wb)
            for la, lb in zip(kopt._leaves(sa), kopt._leaves(sb)):
                assert torch.equal(la, lb)


def _clone(st):
    if st is None:
        return None
    if isinstance(st, torch.Tensor):
        return st.clone()
    return tuple(_clone(s) for s in st)


@pytest.mark.cuda
def test_cuda_graph_attention_seed_moves_each_replay(cuda_device,
                                                     monkeypatch):
    """A 2-layer BERT in bf16 with attention dropout: each replay moves
    every layer's dropout generator by one draw, as a phased step moves
    its twin's (a new mask each step), and a graph step and a phased step
    from the same state agree."""
    cfg = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
               hidden_size=128, num_heads=4, dropout=0.1)
    sides = []
    for _ in range(2):
        net = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **cfg))
        net.initialize(device=cuda_device,
                       generator=torch.Generator().manual_seed(7))
        mt.amp.convert_hybrid_block(net, "bfloat16")
        tr = mt.gluon.Trainer(net.collect_params(), "adamw",
                              {"learning_rate": 1e-4, "wd": 0.01,
                               "multi_precision": True})
        lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()

        def span(out, s, e, lf=lf):
            return lf(out[0].float(), s) + lf(out[1].float(), e)
        sides.append((net, mt.gluon.TrainStep(net, span, tr, n_data=2)))
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, 100, (4, 48), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    seg = torch.zeros_like(tok)
    s0 = torch.randint(0, 48, (4,), generator=gen).to(cuda_device)
    s1 = torch.randint(0, 48, (4,), generator=gen).to(cuda_device)
    (gnet, gstep), (pnet, pstep) = sides
    gens = {label: [layer.attention.dropout_generator
                    for layer in net.bert.encoder.layers]
            for label, net in (("graph", gnet), ("phased", pnet))}
    for k in range(4):
        before = {lb: [g.get_offset() for g in gs] for lb, gs in gens.items()}
        gl = gstep(tok, seg, s0, s1)
        monkeypatch.setenv("MXTPU_WHOLE_STEP", "0")
        pl = pstep(tok, seg, s0, s1)
        monkeypatch.delenv("MXTPU_WHOLE_STEP")
        torch.cuda.synchronize()
        moved = {lb: [g.get_offset() - b for g, b in zip(gs, before[lb])]
                 for lb, gs in gens.items()}
        assert moved["graph"] == moved["phased"] and all(moved["graph"])
        assert gstep.last_path == "whole_step", gstep.ineligible_reason()
        # the same kernels on the same inputs and the same masks
        _close(gl, pl, 1e-3)
    assert gstep.jit_trace_count() == 1


@pytest.mark.cuda
def test_cuda_graph_storage_swap_raises(cuda_device):
    net = _mlp(cuda_device)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    step = mt.gluon.TrainStep(net, mt.gluon.loss.L2Loss(), tr)
    x, y = _batch(cuda_device, 0)
    for _ in range(3):
        step(x, y)
    i = next(i for i, s in enumerate(tr._states) if s is not None)
    tr._states[i] = tr._states[i].clone()
    with pytest.raises(RuntimeError, match="rebuild"):
        step(x, y)
    step.rebuild()
    for _ in range(3):
        step(x, y)
    assert step.jit_trace_count() == 2
