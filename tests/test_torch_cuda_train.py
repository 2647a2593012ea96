"""The training slice's CUDA kernels on the card: the flash-attention
backward kernels against the plain backward, the optimizer ladder kernel
against ``Optimizer._fused_param_step``, and a recorded BERT forward whose
gradient reaches q, k and v. Marked ``cuda``; every test skips without a
card. The file imports no JAX, so it also runs where JAX is absent (beside
tests/test_torch_cuda.py, which holds the forward kernel's cases):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py tests/test_torch_cuda_train.py
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.kernels import dispatch, opt as kopt
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.optimizer import optimizer as topt

# (B, H, S, D, causal, dropout_p, dtype)
BWD_CASES = [
    (2, 3, 37, 32, False, 0.0, torch.float32),
    (1, 2, 200, 64, True, 0.0, torch.float32),
    (2, 2, 128, 32, False, 0.1, torch.float32),
    (1, 2, 77, 40, False, 0.0, torch.float32),     # ragged head dim
    (1, 2, 130, 128, True, 0.1, torch.float32),
    (2, 4, 96, 64, False, 0.1, torch.bfloat16),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d,causal,p,dtype", BWD_CASES)
def test_cuda_backward_kernels_match_plain_backward(cuda_device, b, h, s, d,
                                                    causal, p, dtype):
    rs = onp.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rs.randn(b, h, s, d).astype("f"))
                  .to(cuda_device).to(dtype) for _ in range(4))
    seed = 7 if p else None
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=p,
                                      dropout_seed=seed)
    before = (fa.LAUNCHES_BWD_DQ.value, fa.LAUNCHES_BWD_DKV.value)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                 dropout_p=p, dropout_seed=seed)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                            causal=causal, dropout_p=p,
                                            dropout_seed=seed)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_BWD_DQ.value, fa.LAUNCHES_BWD_DKV.value) == (
        before[0] + 1, before[1] + 1)
    # f32: the same operations summed in another order. bf16: dS and P_d
    # round to bf16 at the same points on both sides, but where the f32
    # value differs by an ulp the rounding can differ by one bf16 ulp
    # (2^-8 relative), and the outputs round once more
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
           else dict(atol=3e-2, rtol=3e-2))
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        torch.testing.assert_close(a.float(), w.float(), **tol)


def _ladder_operands(dev, size, mp, n_state, seed=3):
    r = onp.random.RandomState(seed)
    master = torch.from_numpy(r.standard_normal(size).astype("f")).to(dev)
    dt = torch.bfloat16 if mp else torch.float32
    w = master.to(dt)
    g = torch.from_numpy(r.standard_normal(size).astype("f")).to(dev).to(dt)
    inner = [torch.from_numpy((onp.abs(r.standard_normal(size)) * 0.01)
                              .astype("f")).to(dev) for _ in range(n_state)]
    inner = None if not inner else (inner[0] if n_state == 1
                                    else tuple(inner))
    return w, ((master.clone(), inner) if mp else inner), g


RULES = [
    ("SGD", dict(momentum=0.9)), ("NAG", dict(momentum=0.9)),
    ("Signum", dict(momentum=0.9, wd_lh=0.01)),
    ("Adam", dict(beta1=0.9, beta2=0.999, eps=1e-8)),
    ("AdamW", dict(beta1=0.9, beta2=0.999, eps=1e-8)),
]


@pytest.mark.cuda
def test_cuda_ladder_kernel_matches_plain_ladder(cuda_device):
    """Every rule, mp and non-mp, with and without state, clip and
    global-norm scale, at sizes with and without a tail. The kernel does
    the plain ladder's f32 operations in the same order without
    contraction, so f32 leaves agree within 2 ulp (rtol 3e-7 of the terms;
    atol 1e-6 near a cancellation) and the bf16 weight is the master
    rounded, exactly. Then the same kernel through ``Trainer.step``."""
    for rule, hyper in RULES:
        _check_rule(cuda_device, rule, hyper)
    _check_trainer_step(cuda_device)


def _check_rule(cuda_device, rule, hyper):
    cls = getattr(topt, rule)
    adam = rule in ("Adam", "AdamW")
    hyper = dict(hyper, rescale_grad=1.0 / 3)
    for size in (768, 4099, 1 << 16):
        for mp in (True, False):
            for stateless in ((False,) if adam else (False, True)):
                for clip, gn in ((None, False), (0.5, True)):
                    n_state = 2 if adam else (0 if stateless else 1)
                    kw, kst, g = _ladder_operands(cuda_device, size, mp,
                                                  n_state)
                    pw, pst, _ = _ladder_operands(cuda_device, size, mp,
                                                  n_state)
                    for t in (1, 2):
                        args = (0.125 / t, 1e-4, t, 0.25, hyper)
                        before = kopt.LAUNCHES.value
                        kopt.param_step(cls, clip, gn, mp, kw, kst, g, *args)
                        assert kopt.LAUNCHES.value == before + 1
                        topt.Optimizer._fused_param_step(
                            cls, clip, gn, mp, pw, pst, g, *args)
                    torch.cuda.synchronize()
                    what = f"{rule} n={size} mp={mp} states={n_state}"
                    leaves = zip(kopt._leaves((kw, kst)),
                                 kopt._leaves((pw, pst)))
                    for a, w in leaves:
                        assert a.dtype == w.dtype, what
                        if a.dtype == torch.bfloat16:
                            assert torch.equal(
                                a, kst[0].to(torch.bfloat16)), what
                        torch.testing.assert_close(
                            a.float(), w.float(), rtol=3e-7, atol=1e-6,
                            msg=lambda m: f"{what}: {m}")
    assert dispatch.COUNTS[("opt_" + rule.lower(), "kernel")] > 0


def _check_trainer_step(cuda_device):
    """With nothing set in the environment, ``Trainer.step`` on CUDA
    parameters launches the ladder kernel and the global-norm kernels once
    per bucket (a bf16 parameter with its master; a 3-element bias and an
    f32 parameter), updates every parameter through the kernel, and gives
    the plain ladder's result on the CPU within the kernel's tolerance."""
    def run(dev):
        rs = onp.random.RandomState(11)
        params = {}
        for i, (shape, dt) in enumerate((((33, 5), "bfloat16"),
                                         ((3,), "float32"),
                                         ((4, 4, 3), "float32"))):
            p = mt.gluon.Parameter(f"p{i}", shape=shape, dtype=dt)
            p.initialize(device=dev)
            val = torch.from_numpy(rs.standard_normal(shape).astype("f"))
            p.set_data(val.to(p.dtype).to(dev))
            params[f"p{i}"] = p
        tr = mt.gluon.Trainer(params, "adamw", dict(
            learning_rate=0.05, wd=0.01, multi_precision=True,
            clip_global_norm=1.0))
        for _ in range(2):
            for p in params.values():
                g = torch.from_numpy(rs.standard_normal(p.shape).astype("f"))
                p._grad = g.to(p.dtype).to(dev)
                p._grad_version += 1
            tr.step(4)
        return [p._tensor().detach().float().cpu() for p in params.values()]

    dispatch.reset_counts()
    before = (kopt.LAUNCHES.value, kopt.SQNORM_LAUNCHES.value,
              kopt.TENSORS.value)
    got = run(cuda_device)
    torch.cuda.synchronize()
    after = (kopt.LAUNCHES.value, kopt.SQNORM_LAUNCHES.value,
             kopt.TENSORS.value)
    assert [a - b for a, b in zip(after, before)] == [4, 4, 6]
    assert dispatch.COUNTS == {("opt_adamw", "kernel"): 6}
    for i, (a, w) in enumerate(zip(got, run(mt.cpu()))):
        # the global norm is summed on another device, so its scale differs
        # in the last bits; the bf16 weight (the first) may then round
        # across a boundary: one bf16 ulp of a value below 4
        tol = (dict(rtol=0, atol=2.0 ** -6) if i == 0
               else dict(rtol=1e-5, atol=1e-6))
        torch.testing.assert_close(a, w, **tol)


@pytest.mark.cuda
def test_recorded_cuda_forward_sends_gradient_through_attention(cuda_device):
    """A recorded BERT forward on the card gives the same gradient on layer
    0's qkv.weight as the CPU run (f32; the matmuls sum in another order:
    atol 1e-4 of gradients of size ~1e-2), and it is not zero: the
    attention kernel's output carries a grad_fn whose backward runs the
    backward kernels."""
    cfg = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
               hidden_size=128, num_heads=4, dropout=0.0)
    rs = onp.random.RandomState(5)
    tok = torch.from_numpy(rs.randint(0, 100, (4, 37)).astype("int32"))
    y0 = torch.from_numpy(rs.randint(0, 37, (4,)).astype("int64"))
    grads, only_residual = {}, {}
    for dev in (mt.cpu(), cuda_device):
        net = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **cfg))
        net.initialize(device=dev,
                       generator=torch.Generator().manual_seed(0))
        lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        before = (fa.LAUNCHES.value, fa.LAUNCHES_BWD_DQ.value,
                  fa.LAUNCHES_BWD_DKV.value)
        with mt.autograd.record():
            s, e = net(tok.to(dev), torch.zeros_like(tok).to(dev))
            loss = lf(s, y0.to(dev)) + lf(e, y0.to(dev))
        mt.autograd.backward(loss)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = (fa.LAUNCHES.value, fa.LAUNCHES_BWD_DQ.value,
                     fa.LAUNCHES_BWD_DKV.value)
            assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
        params = net.collect_params()
        for name in ("bert.encoder.layers.0.attention.qkv.weight",
                     "bert.encoder.layers.0.attention.qkv.bias",
                     "bert.word_embed.weight"):
            grads.setdefault(name, []).append(params[name].grad().cpu())
    for name, (cpu_g, cuda_g) in grads.items():
        assert cuda_g.abs().max() > 1e-4, name
        torch.testing.assert_close(cuda_g, cpu_g, atol=1e-4, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")
