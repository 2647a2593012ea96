"""The attention kernels' variants: which one a call takes, and the checks of
the bfloat16 tensor-core kernels that a tolerance cannot make.

On the CPU (no card needed): ``kernel_route``, the wrapper's decision
(plain version for CPU tensors; the tensor-core variant for CUDA bfloat16;
the FP32 variant for CUDA float32; anything else raises), that the entry
points dispatch on its answer, and that CPU bfloat16 calls launch nothing.

On the card (marked ``cuda``, skipped here; no JAX imported):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_flash_attention_mma.py

the launchers' staging rule (16-byte or 2-byte copies) on real layouts, the
dropout mask bit for bit at head dims 64 and 128 (q = k = 0 makes P
uniform, so with v = I the output is positive exactly where the hash keeps
a pair, and with dO = I so is dv transposed; with k = I and v, dO one-hot
in one column, dq is positive exactly there too), two backward runs
bitwise equal, and the fused-QKV, offset and D = 36 layouts against the
plain version.
"""
import math

import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as fa


def test_route_by_device_and_dtype():
    route = fa.kernel_route
    assert route(torch.bfloat16, "cpu") == "plain"
    assert route(torch.float32, "cpu") == "plain"
    assert route(torch.float16, "cpu") == "plain"
    assert route(torch.float32, "cuda") == "fp32"
    assert route(torch.bfloat16, "cuda") == "mma"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        route(torch.float16, "cuda")
    with pytest.raises(ValueError, match="cpu or cuda"):
        route(torch.bfloat16, "meta")
    assert fa.VARIANTS == {torch.bfloat16: "mma", torch.float32: "fp32"}
    q = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    assert fa.tensor_route(q, None, q) == ("plain", None)


@pytest.mark.parametrize("entry", ["fwd", "bwd", "autograd"])
def test_dispatch_follows_kernel_route(entry, monkeypatch):
    """The entry points launch what ``kernel_route`` answers: told "mma"
    for CPU tensors, they reach the launchers (stubbed here), not the
    plain version."""
    asked, launched = [], []

    def route(dtype, device_type):
        asked.append((dtype, device_type))
        return "mma"

    def launch(q, k, v, *args):
        launched.append("fwd")
        return torch.zeros_like(q), torch.zeros(q.shape[:3])

    def launch_bwd(q, k, v, *args):
        launched.append("bwd")
        return tuple(torch.ones_like(t) for t in (q, k, v))

    monkeypatch.setattr(fa, "kernel_route", route)
    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(fa, "_launch_bwd", launch_bwd)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 9, 16, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    if entry == "fwd":
        out, _ = fa.flash_attention_fwd(q, k, v)
        assert not out.any()
    elif entry == "bwd":
        out, lse = fa.flash_attention_reference(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do)
        assert all(bool((t == 1).all()) for t in grads)
    else:
        q.requires_grad_()
        fa.flash_attention(q, k, v).backward(do)
        assert bool((q.grad == 1).all())
    want = {"fwd": ["fwd"], "bwd": ["bwd"], "autograd": ["fwd", "bwd"]}
    assert launched == want[entry]
    assert asked == [(torch.bfloat16, "cpu")] * len(launched)


def _layout(name):
    """q, k, v (CPU, bf16) in a named layout, and whether the tensor-core
    kernels stage it with 16-byte copies."""
    b, h, s = 2, 3, 40
    if name == "fused_qkv_d64":  # BERT: strided views of one QKV tensor
        qkv = torch.zeros(b, s, 3, h, 64, dtype=torch.bfloat16)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)], True
    if name == "contiguous_d40":  # D a multiple of 8 but not of 16
        return [torch.zeros(b, h, s, 40, dtype=torch.bfloat16)
                for _ in range(3)], True
    if name == "fused_qkv_d36":  # D and the head stride not multiples of 8
        qkv = torch.zeros(b, s, 3, h, 36, dtype=torch.bfloat16)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)], False
    # "offset": rows start 2 bytes past a 16-byte boundary
    n = b * h * s * 64
    flat = torch.zeros(3 * n + 1, dtype=torch.bfloat16)
    return [flat[1 + i * n:1 + (i + 1) * n].view(b, h, s, 64)
            for i in range(3)], False


def test_cpu_bf16_takes_the_plain_version_and_launches_nothing():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 33, 16, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    before = {c.name: c.value for c in fa._build.COUNTERS.values()}
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                      dropout_seed=3)
    want, want_lse = fa.flash_attention_reference(
        q, k, v, causal=True, scale=1 / math.sqrt(16), dropout_p=0.1,
        dropout_seed=3)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                   dropout_p=0.1, dropout_seed=3)
    assert all(x.dtype == torch.bfloat16 for x in grads)
    assert {c.name: c.value for c in fa._build.COUNTERS.values()} == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_route_alignment_rule(cuda_device):
    """``tensor_route`` answers with the launchers' own staging rule: 16-byte
    copies where every row starts on 16 bytes and D % 8 = 0."""
    for name in ("fused_qkv_d64", "contiguous_d40", "fused_qkv_d36",
                 "offset"):
        (q, k, v), aligned = _layout(name)
        assert fa.tensor_route(q, k, v) == ("plain", None), name
        base = q._base if q._base is not None else None
        if base is None:
            ts = [t.to(cuda_device) for t in (q, k, v)]
        else:
            on_card = base.to(cuda_device)
            ts = [on_card.as_strided(t.shape, t.stride(), t.storage_offset())
                  for t in (q, k, v)]
        out = fa._empty_bshd(*ts[0].shape, ts[0])
        assert fa.tensor_route(*ts, out) == ("mma", aligned), name
        assert fa.tensor_route(*[t.float() for t in ts]) == ("fp32", None)


@pytest.mark.cuda
def test_cuda_dropout_mask_is_the_hash_bit_for_bit(cuda_device):
    b, h, p, seed = 2, 3, 0.1, 7
    for s in (64, 128):  # S = D: head dims 64 and 128
        zero = torch.zeros(b, h, s, s, device=cuda_device,
                           dtype=torch.bfloat16)
        eye = torch.eye(s, device=cuda_device,
                        dtype=torch.bfloat16).expand(b, h, s, s)
        out, lse = fa.flash_attention_fwd(zero, zero, eye, dropout_p=p,
                                          dropout_seed=seed)
        _, _, dv = fa.flash_attention_bwd(zero, zero, eye, out, lse, eye,
                                          dropout_p=p, dropout_seed=seed)
        keep = fa._dropout_keep(
            seed, torch.arange(b * h, device=cuda_device).reshape(b, h, 1, 1),
            torch.arange(s, device=cuda_device).reshape(1, 1, s, 1),
            torch.arange(s, device=cuda_device).reshape(1, 1, 1, s), p)
        assert torch.equal(out.float() > 0, keep)
        assert torch.equal(dv.float().transpose(2, 3) > 0, keep)
        # q = 0, k = I, v and dO one-hot in column 0: dq[i, j] = dS[i, j] =
        # P (keep - kept share of row i) / (1 - p) * scale, positive exactly
        # where the hash keeps (i, j); rows kept whole have no sign to show
        onehot = torch.zeros_like(zero)
        onehot[..., 0] = 1
        o1, lse1 = fa.flash_attention_fwd(zero, eye, onehot, dropout_p=p,
                                          dropout_seed=seed)
        dq, _, _ = fa.flash_attention_bwd(zero, eye, onehot, o1, lse1,
                                          onehot, dropout_p=p,
                                          dropout_seed=seed)
        partial_rows = ~keep.all(dim=-1, keepdim=True)
        assert not (((dq.float() > 0) != keep) & partial_rows).any()


@pytest.mark.cuda
def test_cuda_backward_is_deterministic(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(2, 4, 200, 64, device=cuda_device,
                               generator=g).to(torch.bfloat16)
                   for _ in range(4))
    runs = []
    for _ in range(2):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                          dropout_seed=5)
        runs.append((out, lse) + fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True, dropout_p=0.1,
            dropout_seed=5))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_layouts_match_the_plain_version(cuda_device):
    for name in ("fused_qkv_d64", "contiguous_d40", "fused_qkv_d36",
                 "offset"):
        (q, k, v), aligned = _layout(name)
        g = torch.Generator().manual_seed(1)
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=g).to(torch.bfloat16))
        if name in ("fused_qkv_d64", "fused_qkv_d36"):
            base = q._base if q._base is not None else q
            base = base.to(cuda_device)
            q, k, v = (base[:, :, i].transpose(1, 2) for i in range(3))
        elif name == "offset":
            flat = q._base.to(cuda_device)
            n = q.numel()
            q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(q.shape)
                       for i in range(3))
        else:
            q, k, v = (t.to(cuda_device) for t in (q, k, v))
        assert fa.tensor_route(q, k, v) == ("mma", aligned), name
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        want, want_lse = fa.flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert (out.float() - want.float()).abs().max().item() <= 3e-2, name
        assert (lse - want_lse).abs().max().item() <= 1e-3, name
