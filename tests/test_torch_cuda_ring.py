"""Ring flash attention (K6) on the card at a small size. Marked ``cuda``;
every test skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_ring.py

Four mesh positions on ``cuda:0``. At D = 64 a bf16 ring runs the hop
kernels (ops/ring_hop.py: ring_flash_fwd and ring_flash_bwd, 16 launches
of each, 10 causal; K4 and K5 none); at D = 12, and in f32, the earlier
route (K4 forward and K5a, K5b backward per hop, on the tensor cores for
bf16, the FP32 kernels for f32). The bf16 ring agrees with the plain ring
on the card within 2^-7 of the largest |out| (its gradients with the plain
ring's autograd gradients within 2^-7 + 4 x 2^-8 of the largest, the
tolerance of the K4/K5 route, whose hops round their gradients to bf16),
the f32 ring with the same call on the CPU within 1e-5 of the largest,
ragged local shards (S = 100 over 4, 25 rows a position) included; the
last test runs chip_smoke.py's phase 19 at a small size.
"""
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.parallel import mesh as pmesh
from mxnet_tpu_torch.parallel import ring_attention as ring

N = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kbuild.build(["flash_attention_fwd", "flash_attention_bwd",
                  "ring_flash_fwd", "ring_flash_bwd"])
    return torch.device("cuda", 0)


def _operands(dev, shape, dt, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*shape, device=dev, generator=gen).to(dt)
            for _ in range(4)]


def _run(fn, mesh, ops, causal):
    leaves = [t.detach().clone().requires_grad_() for t in ops[:3]]
    out = fn(*leaves, mesh, causal=causal)
    out.backward(ops[3])
    return [out.detach()] + [t.grad for t in leaves]


def _err(a, b):
    return ((a.float() - b.float()).abs().max().item(),
            b.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 12])
@pytest.mark.parametrize("causal", [False, True])
def test_each_hop_launches_the_tensor_core_kernels(cuda_device, causal, d):
    """D = 64: one hop kernel a hop each way. D = 12 (not a head dim the
    hop kernels are built for): K4, K5a and K5b on every hop (by 2-byte
    loads), as before."""
    mesh = pmesh.make_mesh({"sp": N}, [cuda_device] * N)
    ops = _operands(cuda_device, (1, 2, 512, d), torch.bfloat16, 1)
    torch.cuda.synchronize()
    kbuild.reset_counters()
    ring.ROUTES.clear()
    got = _run(ring.ring_flash_attention_sharded, mesh, ops, causal)
    torch.cuda.synchronize()
    counts = {c.name: c.value for c in kbuild.COUNTERS.values()}
    want = N * (N + 1) // 2 if causal else N * N
    hop = d in (64, 128)
    for name in ("ring_flash_fwd", "ring_flash_bwd"):
        assert counts.get(name, 0) == (want if hop else 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == counts[f"{name}_mma"] == (0 if hop else want)
        assert counts[f"{name}_fp32"] == 0
    assert ring.ROUTES == {"hop" if hop else "k4k5": 2}
    assert counts["ring_flash_attention"] == 1
    assert counts["ring_flash_attention_bwd"] == 1
    ref = _run(ring.ring_attention_sharded, mesh, ops, causal)
    e, big = _err(got[0], ref[0])
    assert e <= 2 ** -7 * big
    for g, r in zip(got[1:], ref[1:]):
        e, big = _err(g, r)
        assert e <= (2 ** -7 + N * 2 ** -8) * big


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_ragged_local_shards_on_the_kernels(cuda_device, dt):
    """S = 100 over 4 positions: 25 rows a shard, which the kernels take
    as they are (no padding)."""
    mesh = pmesh.make_mesh({"sp": N}, [cuda_device] * N)
    cpu = pmesh.make_mesh({"sp": N}, [torch.device("cpu")] * N)
    ops = _operands(cuda_device, (2, 3, 100, 64), dt, 2)
    kbuild.reset_counters()
    got = _run(ring.ring_flash_attention_sharded, mesh, ops, True)
    name = ("ring_flash_fwd" if dt == torch.bfloat16
            else "flash_attention_fwd_fp32")
    assert kbuild.COUNTERS[name].value == 10
    if dt == torch.float32:
        want = _run(ring.ring_flash_attention_sharded, cpu,
                    [t.cpu() for t in ops], True)
        tol = 1e-5
    else:
        want = _run(ring.ring_attention_sharded, mesh, ops, True)
        tol = 2 ** -7 + N * 2 ** -8
    for g, w in zip(got, want):
        e, big = _err(g.cpu(), w.cpu())
        assert e <= tol * big, (e, big)


@pytest.mark.cuda
def test_forward_alone_takes_no_host_sync(cuda_device):
    mesh = pmesh.make_mesh({"sp": N}, [cuda_device] * N)
    q, k, v, _ = _operands(cuda_device, (1, 2, 256, 64), torch.bfloat16, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out = ring.ring_flash_attention_sharded(q, k, v, mesh,
                                                    causal=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    e, big = _err(out, ref)
    assert e <= 2 ** -7 * big


@pytest.mark.cuda
def test_phase_ring(cuda_device):
    out = chip_smoke.phase_ring(torch, kbuild, fa, "card", seq=2048,
                                heads=4, small=512, ulysses_seq=512,
                                ragged=200, serve=(2, 4, 128, 64))
    assert out["full"]["launches"]["ring_flash_fwd"] == N * N
    assert out["causal"]["launches"]["ring_flash_bwd"] == 10
    assert out["full"]["ms"] > 0 and out["causal"]["bwd_ms"] > 0
    assert len(out["hop_cases"]) == 8
