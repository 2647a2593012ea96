"""The ring's hop (mxnet_tpu_torch/ops/ring_hop.py, K6 on the card) on the
CPU: the plain versions of the forward and backward hop kernels, whose
contract the kernels keep (the forward merges each hop's float32 partial
into the position's running (acc, lse) in place and writes the output on
the last live hop; the backward adds into float32 dq, dk, dv in place from
a delta computed once per position), driven here over the ring's hop
schedule and held against the JAX package's ``ring_flash_attention_sharded``
(out and dq, dk, dv through ``jax.vjp``; lse from its
``_ring_flash_fwd_impl`` under the same ``shard_map``) on 4 of the 8
virtual CPU devices of tests/conftest.py, its Pallas kernels in interpret
mode: causal and not, a ragged shard (S = 100 over 4: 25 rows, which the
JAX package tile-pads to 32 and masks), D = 64, float32; forward within
rtol 1e-5, atol 1e-6, gradients within rtol 2e-4, atol 2e-5 (the JAX
package's own tolerances for its flash gradients). Then the pieces: one hop
from an empty state is the plain attention, two merged hops are attention
over the joined keys, the delta computed once is the per-hop delta of the
plain K5a, the wrappers refuse what the kernels do not take, and
tools/ring_hop_study.py's cuts of the kernel sources still apply.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.parallel import ring_attention as jring
from mxnet_tpu.parallel.collectives import shard_map
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import ring_hop as rh
from mxnet_tpu_torch.parallel import ring_attention as tring

N = 4


def _inputs(seed, shape):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*shape).astype("f") * 0.5 for _ in range(4)]


def _plain_hop_ring(arrs, causal):
    """The ring's schedule over the plain hops: the forward's running state
    per position, the backward's travelling dk, dv kept by their owner."""
    q, k, v, g = (torch.from_numpy(a.copy()) for a in arrs)
    qs, ks, vs, gs = (list(t.chunk(N, 2)) for t in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    hops = tring._hops(N, causal)
    last = {my: i for i, live in enumerate(hops) for my, _, _ in live}
    accs = [torch.empty(t.shape) for t in qs]
    lses = [torch.empty(t.shape[:3]) for t in qs]
    outs = [torch.empty_like(t) for t in qs]
    for i, live in enumerate(hops):
        for my, src, diag in live:
            rh.ring_hop_fwd_reference(qs[my], ks[src], vs[src], accs[my],
                                      lses[my], diag, scale, i == last[my],
                                      outs[my], i == 0)
    deltas = [rh.ring_delta(o, d) for o, d in zip(outs, gs)]
    dq, dk, dv = ([torch.zeros(t.shape) for t in ts] for ts in (qs, ks, vs))
    for live in hops:
        for my, src, diag in live:
            rh.ring_hop_bwd_reference(qs[my], ks[src], vs[src], gs[my],
                                      lses[my], deltas[my], dq[my], dk[src],
                                      dv[src], diag, scale)
    return [torch.cat(ts, 2).numpy() for ts in (outs, lses, dq, dk, dv)]


def _jax_ring(arrs, causal):
    mesh = jmesh.make_mesh({"sp": N}, jax.devices()[:N])
    q, k, v, g = (jnp.asarray(a) for a in arrs)
    out, vjp = jax.vjp(lambda q, k, v: jring.ring_flash_attention_sharded(
        q, k, v, mesh, causal=causal), q, k, v)
    s_local = q.shape[2] // N
    s_pad = -(-s_local // 8) * 8   # the JAX package's tile padding
    pad = [(0, 0), (0, 0), (0, s_pad - s_local), (0, 0)]
    spec = P(None, None, "sp", None)

    @partial(shard_map, mesh=mesh, in_specs=(spec, spec, spec),
             out_specs=P(None, None, "sp"), check_vma=False)
    def lse_of(ql, kl, vl):
        _, lse = jring._ring_flash_fwd_impl(
            *(jnp.pad(t, pad) for t in (ql, kl, vl)), "sp", causal,
            q.shape[-1] ** -0.5, True,
            s_local if s_pad != s_local else None)
        return lse[:, :, :s_local]

    lse = jax.jit(lse_of)(q, k, v)
    return [onp.asarray(out), onp.asarray(lse)] + [onp.asarray(x)
                                                  for x in vjp(g)]


@pytest.mark.parametrize("shape", [(1, 2, 64, 64), (1, 2, 100, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_hops_over_the_ring_match_the_jax_package(shape, causal):
    arrs = _inputs(10, shape)
    port = _plain_hop_ring(arrs, causal)
    ref = _jax_ring(arrs, causal)
    for name, p, r in zip(("out", "lse"), port[:2], ref[:2]):
        onp.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6,
                                    err_msg=name)
    for name, p, r in zip(("dq", "dk", "dv"), port[2:], ref[2:]):
        onp.testing.assert_allclose(p, r, rtol=2e-4, atol=2e-5,
                                    err_msg=name)


def test_one_hop_from_an_empty_state_is_the_plain_attention():
    """first and last together: the hop's own attention, out in q's dtype
    and its lse, equal to flash_attention_reference bit for bit (f32) and
    in bf16; acc is neither read nor written."""
    for dt, causal in ((torch.float32, False), (torch.float32, True),
                       (torch.bfloat16, True)):
        q, k, v, _ = (torch.from_numpy(a).to(dt)
                      for a in _inputs(11, (2, 3, 40, 64)))
        want, want_lse = fa.flash_attention_reference(q, k, v, causal)
        lse = torch.full((2, 3, 40), float("nan"))
        out, got_lse = rh.ring_hop_fwd(q, k, v, None, lse, causal,
                                       64 ** -0.5, True, first=True)
        assert got_lse is lse and out.dtype == dt
        assert torch.equal(out, want) and torch.equal(lse, want_lse)


def test_two_merged_hops_are_attention_over_the_joined_keys():
    """A first hop into acc, a second (last) hop merging into it: the
    attention of q over both key blocks, in float32 within 1e-6."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(12, (1, 2, 48, 64)))
    k2, v2 = (torch.from_numpy(a) for a in _inputs(13, (1, 2, 48, 64))[:2])
    acc, lse = torch.empty(q.shape), torch.empty(q.shape[:3])
    rh.ring_hop_fwd(q, k, v, acc, lse, False, 0.125, False, first=True)
    out, lse = rh.ring_hop_fwd(q, k2, v2, acc, lse, False, 0.125, True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, torch.cat([k, k2], 2)) * 0.125
    want = torch.softmax(s, -1) @ torch.cat([v, v2], 2)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)


def test_delta_once_is_the_per_hop_delta():
    """The backward hop from the delta computed once per position gives
    what the plain K5a pair gives on that hop from out (which recomputes
    delta on every hop), and that delta is rowsum(dO * O) in float32."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(14, (2, 2, 40, 64)))
    out, lse = fa.flash_attention_reference(q, k, v, True)
    delta = rh.ring_delta(out, g)
    torch.testing.assert_close(delta, (g * out).sum(-1), rtol=0, atol=0)
    dq, dk, dv = (torch.zeros(q.shape) for _ in range(3))
    for causal in (True, False):     # the diagonal hop, then a past one
        rh.ring_hop_bwd(q, k, v, g, lse, delta, dq, dk, dv, causal, 0.125)
    want = [sum(t) for t in zip(*(
        fa.flash_attention_bwd_reference(q, k, v, out, lse, g, c, 0.125)
        for c in (True, False)))]
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """CPU tensors take the plain versions whatever the dtype and head dim;
    the kernels' checks (run here on CPU tensors by letting kernel_takes
    accept them) refuse a head dim other than 64 or 128, a tensor strided
    in D, a base or a stride off 16 bytes, another shape, a non-float32 or
    non-contiguous state, and bf16 rows off 4 bytes for the output."""
    q, k, v, g = (torch.from_numpy(a).bfloat16()
                  for a in _inputs(15, (1, 2, 32, 12)))
    lse = torch.empty(1, 2, 32)
    rh.ring_hop_fwd(q, k, v, None, lse, False, 0.3, True, first=True)
    with pytest.raises(ValueError, match="CUDA bfloat16"):
        rh._check_tiles(q=q, k=k, v=v)
    monkeypatch.setattr(rh, "kernel_takes",
                        lambda dt, dev, d: dt == torch.bfloat16
                        and d in rh.HEAD_DIMS)
    with pytest.raises(ValueError, match="head dim"):
        rh._check_tiles(q=q, k=k, v=v)
    big = torch.zeros(1, 2, 40, 72, dtype=torch.bfloat16)
    ok = big[:, :, :32, :64]
    rh._check_tiles(q=ok, k=ok, v=ok)          # 144-byte rows: aligned
    with pytest.raises(ValueError, match="16 bytes"):
        rh._check_tiles(q=ok, k=big[:, :, 1:33, 4:68], v=ok)
    with pytest.raises(ValueError, match="16 bytes"):
        odd = torch.zeros(1, 2, 32, 68, dtype=torch.bfloat16)[..., :64]
        rh._check_tiles(q=ok, k=ok, v=odd)
    with pytest.raises(ValueError, match="contiguous in its head dim"):
        rh._check_tiles(q=ok, k=ok, v=torch.zeros(
            1, 2, 64, 32, dtype=torch.bfloat16).transpose(2, 3))
    with pytest.raises(ValueError, match="shape"):
        rh._check_tiles(q=ok, k=big[:, :, :16, :64], v=ok)
    with pytest.raises(ValueError, match="float32"):
        rh._check_f32(torch.empty(1, 2, 32, dtype=torch.bfloat16),
                      (1, 2, 32), torch.device("cpu"), "lse")
    with pytest.raises(ValueError, match="float32"):
        rh._check_f32(torch.empty(1, 2, 32, 64).transpose(2, 3),
                      (1, 2, 32, 64), torch.device("cpu"), "acc")


def test_the_hop_study_still_cuts_its_sources():
    """tools/ring_hop_study.py times copies of the hop kernels' sources
    with one part cut out by text: every cut still finds its part in the
    current sources (it raises otherwise), and each copy differs from its
    source."""
    from mxnet_tpu_torch.kernels import build
    from mxnet_tpu_torch.tools import ring_hop_study

    for kernel, cuts in ring_hop_study.variants().items():
        src = (build.CSRC / f"{kernel}.cu").read_text()
        assert len(cuts) >= 4
        assert all(text != src for text in cuts.values())
