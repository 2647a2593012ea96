"""Ring attention: sequence parallelism over a mesh axis (counterpart of
mxnet_tpu/parallel/ring_attention.py; the flash ring is K6 of the port's
kernel table).

The sequence axis is sharded over a mesh axis: each position holds a
Q/K/V shard, and K/V blocks rotate around the ring while a streaming
softmax accumulates the output. The JAX package runs each position's body
inside ``shard_map`` and rotates by ``lax.ppermute``; the port runs one
process over the mesh's positions (mesh.py), so its bodies take the lists
of per-position shards and run every position's hop in one call. A block
moves to the next position by ``t.to(dev, non_blocking=True)``: the
identity where positions share a device (a one-card host runs the whole
hop schedule on ``cuda:0``), a copy to the next card where they do not.

Each hop of the flash ring is one step of ``ops/ring_hop.py``: on CUDA
bfloat16 tensors with a head dim of 64 or 128 the Hopper hop kernels
(``csrc/ring_flash_fwd.cu``, ``csrc/ring_flash_bwd.cu``), which merge each
hop's partial into the position's float32 state by its logsumexp and add
each hop's gradients into the float32 sums inside the kernels; on CPU
tensors their plain versions, with the same in-place contract. CUDA
float32, and bfloat16 at another head dim, keep the earlier route: K4
forward and K5a, K5b backward on every hop (``ops/flash_attention.py``),
the merge and the gradient sums in plain PyTorch. The route is chosen
once per call from the dtype, the device and the head dim (``_route``,
counted in ``ROUTES``); nothing is retried on another route. Causal hops
are decided on the host from the two positions: the diagonal hop runs
causal, past hops in full, and future hops launch nothing. Nothing between
the first hop and the result (or the gradients) reads a device value on
the host.

The JAX package tile-pads a ragged local shard to 128 rows and masks the
padding (``valid_len``), and sends a head dim that is not a multiple of 8
to the plain ring, because Pallas blocks stay lane-aligned; K4 and K5 take
any sequence length and any head dim up to 128, so the port pads nothing
and runs the kernels on every hop (TMA zero-fills the ragged edge of a
tile). ``interpret`` is accepted and does nothing: the tensors' device
decides.

References (public): Liu et al., "Ring Attention with Blockwise
Transformers" (2023); the streaming-softmax recurrence is the
FlashAttention online softmax.
"""
from __future__ import annotations

import collections
import math

import torch

from ..kernels import build as _build
from ..ops.flash_attention import (_empty_bshd, flash_attention_bwd,
                                   flash_attention_fwd)
from ..ops.ring_hop import (kernel_takes, merge, ring_delta, ring_hop_bwd,
                            ring_hop_fwd)
from .mesh import assemble, split

__all__ = ["ring_attention", "ring_attention_sharded",
           "ring_flash_attention", "ring_flash_attention_sharded",
           "LAUNCHES", "LAUNCHES_BWD", "ROUTES"]

#: flash-ring forwards (backwards) whose hops ran CUDA kernels; the
#: kernels' own launches are counted by ops/ring_hop.py and
#: ops/flash_attention.py
LAUNCHES = _build.counter("ring_flash_attention")
LAUNCHES_BWD = _build.counter("ring_flash_attention_bwd")
#: flash-ring passes (forward or backward) by route: "hop" (the hop
#: kernels), "k4k5" (K4/K5 per hop), "plain" (CPU tensors, the hops' plain
#: versions). Not a launch counter: clear it yourself
ROUTES = collections.Counter()


def _hops(n, causal):
    """The ring's live hops, round by round: round ``i`` lists
    ``(position, block, causal)`` for every position whose resident block
    (the one position ``(position - i) % n`` owns) it attends to; the
    diagonal hop is causal, and a causal ring skips future blocks. Decided
    on the host, so no hop reads a device value."""
    return [[(my, (my - i) % n, causal and i == 0) for my in range(n)
             if not (causal and (my - i) % n > my)] for i in range(n)]


def _rotate(blocks):
    """One ring step: position i's block moves to position i + 1."""
    n = len(blocks)
    return [blocks[p - 1].to(blocks[p].device, non_blocking=True)
            for p in range(n)]


def _stable_block(q, k, v, o, m, l, scale, mask=None):  # noqa: E741
    """One blockwise-attention accumulation step (online softmax)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    m_blk = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    # guard -inf rows (fully masked block): exp(-inf - -inf) -> use where
    m_new_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_new_safe)
    corr = torch.exp(torch.where(torch.isneginf(m), 0.0, m) - m_new_safe)
    corr = torch.where(torch.isneginf(m), 0.0, corr)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    o_new = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o_new, m_new, l_new


def ring_attention(qs, ks, vs, causal=False, scale=None):
    """Plain ring attention (float32 online softmax) over the per-position
    shards ``qs``, ``ks``, ``vs`` (lists in mesh order, each (batch, heads,
    seq_local, head_dim)); returns the per-position outputs in q's dtype.
    Differentiable by torch autograd."""
    n = len(qs)
    s_local = qs[0].shape[2]
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    os_, ms, ls = [], [], []
    for q in qs:
        os_.append(torch.zeros(q.shape, dtype=torch.float32, device=q.device))
        ms.append(torch.full(q.shape[:3] + (1,), -math.inf,
                             dtype=torch.float32, device=q.device))
        ls.append(torch.zeros(q.shape[:3] + (1,), dtype=torch.float32,
                              device=q.device))
    qf = [q.float() for q in qs]
    kb, vb = list(ks), list(vs)
    for i in range(n):
        for my in range(n):
            src = (my - i) % n  # whose K/V block position my now holds
            mask = None
            if causal:
                dev = qs[my].device
                q_idx = my * s_local + torch.arange(s_local, device=dev)
                k_idx = src * s_local + torch.arange(kb[my].shape[2],
                                                     device=dev)
                mask = (q_idx[:, None] >= k_idx[None, :])[None, None]
            os_[my], ms[my], ls[my] = _stable_block(
                qf[my], kb[my].float(), vb[my].float(), os_[my], ms[my],
                ls[my], scale, mask)
        if i < n - 1:  # the last block needs no rotation after it
            kb, vb = _rotate(kb), _rotate(vb)
    return [(o / torch.where(l == 0, 1.0, l)).to(q.dtype)
            for o, l, q in zip(os_, ls, qs)]


def ring_attention_sharded(q, k, v, mesh, axis="sp", causal=False,
                           scale=None):
    """(b, h, S, d) tensors sharded on the sequence dim over ``axis``,
    plain ring attention, the whole result on the axis's first position."""
    return assemble(ring_attention(
        *(split(t, mesh, axis, 2) for t in (q, k, v)), causal=causal,
        scale=scale), 2)


def _route(q, hop_bwd=None):
    """The route of a flash-ring pass over shards like ``q``: "plain" for
    CPU tensors, "hop" for CUDA tensors the hop kernels take, else "k4k5";
    a backward given its own ``hop_bwd`` runs the hop loop with it."""
    if q.device.type == "cpu":
        return "plain"
    if hop_bwd is not None or kernel_takes(q.dtype, q.device.type,
                                           q.shape[-1]):
        return "hop"
    return "k4k5"


def _tma_ready(t):
    """``t``, or a contiguous copy when TMA cannot read it as it lies: a
    CUDA tensor whose base or (batch, head, seq) strides miss 16 bytes, or
    that is strided in its head dim."""
    if t.device.type != "cuda" or (
            t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and not any(st * t.element_size() % 16 for st in t.stride()[:3])):
        return t
    return t.contiguous()


def _ring_flash_fwd_impl(qs, ks, vs, causal, scale):
    """Ring attention with a flash kernel as each hop's block compute:
    ``(outs, lses)`` per position, outs in q's dtype, lse float32
    (B, H, S_local). Each hop's normalized partial merges exactly:

        lse = logaddexp(lse_a, lse_b)
        out = exp(lse_a - lse) * out_a + exp(lse_b - lse) * out_b

    inside the hop kernel (or its plain version), or after K4 on the
    "k4k5" route. A future hop (causal, keys after the queries' block)
    launches nothing: its lse would be -inf, which leaves the merge
    unchanged."""
    route = _route(qs[0])
    ROUTES[route] += 1
    if qs[0].device.type == "cuda":
        LAUNCHES.add()
    if route == "k4k5":
        return _ring_fwd_k4k5(qs, ks, vs, causal, scale)
    n = len(qs)
    qs, ks, vs = ([_tma_ready(t) for t in ts] for ts in (qs, ks, vs))
    hops = _hops(n, causal)
    # every position is live on round 0 (its own block); its last live
    # round writes the output in q's dtype
    last = {my: i for i, live in enumerate(hops) for my, _, _ in live}
    accs = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
            if last[my] else None for my, q in enumerate(qs)]
    lses = [torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
            for q in qs]
    outs = [_empty_bshd(*q.shape, q) for q in qs]
    kb, vb = list(ks), list(vs)
    for i, live in enumerate(hops):
        for my, _, diag in live:
            ring_hop_fwd(qs[my], kb[my], vb[my], accs[my], lses[my],
                         causal=diag, scale=scale, last=i == last[my],
                         out=outs[my], first=i == 0)
        if i < n - 1:
            kb, vb = _rotate(kb), _rotate(vb)
    return outs, lses


def _ring_fwd_k4k5(qs, ks, vs, causal, scale):
    """The "k4k5" route of :func:`_ring_flash_fwd_impl`: K4 on each hop, the
    merge in float32 PyTorch."""
    n = len(qs)
    outs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in qs]
    lses = [torch.full(q.shape[:3], -math.inf, dtype=torch.float32,
                       device=q.device) for q in qs]
    kb, vb = list(ks), list(vs)
    for i, live in enumerate(_hops(n, causal)):
        for my, _, diag in live:
            blk_out, blk_lse = flash_attention_fwd(
                qs[my], kb[my], vb[my], causal=diag, scale=scale)
            outs[my], lses[my] = merge(outs[my], lses[my], blk_out.float(),
                                       blk_lse)
        if i < n - 1:
            kb, vb = _rotate(kb), _rotate(vb)
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_flash_bwd(qs, ks, vs, outs, lses, douts, causal, scale,
                    hop_bwd=None):
    """Ring backward: one full rotation; each hop runs the attention
    backward between the local Q and the resident K/V block with the saved
    GLOBAL out and lse. dQ accumulates locally in float32; each block's
    dK/dV accumulates in float32 and travels with it around the ring until
    it is home. Past hops run un-causal, the diagonal hop causal, future
    hops are skipped.

    On the "hop" and "plain" routes delta = rowsum(dO * O) is computed once
    per position (:func:`ring_delta`) and each hop adds into the float32
    sums in place (:func:`ring_hop_bwd`); ``hop_bwd`` replaces each hop
    (same signature and in-place contract, e.g. ``ring_hop_bwd_reference``
    to check the ring with plain hops on the card). On the "k4k5" route K5a
    and K5b run on each hop and their gradients, in the inputs' dtype, are
    added into the sums."""
    route = _route(qs[0], hop_bwd)
    ROUTES[route] += 1
    if qs[0].device.type == "cuda":
        LAUNCHES_BWD.add()
    if route == "k4k5":
        return _ring_bwd_k4k5(qs, ks, vs, outs, lses, douts, causal, scale)
    hop_bwd = hop_bwd or ring_hop_bwd
    n = len(qs)
    qs, ks, vs, douts = ([_tma_ready(t) for t in ts]
                         for ts in (qs, ks, vs, douts))
    deltas = [ring_delta(o, d) for o, d in zip(outs, douts)]
    dq, dk, dv = _zeros(qs), _zeros(ks), _zeros(vs)
    kb, vb = list(ks), list(vs)
    for i, live in enumerate(_hops(n, causal)):
        for my, _, diag in live:
            hop_bwd(qs[my], kb[my], vb[my], douts[my], lses[my], deltas[my],
                    dq[my], dk[my], dv[my], causal=diag, scale=scale)
        # the blocks and their accumulated gradients rotate together, so
        # after n hops every block's dK/dV is back at its owner
        dk, dv = _rotate(dk), _rotate(dv)
        if i < n - 1:
            kb, vb = _rotate(kb), _rotate(vb)
    return _cast(dq, qs), _cast(dk, ks), _cast(dv, vs)


def _zeros(ts):
    return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in ts]


def _cast(gs, ts):
    return [g.to(t.dtype) for g, t in zip(gs, ts)]


def _ring_bwd_k4k5(qs, ks, vs, outs, lses, douts, causal, scale):
    """The "k4k5" route of :func:`_ring_flash_bwd`."""
    n = len(qs)
    dq, dk, dv = _zeros(qs), _zeros(ks), _zeros(vs)
    kb, vb = list(ks), list(vs)
    for i, live in enumerate(_hops(n, causal)):
        for my, _, diag in live:
            dq_h, dk_h, dv_h = flash_attention_bwd(
                qs[my], kb[my], vb[my], outs[my], lses[my], douts[my],
                causal=diag, scale=scale)
            dq[my].add_(dq_h)
            dk[my].add_(dk_h)
            dv[my].add_(dv_h)
        dk, dv = _rotate(dk), _rotate(dv)
        if i < n - 1:
            kb, vb = _rotate(kb), _rotate(vb)
    return _cast(dq, qs), _cast(dk, ks), _cast(dv, vs)


class _RingFlash(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse) per position, what
    ``_ring_flash_vjp_fwd`` saves; backward is :func:`_ring_flash_bwd`.
    The shards come flat, q's then k's then v's."""

    @staticmethod
    def forward(ctx, causal, scale, *shards):
        n = len(shards) // 3
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        outs, lses = _ring_flash_fwd_impl(qs, ks, vs, causal, scale)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.ring = (n, causal, scale)
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *douts):
        n, causal, scale = ctx.ring
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[j * n:(j + 1) * n] for j in range(5))
        dqs, dks, dvs = _ring_flash_bwd(qs, ks, vs, outs, lses, douts,
                                        causal, scale)
        return (None, None, *dqs, *dks, *dvs)


def ring_flash_attention(qs, ks, vs, causal=False, scale=None,
                         interpret=None):  # noqa: ARG001
    """Ring attention with the flash kernels per hop over the per-position
    shards ``qs``, ``ks``, ``vs`` (lists in mesh order), trainable end to
    end (a ``torch.autograd.Function`` whose backward is the ring
    backward); returns the per-position outputs."""
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    return list(_RingFlash.apply(bool(causal), float(scale), *qs, *ks, *vs))


def ring_flash_attention_sharded(q, k, v, mesh, axis="sp", causal=False,
                                 scale=None, interpret=None):
    """(b, h, S, d) tensors sharded on the sequence dim over ``axis``, the
    flash kernels per hop (the long-context path), the whole result on the
    axis's first position."""
    return assemble(ring_flash_attention(
        *(split(t, mesh, axis, 2) for t in (q, k, v)), causal=causal,
        scale=scale, interpret=interpret), 2)
