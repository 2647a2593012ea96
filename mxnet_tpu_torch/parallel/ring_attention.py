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

The flash ring runs ``ops/flash_attention.py`` on every hop: K4 forward,
K5a and K5b backward, on CUDA tensors (their plain versions on CPU
tensors). Partial results merge by their logsumexp in float32 (plain
PyTorch: XLA fuses the merge in the JAX package). Causal hops are decided
on the host from the two positions: the diagonal hop runs the causal
kernel, past hops the full one, and future hops launch nothing. Nothing
between the first hop and the result (or the gradients) reads a device
value on the host.

The JAX package tile-pads a ragged local shard to 128 rows and masks the
padding (``valid_len``), and sends a head dim that is not a multiple of 8
to the plain ring, because Pallas blocks stay lane-aligned; K4 and K5 take
any sequence length and any head dim up to 128, so the port pads nothing
and runs the kernels on every hop. ``interpret`` is accepted and does
nothing: the tensors' device decides.

References (public): Liu et al., "Ring Attention with Blockwise
Transformers" (2023); the streaming-softmax recurrence is the
FlashAttention online softmax.
"""
from __future__ import annotations

import math

import torch

from ..kernels import build as _build
from ..ops.flash_attention import flash_attention_bwd, flash_attention_fwd
from .mesh import assemble, split

__all__ = ["ring_attention", "ring_attention_sharded",
           "ring_flash_attention", "ring_flash_attention_sharded",
           "LAUNCHES", "LAUNCHES_BWD"]

#: flash-ring forwards (backwards) whose hops ran the CUDA kernels; the
#: kernels' own launches are counted by ops/flash_attention.py
LAUNCHES = _build.counter("ring_flash_attention")
LAUNCHES_BWD = _build.counter("ring_flash_attention_bwd")


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


def _merge(out_a, lse_a, out_b, lse_b):
    """Exact merge of two normalized partials by their logsumexp."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    safe = torch.where(torch.isneginf(lse_new), 0.0, lse_new)
    w_a = torch.where(torch.isneginf(lse_a), 0.0,
                      torch.exp(lse_a - safe))[..., None]
    w_b = torch.where(torch.isneginf(lse_b), 0.0,
                      torch.exp(lse_b - safe))[..., None]
    return w_a * out_a + w_b * out_b, lse_new


def _ring_flash_fwd_impl(qs, ks, vs, causal, scale):
    """Ring attention with the flash kernel (K4) as each hop's block
    compute: ``(outs, lses)`` per position, outs in q's dtype, lse float32
    (B, H, S_local). Each hop's normalized partial merges exactly:

        lse = logaddexp(lse_a, lse_b)
        out = exp(lse_a - lse) * out_a + exp(lse_b - lse) * out_b

    A future hop (causal, keys after the queries' block) launches nothing:
    its lse would be -inf, which leaves the merge unchanged."""
    n = len(qs)
    if qs[0].device.type == "cuda":
        LAUNCHES.add()
    outs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in qs]
    lses = [torch.full(q.shape[:3], -math.inf, dtype=torch.float32,
                       device=q.device) for q in qs]
    kb, vb = list(ks), list(vs)
    for i, live in enumerate(_hops(n, causal)):
        for my, _, diag in live:
            blk_out, blk_lse = flash_attention_fwd(
                qs[my], kb[my], vb[my], causal=diag, scale=scale)
            outs[my], lses[my] = _merge(outs[my], lses[my], blk_out.float(),
                                        blk_lse)
        if i < n - 1:
            kb, vb = _rotate(kb), _rotate(vb)
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_flash_bwd(qs, ks, vs, outs, lses, douts, causal, scale,
                    hop_bwd=None):
    """Ring backward: one full rotation; each hop runs the flash backward
    (K5a, K5b) between the local Q and the resident K/V block with the
    saved GLOBAL out and lse. dQ accumulates locally in float32; each
    block's dK/dV accumulates in float32 and travels with it around the
    ring until it is home. Past hops run the kernels un-causal, the
    diagonal hop causal, future hops are skipped. ``hop_bwd`` replaces
    each hop's backward (same signature as :func:`flash_attention_bwd`),
    so that the ring can be checked with a plain hop on the card."""
    hop_bwd = hop_bwd or flash_attention_bwd
    n = len(qs)
    if qs[0].device.type == "cuda":
        LAUNCHES_BWD.add()

    def zeros(ts):
        return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in ts]

    dq, dk, dv = zeros(qs), zeros(ks), zeros(vs)
    kb, vb = list(ks), list(vs)
    for i, live in enumerate(_hops(n, causal)):
        for my, _, diag in live:
            dq_h, dk_h, dv_h = hop_bwd(
                qs[my], kb[my], vb[my], outs[my], lses[my], douts[my],
                causal=diag, scale=scale)
            dq[my].add_(dq_h)
            dk[my].add_(dk_h)
            dv[my].add_(dv_h)
        # the blocks and their accumulated gradients rotate together, so
        # after n hops every block's dK/dV is back at its owner
        dk, dv = _rotate(dk), _rotate(dv)
        if i < n - 1:
            kb, vb = _rotate(kb), _rotate(vb)
    return ([g.to(t.dtype) for g, t in zip(dq, qs)],
            [g.to(t.dtype) for g, t in zip(dk, ks)],
            [g.to(t.dtype) for g, t in zip(dv, vs)])


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
