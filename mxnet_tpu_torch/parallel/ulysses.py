"""Ulysses-style sequence parallelism: all-to-all head<->sequence resharding
(counterpart of mxnet_tpu/parallel/ulysses.py).

The ring's sibling. Activations arrive sharded on the sequence axis; an
all-to-all reshards them to head groups over the full sequence, each
position runs plain attention over its head group (float32 scores and
softmax, as the JAX package's einsum path: no kernel), and a second
all-to-all restores sequence sharding. The all-to-alls are moves of shard
lists between the positions (``t.to(dev, non_blocking=True)``).

Reference (public): Jacobs et al., "DeepSpeed Ulysses" (2023).
"""
from __future__ import annotations

import torch

from .mesh import assemble, split

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(qs, ks, vs, causal=False, scale=None):
    """Per-position shards ``qs``, ``ks``, ``vs`` (lists in mesh order,
    each (batch, heads, seq_local, head_dim)) to per-position outputs;
    the heads must divide the number of positions evenly."""
    n = len(qs)
    b, h, s_local, d = qs[0].shape
    if h % n:
        raise ValueError(f"heads {h} not divisible by axis size {n}")
    if scale is None:
        scale = d ** -0.5
    hg = h // n
    devs = [q.device for q in qs]

    def seq_to_heads(xs):
        # position j receives head group j of every position's sequence
        # block: (b, h/n, S, d), blocks in sequence order
        return [torch.cat([x[:, j * hg:(j + 1) * hg].to(devs[j],
                                                        non_blocking=True)
                           for x in xs], dim=2) for j in range(n)]

    def heads_to_seq(xs):
        # inverse: position i receives its sequence block of every group
        return [torch.cat([x[:, :, i * s_local:(i + 1) * s_local].to(
            devs[i], non_blocking=True) for x in xs], dim=1)
            for i in range(n)]

    qh = seq_to_heads([q.float() for q in qs])
    kh = seq_to_heads([k.float() for k in ks])
    vh = seq_to_heads([v.float() for v in vs])
    oh = []
    for q, k, v in zip(qh, kh, vh):
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        if causal:
            idx = torch.arange(q.shape[2], device=q.device)
            scores = torch.where(idx[:, None] >= idx[None, :], scores,
                                 -torch.inf)
        oh.append(torch.einsum("bhqk,bhkd->bhqd",
                               torch.softmax(scores, dim=-1), v))
    return [o.to(qs[0].dtype) for o in heads_to_seq(oh)]


def ulysses_attention_sharded(q, k, v, mesh, axis="sp", causal=False,
                              scale=None):
    """Mirrors ring_attention_sharded: (b, h, S, d) tensors sharded on the
    sequence dim over ``axis``, the whole result on the axis's first
    position."""
    return assemble(ulysses_attention(
        *(split(t, mesh, axis, 2) for t in (q, k, v)), causal=causal,
        scale=scale), 2)
