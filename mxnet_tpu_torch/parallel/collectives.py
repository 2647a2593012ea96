"""Collectives over a mesh axis: psum, all_gather, reduce_scatter, ppermute
(counterpart of mxnet_tpu/parallel/collectives.py).

The JAX functions take and return global arrays and run one ``shard_map``
program each. These take and return whole tensors: each input is split
over the positions of ``axis`` (``mesh.split``: per-position shards in
mesh order, the representation of a sharded value in this package), the
shards travel between positions (``t.to(dev, non_blocking=True)``, the
identity where two positions share a device), and the result is assembled
back into what the JAX global array holds, on the axis's first position.
Other mesh axes carry replicas; one replica computes for all.

A pytree is nested dicts (leaves in sorted key order, as JAX flattens
them), lists and tuples of tensors; None holds no leaf.

Every wrapper opens a ``collective`` span and records call count, input
bytes and host time under the JAX package's op names (``collective_*``
series). :func:`psum_tree_flat_traced` is the in-program form that a
captured training step uses: it takes per-position trees (what each
position holds inside the JAX package's ``shard_map``) and returns them
summed, with no span, no telemetry and no host synchronisation, so a CUDA
graph can capture it. The watchdog guard waits for ``diagnostics/``.
"""
from __future__ import annotations

import time

import torch

from .. import env as _env
from ..diagnostics import spans as _spans
from ..telemetry import instruments as _telemetry
from .mesh import ShardingError, assemble, split

__all__ = ["psum_tree", "psum_tree_flat", "psum_tree_flat_traced",
           "allreduce_mean", "all_gather", "reduce_scatter", "ring_permute",
           "axis_size"]


def axis_size(axis_name, mesh):
    """Size of the named mesh axis."""
    return mesh.shape[axis_name]


def _flatten(tree):
    """``(leaves, rebuild)``: the tree's leaves in JAX's order and a
    function that builds the same structure from new leaves."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(p[0]) for p in parts]
    kind = type(tree)

    def rebuild(leaves):
        subs, at = [], 0
        for (_, sub), c in zip(parts, counts):
            subs.append(sub(leaves[at:at + c]))
            at += c
        if keys is not None:
            return dict(zip(keys, subs))
        return kind(subs)

    return [x for p in parts for x in p[0]], rebuild


def _nbytes(t):
    return t.numel() * t.element_size()


def _sum_shards(shards):
    """The sum of per-position shards, on the first position's device (the
    partial sums travel along the ring, one position to the next)."""
    acc = shards[0]
    for s in shards[1:]:
        acc = s + acc.to(s.device, non_blocking=True)
    return acc.to(shards[0].device, non_blocking=True)


def psum_tree(tree, mesh, axis="dp"):
    """Allreduce-sum a pytree of tensors sharded batch-first over ``axis``:
    each leaf's blocks along dim 0 summed, one block's shape out."""
    leaves, rebuild = _flatten(tree)
    t0 = time.perf_counter()
    with _spans.span("psum", cat="collective"):
        out = [_sum_shards(split(x, mesh, axis, 0)) for x in leaves]
    _telemetry.record_collective("psum", sum(map(_nbytes, leaves)),
                                 time.perf_counter() - t0)
    return rebuild(out)


def _flat_buckets(leaves, cap_bytes):
    """Partition leaf indices into dtype-homogeneous buckets of roughly
    `cap_bytes` each (order-preserving within a dtype). A leaf larger
    than the cap gets its own bucket — never split, never dropped."""
    buckets, open_by_dtype = [], {}
    for i, leaf in enumerate(leaves):
        nb = _nbytes(leaf)
        cur = open_by_dtype.get(leaf.dtype)
        if cur is not None and cur[1] + nb <= cap_bytes:
            cur[0].append(i)
            open_by_dtype[leaf.dtype] = (cur[0], cur[1] + nb)
        else:
            fresh = [i]
            buckets.append(fresh)
            open_by_dtype[leaf.dtype] = (fresh, nb)
    return buckets


def _resolve_bucket_mb(bucket_mb):
    if bucket_mb is not None:
        return int(bucket_mb)
    return int(_env.get("MXTPU_FUSED_BUCKET_MB"))


def psum_tree_flat(tree, mesh, axis="dp", bucket_mb=None):
    """Bucketed flat allreduce of a pytree: each position's blocks of the
    leaves are flattened and concatenated into dtype-homogeneous buffers
    of ~`bucket_mb` MB, ONE sum runs per buffer, and the sum is split back
    to the leaves' block shapes. Semantics match :func:`psum_tree`.
    `bucket_mb` defaults to ``MXTPU_FUSED_BUCKET_MB``."""
    leaves, rebuild = _flatten(tree)
    if not leaves:
        return tree
    buckets = _flat_buckets(leaves, _resolve_bucket_mb(bucket_mb) << 20)
    t0 = time.perf_counter()
    with _spans.span("psum_flat", cat="collective"):
        shards = [split(x, mesh, axis, 0) for x in leaves]
        n = len(shards[0])
        out = [None] * len(leaves)
        for bucket in buckets:
            flat = [shards[bucket[0]][p].reshape(-1) if len(bucket) == 1
                    else torch.cat(
                        [shards[i][p].reshape(-1) for i in bucket])
                    for p in range(n)]
            red = _sum_shards(flat)
            off = 0
            for i in bucket:
                shape = shards[i][0].shape
                size = shards[i][0].numel()
                out[i] = red[off:off + size].reshape(shape)
                off += size
    _telemetry.record_collective("psum_flat", sum(map(_nbytes, leaves)),
                                 time.perf_counter() - t0)
    for bucket in buckets:
        _telemetry.record_fused_bucket("allreduce", len(bucket))
    return rebuild(out)


def psum_tree_flat_traced(trees, axis=None, bucket_mb=None):  # noqa: ARG001
    """The bucketed flat sum inside a step (mxnet_tpu/parallel/
    collectives.py:psum_tree_flat_traced): ``trees`` is the list of the
    positions' pytrees along the reduced axis, in position order (``axis``
    names it, for the JAX signature). Each position's leaves are
    concatenated into dtype-homogeneous buffers of ~``bucket_mb`` MB, the
    buffers are summed in position order (the partial sums travel from one
    position to the next), and every position gets the sum back, split to
    its leaves' shapes, on its own device. Returns the list of summed
    trees. Nothing here reads the host, so a CUDA graph captures it."""
    flat = [_flatten(t) for t in trees]
    leaves = [f[0] for f in flat]
    if not leaves or not leaves[0]:
        return list(trees)
    buckets = _flat_buckets(leaves[0], _resolve_bucket_mb(bucket_mb) << 20)
    out = [[None] * len(leaves[0]) for _ in trees]
    for bucket in buckets:
        parts = [ls[bucket[0]].reshape(-1) if len(bucket) == 1
                 else torch.cat([ls[i].reshape(-1) for i in bucket])
                 for ls in leaves]
        red = _sum_shards(parts)
        for p, ls in enumerate(leaves):
            mine = red.to(ls[0].device, non_blocking=True)
            off = 0
            for i in bucket:
                n = ls[i].numel()
                out[p][i] = mine[off:off + n].view(ls[i].shape)
                off += n
    return [rebuild(o) for (_, rebuild), o in zip(flat, out)]


def allreduce_mean(tree, mesh, axis="dp"):
    n = mesh.shape[axis]
    leaves, rebuild = _flatten(psum_tree(tree, mesh, axis))
    return rebuild([x / n for x in leaves])


def all_gather(x, mesh, axis="dp", tiled=True):
    """All-gather along a mesh axis: every position's block, concatenated
    along dim 0 (``tiled``) or stacked on a new leading axis."""
    t0 = time.perf_counter()
    with _spans.span("all_gather", cat="collective"):
        shards = split(x, mesh, axis, 0)
        if tiled:
            out = assemble(shards, 0)
        else:
            dev = shards[0].device
            out = torch.stack(
                [s.to(dev, non_blocking=True) for s in shards])
    _telemetry.record_collective("all_gather", _nbytes(x),
                                 time.perf_counter() - t0)
    return out


def reduce_scatter(x, mesh, axis="dp"):
    """Reduce-scatter along a mesh axis (ZeRO-style sharded grads).

    Input: every position holds a full copy of ``x`` (replicated); output:
    position i keeps block i of the sum over positions, assembled along
    dim 0 (``axis size * x``, as the JAX package's global result)."""
    t0 = time.perf_counter()
    with _spans.span("reduce_scatter", cat="collective"):
        devs = mesh.positions(axis)
        if x.shape[0] % len(devs):
            raise ShardingError(
                f"dim 0 ({x.shape[0]}) of shape {tuple(x.shape)} is not "
                f"divisible by mesh axis {axis} (size {len(devs)})")
        copies = [x.to(dev, non_blocking=True) for dev in devs]
        blocks = [c.chunk(len(devs), 0) for c in copies]
        out = assemble(
            [_sum_shards([b[i] for b in blocks[i:] + blocks[:i]])
             for i in range(len(devs))], 0)
    _telemetry.record_collective("reduce_scatter", _nbytes(x),
                                 time.perf_counter() - t0)
    return out


def ring_permute(x, mesh, axis="sp", shift=1):
    """Neighbour exchange along a ring: position i's block along dim 0
    moves to position (i + shift) % n — the building block of ring
    attention."""
    t0 = time.perf_counter()
    with _spans.span("ppermute", cat="collective"):
        shards = split(x, mesh, axis, 0)
        n = len(shards)
        moved = [None] * n
        for i, s in enumerate(shards):
            j = (i + shift) % n
            moved[j] = s.to(shards[j].device, non_blocking=True)
        out = assemble(moved, 0)
    _telemetry.record_collective("ppermute", _nbytes(x),
                                 time.perf_counter() - t0)
    return out
