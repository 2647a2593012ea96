"""Device meshes over ``torch.device`` positions (counterpart of
mxnet_tpu/parallel/mesh.py).

The JAX package builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. The port runs single-controller too, in one process: a
:class:`Mesh` names axes over an array of *positions*, each a
``torch.device``, and the collectives and ring attention move blocks
between the positions themselves (collectives.py). A position is a
logical slot, and several positions may name one device: torch has a
single CPU device, and a one-card host runs a four-position ring on
``cuda:0``. On a host with more cards the same code moves each block to the
next card. A sharded value is held as the list of its per-position shards
in mesh order (:func:`split`, :func:`assemble`).

A value laid out under a ``PartitionSpec`` over every position of a mesh
is a :class:`Placed`: one contiguous allocation a position, holding the
position's block (replicated dims give each position a copy of its own),
with :meth:`Placed.full` the logical value, as ``asnumpy()`` of a JAX
array gathers every shard. :class:`Layout` says where each block lies, and
:func:`block_copies` lists the copies that move one layout's blocks into
another's. :func:`shard_params` places Gluon Parameters this way (each
keeps its logical value for the forward, gluon/parameter.py), and
:func:`shard_batch` a batch over its data axis. Data parallelism across
processes is ``kvstore='tpu_dist'``; on a mesh, ``data_parallel.py``.
"""
from __future__ import annotations

import collections

import numpy as _np
import torch

from .. import device as _device

__all__ = ["make_mesh", "Mesh", "PartitionSpec", "ShardingError",
           "data_parallel_mesh", "local_mesh", "split", "assemble",
           "Layout", "Placed", "block_copies", "shard_params",
           "shard_batch"]


class ShardingError(ValueError):
    """A sharding request that cannot be laid out: a mesh spec that does
    not match the device count, or a dimension that is not divisible by the
    mesh axis its spec assigns it to. Raised eagerly with the name and spec
    in the message."""


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a sharded value: an axis name, a tuple of
    axis names, or None (replicated), as ``jax.sharding.PartitionSpec``;
    prints as it does (a one-name tuple reads as the name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()

    __str__ = __repr__


class Mesh:
    """Named axes over an array of ``torch.device`` positions. ``shape``
    maps each axis name to its size, in order (the last axis innermost);
    ``devices`` is the object array of positions."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ShardingError(
                f"{self.devices.ndim}-d device array for axes "
                f"{self.axis_names}")

    @property
    def shape(self):
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    def positions(self, axis):
        """The devices along ``axis``, every other axis at its first index:
        the other axes carry replicas, and one replica computes for all."""
        if axis not in self.axis_names:
            raise ShardingError(f"mesh axis {axis!r} not in "
                                f"{self.axis_names}")
        at = [0] * len(self.axis_names)
        at[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(at)])


def _all_cards():
    _device.default_device()  # raises without a card
    return [_device.gpu(i) for i in range(_device.num_gpus())]


def make_mesh(axes, devices=None):
    """Build a Mesh from {axis_name: size}; size -1 (or None) infers the
    remainder, and a second unknown axis gets size 1.

    Example: make_mesh({'dp': -1, 'tp': 4}) over 32 positions -> 8x4 mesh.
    The *last* axis is innermost (fastest-varying): neighbouring positions
    along it are neighbouring entries of ``devices``. Without ``devices``
    the mesh spans every CUDA card of this process, and raises without
    one; ``devices`` may repeat a device (``[cpu()] * 4``).
    """
    devices = list(devices if devices is not None else _all_cards())
    n = len(devices)
    names = list(axes.keys())
    sizes = list(axes.values())
    unknown = [i for i, s in enumerate(sizes) if s in (-1, None)]
    known = 1
    for s in sizes:
        if s not in (-1, None):
            known *= s
    if unknown:
        if n % known:
            raise ShardingError(
                f"{n} devices not divisible by {known} "
                f"(mesh spec {dict(zip(names, axes.values()))})")
        sizes[unknown[0]] = n // known
        for i in unknown[1:]:
            sizes[i] = 1
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ShardingError(
            f"mesh {dict(zip(names, sizes))} != {n} devices")
    arr = _np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(sizes), tuple(names))


def data_parallel_mesh(devices=None):
    """1-D 'dp' mesh over all devices (the kvstore='tpu_dist' topology)."""
    return make_mesh({"dp": -1}, devices)


def local_mesh(axes=None):
    """Mesh over this process's cards (one process holds them all)."""
    return make_mesh(axes or {"dp": -1}, _all_cards())


def _check_divisible(name, shape, spec, mesh):
    """Raise ShardingError naming the param and spec when a sharded
    dimension is not divisible by the product of its mesh axes."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        factor = 1
        for ax in axes:
            if ax not in mesh.shape:
                raise ShardingError(
                    f"parameter {name}: spec {spec} names mesh axis "
                    f"{ax!r}, but the mesh has axes "
                    f"{tuple(mesh.axis_names)}")
            factor *= mesh.shape[ax]
        if d >= len(shape) or shape[d] % factor:
            dim = shape[d] if d < len(shape) else "<missing>"
            raise ShardingError(
                f"parameter {name} with shape {tuple(shape)}: dim {d} "
                f"({dim}) is not divisible by mesh "
                f"axis {'x'.join(axes)} (size {factor}) in spec {spec}")


def split(x, mesh, axis, dim):
    """``x`` cut into equal blocks along ``dim``, one per position of
    ``axis`` in mesh order, each moved to its position's device."""
    devs = mesh.positions(axis)
    n = len(devs)
    if x.shape[dim] % n:
        raise ShardingError(
            f"dim {dim} ({x.shape[dim]}) of shape {tuple(x.shape)} is not "
            f"divisible by mesh axis {axis} (size {n})")
    return [blk.to(dev, non_blocking=True)
            for blk, dev in zip(x.chunk(n, dim), devs)]


def assemble(shards, dim):
    """The whole tensor of per-position ``shards`` along ``dim``, on the
    first position's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev, non_blocking=True) for s in shards], dim)


def _axes_of(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Layout:
    """Where the blocks of a logical tensor of ``shape`` lie when ``spec``
    places it on ``mesh``: ``blocks[k]``, the ``(start, stop)`` range of
    each dim held by the k-th position in mesh order (row-major over the
    axes), and ``devices[k]`` that position's device. A dim sharded over
    several axes numbers its blocks with the first axis major, as
    ``jax.sharding.NamedSharding`` does."""

    def __init__(self, mesh, spec, shape):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*(spec or ()))
        self.shape = tuple(int(d) for d in shape)
        sizes = mesh.shape
        self.devices = list(mesh.devices.flat)
        self.blocks = []
        for idx in _np.ndindex(mesh.devices.shape):
            at = dict(zip(mesh.axis_names, idx))
            ranges = []
            for d, n in enumerate(self.shape):
                entry = self.spec[d] if d < len(self.spec) else None
                parts, block = 1, 0
                for ax in _axes_of(entry):
                    parts *= sizes[ax]
                    block = block * sizes[ax] + at[ax]
                size = n // parts
                ranges.append((block * size, (block + 1) * size))
            self.blocks.append(tuple(ranges))

    def block_shape(self, k):
        return tuple(b - a for a, b in self.blocks[k])

    def distinct(self):
        """The number of different blocks (positions that are not
        replicas of an earlier one)."""
        return len(set(self.blocks))


class Placed:
    """A logical tensor held as one contiguous allocation per position of a
    :class:`Layout`, the position's block (module note). ``shards`` are in
    mesh order; :meth:`full` gathers the logical value on the first
    position's device, :meth:`write` copies a logical value into every
    shard."""

    __slots__ = ("layout", "shards")

    def __init__(self, layout, shards):
        self.layout = layout
        self.shards = list(shards)

    @classmethod
    def from_tensor(cls, x, layout):
        """``x`` (the logical value) cut into ``layout``'s blocks, each
        copied into an allocation of its own on its position's device."""
        if tuple(x.shape) != layout.shape:
            raise ShardingError(
                f"a value of shape {tuple(x.shape)} for a layout of shape "
                f"{layout.shape}")
        shards = [torch.empty(layout.block_shape(k), dtype=x.dtype,
                              device=dev)
                  for k, dev in enumerate(layout.devices)]
        placed = cls(layout, shards)
        placed.write(x)
        return placed

    @property
    def shape(self):
        return self.layout.shape

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    def full(self, out=None):
        """The logical value (into ``out`` when given), gathered from one
        shard of every distinct block."""
        if out is None:
            out = torch.empty(self.shape, dtype=self.dtype,
                              device=self.device)
        with torch.no_grad():
            for src, dst in block_copies(self.layout, self.shards,
                                         _Whole(out), [out]):
                dst.copy_(src, non_blocking=True)
        return out

    def write(self, x):
        """Copy the logical value ``x`` into every shard, in place."""
        x = torch.as_tensor(x)
        with torch.no_grad():
            for src, dst in block_copies(_Whole(x), [x], self.layout,
                                         self.shards):
                dst.copy_(src.to(dst.dtype), non_blocking=True)

    def nbytes(self):
        """Bytes held at each position, in mesh order."""
        return [s.numel() * s.element_size() for s in self.shards]

    def __repr__(self):
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.layout.spec}, positions={len(self.shards)})")


class _Whole:
    """The layout of an unplaced tensor: one position holding it all."""

    def __init__(self, x):
        self.shape = tuple(x.shape)
        self.blocks = [tuple((0, n) for n in self.shape)]
        self.devices = [x.device]


def _local(ranges, block):
    return tuple(slice(a - b0, b - b0) for (a, b), (b0, _) in
                 zip(ranges, block))


def _same_memory(a, b):
    return (a.device == b.device and a.data_ptr() == b.data_ptr()
            and a.shape == b.shape and a.stride() == b.stride())


def block_copies(src_layout, src, dst_layout, dst):
    """``[(source view, target view)]``: the copies that fill every block
    of ``dst`` (tensors in ``dst_layout``'s position order) from the
    blocks of ``src``. Each target block takes each region from one source
    block: the position's own first (where both layouts span the same
    positions), then one on the same device, then the first in mesh
    order. A region that already is the same memory is left out."""
    pairs = []
    n_src = len(src_layout.blocks)
    for q, (qblock, qt) in enumerate(zip(dst_layout.blocks, dst)):
        qdev = dst_layout.devices[q]
        order = sorted(range(n_src), key=lambda p: (
            not (n_src == len(dst_layout.blocks) and p == q),
            src_layout.devices[p] != qdev, p))
        taken = set()
        for p in order:
            pblock = src_layout.blocks[p]
            if pblock in taken:
                continue
            inter = []
            for (a0, a1), (b0, b1) in zip(pblock, qblock):
                lo, hi = max(a0, b0), min(a1, b1)
                if lo >= hi:
                    inter = None
                    break
                inter.append((lo, hi))
            if inter is None:
                continue
            taken.add(pblock)
            sv = src[p][_local(inter, pblock)]
            dv = qt[_local(inter, qblock)]
            if not _same_memory(sv, dv):
                pairs.append((sv, dv))
    return pairs


def shard_params(params, mesh, spec_fn=None):
    """Lay Gluon Parameters (dict name -> Parameter) out on a mesh.

    Default: replicated (pure data parallelism, one copy a position).
    ``spec_fn(name, shape)`` may return a PartitionSpec to shard a
    parameter. Each parameter keeps one contiguous allocation a position
    (a :class:`Placed`) beside its logical value, which the forward reads
    and the optimizer's update gathers back (gluon/parameter.py); its
    gradient reaches the positions in the update (gluon/_sharded.py).

    ``mesh`` may be a built Mesh or an axes spec ({'dp': -1} /
    (('dp', -1),)): specs go through :func:`make_mesh`, so -1 sizes infer
    from the card count. A spec that shards a dimension not divisible by
    its mesh axis raises :class:`ShardingError` naming the param and
    spec."""
    if not isinstance(mesh, Mesh):
        mesh = make_mesh(dict(mesh))
    for name, p in params.items():
        if p._var is None:
            raise ValueError(f"parameter {name} is not initialized")
        spec = spec_fn(name, p.shape) if spec_fn is not None else None
        if spec is None:
            spec = PartitionSpec()
        elif not isinstance(spec, PartitionSpec):
            spec = PartitionSpec(*spec)
        _check_divisible(name, p.shape, spec, mesh)
        p._place(Layout(mesh, spec, p._var.shape))
    return mesh


def shard_batch(x, mesh, axis="dp"):
    """Shard an input batch over a mesh axis (leading dim): a
    :class:`Placed` under ``PartitionSpec(axis)``, each position holding
    its block of rows (replicas along the other axes). Takes a tensor or
    an NDArray."""
    data = getattr(x, "_data", x)
    spec = PartitionSpec(axis)
    _check_divisible("batch", tuple(data.shape), spec, mesh)
    return Placed.from_tensor(data.detach(), Layout(mesh, spec, data.shape))
