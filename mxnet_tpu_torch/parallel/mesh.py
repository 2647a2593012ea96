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

Laying parameters and batches over a mesh (``shard_params``,
``shard_batch``) is not ported yet: it raises. Data parallelism across
processes is ``kvstore='tpu_dist'``; on a mesh, ``data_parallel.py``.
"""
from __future__ import annotations

import collections

import numpy as _np
import torch

from .. import device as _device

__all__ = ["make_mesh", "Mesh", "PartitionSpec", "ShardingError",
           "data_parallel_mesh", "local_mesh", "split", "assemble"]


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


def _later(name):
    return NotImplementedError(
        f"{name} is not ported yet: a parameter lives on one device in the "
        f"port, and laying parameters or batches over a mesh waits for "
        f"ROADMAP.md, queue 1, item 9")


def shard_params(params, mesh, spec_fn=None):  # noqa: ARG001
    """Lay Gluon Parameters out on a mesh: not ported yet, raises."""
    raise _later("shard_params")


def shard_batch(x, mesh, axis="dp"):  # noqa: ARG001
    """Shard an input batch over a mesh axis: not ported yet, raises."""
    raise _later("shard_batch")
