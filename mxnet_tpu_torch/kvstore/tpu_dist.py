"""``kvstore='tpu_dist'``: the distributed store over ``torch.distributed``
(counterpart of mxnet_tpu/kvstore/tpu_dist.py).

The JAX package sums across processes with XLA collectives after
``jax.distributed.initialize``. Here each process of a job launched by
``mxnet_tpu_torch/tools/launch.py`` joins one ``torch.distributed``
process group (:func:`init_distributed_from_env`), and a pushpull sums a
key's copies in the process, then across processes with ``all_reduce``.

The backend is decided from the topology before the group is made, never
after a failure (:func:`choose_backend`): NCCL for CUDA tensors, gloo for
CPU ones (``"cuda:nccl,cpu:gloo"``), when every local rank has a card of
its own; gloo alone when there is no card or the local ranks outnumber the
cards (NCCL refuses two ranks on one card; gloo takes CUDA tensors through
host memory). A collective that fails raises; no other backend takes over.

The list-form pushpull of several processes concatenates the keys' sums
into dtype-homogeneous flat buckets of ``MXTPU_FUSED_BUCKET_MB`` and runs
one ``all_reduce`` a bucket (``parallel/collectives.py:_flat_buckets``),
where the JAX package reduces key by key there (its fused path returns
False with more than one process): the sums are the same up to the order
of the additions. In one process a key's copies are summed where they
are (the JAX package concatenates them first: elementwise, the same
sums), and a single copy needs no dispatch, only the write-back. Every
write-back bumps the out's ``_version``, which the Trainer's
stale-gradient test reads.

Over a mesh of positions (parallel/mesh.py): ``set_sharding_plan`` adopts
the Trainer's plan, whose mesh and data axis then default
``allreduce_sharded`` (the bucketed flat psum of whole tensors split over
the axis, ``collectives.psum_tree_flat``; ``psum_tree`` without
``MXTPU_FUSED_UPDATE``) and whose ZeRO axis defaults
``reduce_scatter_sharded`` (``collectives.reduce_scatter`` a leaf); both
sum over this process's positions, as one process drives every position.
``traced_allreduce`` is the sum a captured ``gluon.TrainStep`` makes of its
positions' gradients (``collectives.psum_tree_flat_traced``), then, with
several processes, over the processes through the flat buckets.
"""
from __future__ import annotations

import atexit
import os
import time

import torch

from .. import env as _env
from ..diagnostics import spans as _spans
from ..telemetry import instruments as _telemetry
from .base import KVStoreBase, _aslist, _copy_sum

__all__ = ["TPUDist", "P3Store", "init_distributed_from_env",
           "choose_backend"]

_NCCL = "cuda:nccl,cpu:gloo"


def _dist():
    import torch.distributed as dist

    return dist


def choose_backend(local_ranks, cards):
    """The process group's backend for ``local_ranks`` processes on a host
    with ``cards`` CUDA cards: NCCL for CUDA tensors (gloo for CPU ones)
    when each local rank has a card of its own, else gloo."""
    if cards == 0 or local_ranks > cards:
        return "gloo"
    return _NCCL


def init_distributed_from_env():
    """Join the process group that the port's launcher describes
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; ``MXTPU_NUM_WORKERS`` and
    ``MXTPU_WORKER_RANK`` where torch's are absent). The job's store is
    the launcher's when it sets ``MXTPU_LAUNCHER_STORE=1`` (every rank a
    client), else rank 0's. A no-op for one process, without an address,
    or when a group exists. The group it makes is destroyed at exit
    (gloo's threads may abort the process when the interpreter tears them
    down)."""
    dist = _dist()
    n = int(os.environ.get("WORLD_SIZE",
                           os.environ.get("MXTPU_NUM_WORKERS", "1")))
    if n <= 1 or dist.is_initialized():
        return
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not addr or not port:
        return
    rank = int(os.environ.get("RANK",
                              os.environ.get("MXTPU_WORKER_RANK", "0")))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", str(n)))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = choose_backend(local_ranks, cards)
    if backend == _NCCL:
        torch.cuda.set_device(local_rank)
    elif cards:
        torch.cuda.set_device(local_rank % cards)
    hosted = os.environ.get("MXTPU_LAUNCHER_STORE") == "1"
    store = dist.TCPStore(addr, int(port), n,
                          is_master=rank == 0 and not hosted)
    dist.init_process_group(backend, store=store, world_size=n, rank=rank)
    atexit.register(_destroy)


def _destroy():
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def _nbytes(t):
    return t.numel() * t.element_size()


def _write_back(o, data):
    """``data`` into the NDArray ``o``: in place where shape, dtype and
    device agree (a parameter's gradient buffer keeps its storage), else
    as a new tensor on ``o``'s device; ``o._version`` moves either way."""
    t = o._data
    if t is not data:
        if t.shape == data.shape and t.dtype == data.dtype and \
                t.device == data.device:
            with torch.no_grad():
                t.copy_(data)
        else:
            o._data = data.to(t.device, copy=True)
    o._version += 1


class TPUDist(KVStoreBase):
    """``kvstore='tpu_dist'``: sums over every copy in the process and over
    every process of the group."""

    def __init__(self, devices=None):
        init_distributed_from_env()
        self._devices = devices
        self._optimizer = None
        self._sharding_plan = None   # set by the Trainer
        if self.num_workers > 1:
            # meet every rank now, while they are close together: a later
            # first collective may follow long per-rank set-up
            self.barrier()

    # -- topology ----------------------------------------------------------
    @property
    def rank(self):
        dist = _dist()
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def num_workers(self):
        dist = _dist()
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def backend(self):
        """The process group's backend (``"gloo"``, or
        ``"cuda:nccl,cpu:gloo"`` as torch reports it), None without a
        group."""
        dist = _dist()
        return str(dist.get_backend()) if dist.is_initialized() else None

    @property
    def num_devices(self):
        return len(self._devices) if self._devices else 1

    def is_capable(self, capability):
        return capability in ("optimizer", "pushpull", "broadcast")

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, t):
        """``t`` summed over the processes, in place."""
        _dist().all_reduce(t)
        return t

    def allreduce_flat(self, tensors):
        """``tensors`` summed over the processes through dtype-homogeneous
        flat buckets of ``MXTPU_FUSED_BUCKET_MB``, one ``all_reduce`` a
        bucket; new tensors of the same shapes, in order."""
        from ..parallel.collectives import _flat_buckets

        cap = int(_env.get("MXTPU_FUSED_BUCKET_MB")) << 20
        out = [None] * len(tensors)
        for bucket in _flat_buckets(tensors, cap):
            flat = self._all_reduce(torch.cat(
                [tensors[j].reshape(-1) for j in bucket]))
            off = 0
            for j in bucket:
                n = tensors[j].numel()
                out[j] = flat[off:off + n].view(tensors[j].shape)
                off += n
            _telemetry.record_fused_bucket("allreduce", len(bucket))
        return out

    def pushpull(self, key, value, out=None, priority=0):
        """Sum ``value``'s copies in this process and across processes and
        write the sum into each out (module note)."""
        keys = _aslist(key)
        if len(keys) != 1:
            self._pushpull_list(keys, value, out)
            return
        t0 = time.perf_counter()
        vals = _aslist(value)
        with _spans.span("kv.pushpull", cat="collective"):
            vals = self._compress_vals(str(keys[0]), vals)
            total = _copy_sum([v._data for v in vals])
            if self.num_workers > 1:
                # a copy: ``total`` may be the pushed value itself
                total = self._all_reduce(total.clone())
        _telemetry.record_collective(
            "pushpull", sum(_nbytes(v._data) for v in vals),
            time.perf_counter() - t0)
        if out is not None:
            for o in _aslist(out):
                _write_back(o, total)

    def _pushpull_list(self, keys, values, outs):
        """The list form in one pass (module note): each key compressed and
        its copies summed, then, across processes, one ``all_reduce`` a
        flat bucket; the sums written into the outs that are given."""
        outs = outs if outs is not None else [None] * len(keys)
        t0 = time.perf_counter()
        with _spans.span("kv.pushpull", cat="collective"):
            vals_lists = [self._compress_vals(str(k), _aslist(v))
                          for k, v in zip(keys, values)]
            # one copy a key in one process: no sum, the write-back alone
            sums = [_copy_sum([v._data for v in vl]) for vl in vals_lists]
            if self.num_workers > 1:
                sums = self.allreduce_flat(sums)
            for red, o in zip(sums, outs):
                for oo in _aslist(o) if o is not None else ():
                    _write_back(oo, red)
        _telemetry.record_collective(
            "pushpull", sum(_nbytes(v._data) for vl in vals_lists
                            for v in vl), time.perf_counter() - t0)

    def allgather_rows(self, ids):
        """Every process's row ids (a 1-D int64 CPU tensor, or None where a
        forward recorded none) concatenated in rank order, so that every
        process applies a row-sparse update over the same rows: the rows
        any process touched, where the summed gradient may be nonzero.
        None when a process passed None (each then updates densely).
        ``ids`` itself in one process."""
        if self.num_workers <= 1:
            return ids
        dist = _dist()
        t0 = time.perf_counter()
        with _spans.span("kv.allgather_rows", cat="collective"):
            # CPU tensors: gloo carries them under either backend
            size = torch.tensor([-1 if ids is None else ids.numel()])
            sizes = [torch.empty_like(size) for _ in range(self.num_workers)]
            dist.all_gather(sizes, size)
            sizes = [int(n) for n in sizes]
            if min(sizes) < 0:
                return None
            buf = torch.zeros(max(sizes), dtype=torch.int64)
            buf[:sizes[self.rank]] = ids
            got = [torch.empty_like(buf) for _ in sizes]
            if buf.numel():
                dist.all_gather(got, buf)
            merged = torch.cat([g[:n] for g, n in zip(got, sizes)])
        _telemetry.record_collective("allgather_rows", 8 * merged.numel(),
                                     time.perf_counter() - t0)
        return merged

    def barrier(self):
        """Return once every worker has reached this point (a one-element
        sum over the processes); a no-op in one process. The checkpoint
        manager fences rank 0's commits with it."""
        if self.num_workers <= 1:
            return
        t0 = time.perf_counter()
        with _spans.span("kv.barrier", cat="collective"):
            # a CPU tensor: gloo carries it under either backend
            self._all_reduce(torch.zeros(1))
        _telemetry.record_collective("barrier", 4, time.perf_counter() - t0)

    def broadcast(self, key, value, out, priority=0):  # noqa: ARG002
        """Rank 0's ``value`` into every out of every process."""
        t0 = time.perf_counter()
        with _spans.span("kv.broadcast", cat="collective"):
            src = _aslist(value)[0]._data
            if self.num_workers > 1:
                src = src.detach().clone()
                _dist().broadcast(src, 0)
            for o in _aslist(out):
                _write_back(o, src)
        _telemetry.record_collective("broadcast", _nbytes(src),
                                     time.perf_counter() - t0)

    # -- over a mesh of positions ---------------------------------------------
    def allreduce_sharded(self, arrays, mesh=None, axis="dp"):
        """Allreduce a pytree of tensors split batch-first over a mesh axis
        (tpu_dist.py:318): each leaf's blocks summed. Mesh and axis default
        from the adopted plan; ``MXTPU_FUSED_UPDATE`` (the default) takes
        the bucketed flat sum, one sum a bucket."""
        from ..parallel import collectives

        if mesh is None and self._sharding_plan is not None:
            mesh = self._sharding_plan.mesh
            axis = self._sharding_plan.batch_axis
        if _env.get("MXTPU_FUSED_UPDATE"):
            return collectives.psum_tree_flat(arrays, mesh=mesh, axis=axis)
        return collectives.psum_tree(arrays, mesh=mesh, axis=axis)

    def reduce_scatter_sharded(self, arrays, mesh=None, axis=None):
        """Reduce-scatter a pytree along the plan's ZeRO axis
        (tpu_dist.py:335): each position keeps the summed block of every
        leaf that the ZeRO state layout assigns it. Mesh and axis default
        from the adopted plan's mesh and ``zero_axis()``; raises without
        them."""
        if mesh is None and self._sharding_plan is not None:
            mesh = self._sharding_plan.mesh
        if axis is None and self._sharding_plan is not None:
            axis = self._sharding_plan.zero_axis()
        if mesh is None or axis is None:
            raise ValueError(
                "reduce_scatter_sharded needs a mesh and a ZeRO axis: "
                "pass them explicitly or set_sharding_plan() a plan "
                "whose zero_axis() is not None (fsdp axis present and "
                "MXTPU_ZERO on)")
        from ..parallel import collectives

        leaves, rebuild = collectives._flatten(arrays)
        return rebuild([collectives.reduce_scatter(v, mesh, axis=axis)
                        for v in leaves])

    def set_sharding_plan(self, plan):
        """Adopt a ShardingPlan (the Trainer calls this): its mesh and data
        axis default ``allreduce_sharded``, its ``zero_axis()``
        ``reduce_scatter_sharded``."""
        self._sharding_plan = plan

    def traced_allreduce(self, tree, axis="dp", bucket_mb=None):
        """The gradient sum inside a captured step (tpu_dist.py:360):
        ``tree`` is the list of the positions' pytrees along ``axis``; they
        are summed in position order in flat buckets
        (``collectives.psum_tree_flat_traced``) and, with several
        processes, over the processes a bucket at a time. Returns the
        positions' summed trees. No host read: a CUDA graph captures it
        (over NCCL across processes)."""
        from ..parallel import collectives

        sums = collectives.psum_tree_flat_traced(tree, axis, bucket_mb)
        if self.num_workers > 1:
            leaves, rebuild = collectives._flatten(sums[0])
            total = rebuild(self.allreduce_flat(leaves))
            sums = [total] * len(sums)
        return sums


# the reference's spelling: KVStoreBase.find('tpudist')
KVStoreBase.register(TPUDist)


class P3Store(TPUDist):
    """``kvstore='p3'``, priority-based propagation (tpu_dist.py:P3Store).

    A value of more than ``MXNET_KVSTORE_BIGARRAY_BOUND`` elements with
    several copies is reduced in chunks of that many, each chunk summed
    across processes on its own; the list form dispatches its keys in
    descending priority (``-index`` unless the caller gives priorities)."""

    def __init__(self, devices=None):
        super().__init__(devices)
        self._bound = _env.get("MXNET_KVSTORE_BIGARRAY_BOUND")

    def pushpull(self, key, value, out=None, priority=0):
        keys = _aslist(key)
        if len(keys) != 1:
            outs = out if out is not None else [None] * len(keys)
            if isinstance(priority, (list, tuple)):
                prios = list(priority)
                if len(prios) != len(keys):
                    raise ValueError(
                        f"priority list length {len(prios)} != {len(keys)}")
            elif priority:
                prios = [priority] * len(keys)
            else:
                prios = [-i for i in range(len(keys))]
            for i in sorted(range(len(keys)), key=lambda i: -prios[i]):
                self.pushpull(keys[i], value[i], outs[i], priority=prios[i])
            return
        vals = _aslist(value)
        size = int(vals[0].size)
        if size <= self._bound or len(vals) == 1:
            return super().pushpull(key, value, out, priority)
        t0 = time.perf_counter()
        # compression before slicing, as the delegated path compresses
        vals = self._compress_vals(str(keys[0]), vals)
        dev = vals[0]._data.device
        flats = [v._data.to(dev).reshape(-1) for v in vals]
        reduced = []
        for s in range(0, size, self._bound):
            chunk = _copy_sum([f[s:s + self._bound] for f in flats])
            if self.num_workers > 1:
                chunk = self._all_reduce(chunk)
            reduced.append(chunk)
        total = torch.cat(reduced).view(vals[0].shape)
        _telemetry.record_collective(
            "pushpull", sum(_nbytes(v._data) for v in vals),
            time.perf_counter() - t0)
        if out is not None:
            for o in _aslist(out):
                _write_back(o, total)


KVStoreBase.register(P3Store)
KVStoreBase.kv_registry["p3"] = P3Store  # the reference's spelling
