"""One training step as one CUDA graph (counterpart of
mxnet_tpu/gluon/train_step.py).

``step = TrainStep(net, loss_fn, trainer)`` then per batch ``loss =
step(x, y)`` replaces::

    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

The JAX package compiles that iteration into one donated ``jax.jit``
program. Here the same body (forward, loss, backward with ones as the head
gradient, the optimizer's device part) is captured, on the card, into one
``torch.cuda.CUDAGraph`` per batch signature (shapes, dtypes): the first
call of a signature runs the body eagerly on a side stream, as warm-up (the
kernels build, cuDNN and cuBLAS choose their algorithms); the second
captures it and replays it; every later call copies the batch into the
graph's static input buffers and replays. One launch of the host a step,
where the phased step issues one per kernel. All signatures share one
memory pool. On the CPU the same body runs eagerly, in one call.

What a replay cannot see, the host does around it, in the reference's
order (its ``_whole``): the update counts, lr, wd and t of every trainable
parameter are resolved in trainer order before the body
(``Optimizer._resolve``, so schedules and Adam's t match the phased step),
turned into the ladder kernel's scalar rows (kernels/opt.py:ladder_scalars)
and copied to the card with one non-blocking copy from one of two pinned
buffers (an event keeps the host from refilling a buffer whose copy has
not run). The captured update reads them there
(kernels/opt.py:bucket_step_dev), so a changing LR or Adam's moving t never
needs a new capture. After the step the gradients are marked consumed and
``Trainer._record_step_complete`` closes it. The launch counters, which a
replay cannot bump (it runs no Python), take the capture's counts once per
replay (gluon/_graph.py). The attention layers advance their
dropout seeds on the card, and the Dropout layers' generators are
registered with the graph, so every replay draws new masks.

The graph keeps the addresses it captured. Weights, f32 masters and
optimizer states are updated in place and keep their storage; the
gradients the capture allocated stay the parameters' gradient buffers
(``Parameter.grad()`` shows each replay's). ``Block.load_parameters`` and
``Trainer.load_states`` copy into the existing weights and states, so the
graph keeps replaying, on the loaded values and with the loaded update
counts, as the JAX package's step reads the trainer's states on every
call. Replacing a weight's or a state's storage (``cast``, a load that
creates the states or changes their nesting, dtype or shape, assigning
``trainer._states[i]``) raises at the next replay: call
:meth:`TrainStep.rebuild`. The returned loss is a copy of the graph's
output.

An ineligible configuration runs phased and says why in
:meth:`TrainStep.ineligible_reason`, with the reference's reasons;
``MXTPU_WHOLE_STEP=0`` runs phased. On an eligible configuration on the
card a failed capture or replay raises; it never falls back.

Meshes and sharding plans, split as the JAX package splits them
(train_step.py:19-36). A trainer carrying a ShardingPlan makes its mesh
and batch axis this step's; an explicit ``mesh=``/``axis=`` keeps the
no-plan semantics (the parameters stay unplaced). Then:

  * a mesh whose plan shards no parameter (pure data parallelism, or an
    explicit mesh) runs the ``shard_map`` form: the batch splits over the
    data axis, each position's forward and backward take its shard (the
    loss must keep its batch dim), in position order on the parameters'
    device (one replica computes for all), and the gradients are summed in
    position order by the store's ``traced_allreduce`` or
    ``parallel.collectives.psum_tree_flat_traced``; parameters the forward
    writes (running statistics) take the mean of the positions' values.
    Each position's forward draws its own dropout noise, in position order
    (the JAX package hands every shard one key);
  * a plan that shards parameters (fsdp/tp) runs the GSPMD form: the
    logical forward and backward over the whole batch, as unplaced.

Under a plan the update then runs over every position's blocks
(gluon/_sharded.py): each position's slice of every gradient, K3 over
every position's blocks (``ceil(parameters x positions / 384)`` launches
a bucket), the blocks gathered back into the logical weights. The capture
holds all of it, so a planned step is one graph replay too.
:meth:`TrainStep.rebuild` re-adopts the trainer's plan after
``Trainer.set_sharding_plan`` (elastic re-entry): the next call of a
signature warms up and captures again.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from .. import env as _env
from ..kernels import opt as _kopt
from ..ndarray.ndarray import NDArray
from ..parallel.collectives import psum_tree_flat_traced
from ..parallel.mesh import Mesh, ShardingError
from . import _graph, _sharded
from . import block as _block
from .block import HybridBlock

__all__ = ["TrainStep"]


def _unwrap(a):
    return a._data if isinstance(a, NDArray) else a


class _Graph:
    """One captured step: the shared static graph (gluon/_graph.py), the
    scalar rows it reads and their pinned staging buffers, the gradient
    buffers the capture allocated, and the storage and hyperparameters it
    captured."""

    def __init__(self, step, inputs, n_rows, device):
        self.static = _graph.StaticGraph(inputs, device,
                                         step._generators(device))
        self.scalars = torch.zeros((n_rows, _kopt.SCALAR_STRIDE),
                                   dtype=torch.float32, device=device)
        self.pinned = [torch.zeros((n_rows, _kopt.SCALAR_STRIDE),
                                   dtype=torch.float32, pin_memory=True)
                       for _ in range(2)]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0
        self.loss = None
        self.grads = None
        self.storage = step._storage()
        self.hyper = step._static_hyper()

    def capture(self, step, stream):
        versions = [p._grad_version for _, p in step._items]
        self.loss = self.static.capture(
            lambda inputs: step._body(inputs, self.scalars), stream,
            pool=step._pool)
        # the gradient hooks the capture ran land nothing until a replay
        for (_, p), v in zip(step._items, versions):
            p._grad_version = v
        self.grads = [p._grad for _, p in step._items]

    def replay(self, step, inputs, rows):
        if step._storage() != self.storage:
            raise RuntimeError(
                "TrainStep: a weight or optimizer state changed storage "
                "since the step was captured (cast, a state replaced); "
                "call rebuild() to capture again")
        if step._static_hyper() != self.hyper:
            raise RuntimeError(
                "TrainStep: the optimizer's momentum, betas, epsilon or "
                "clip_gradient changed since the step was captured; call "
                "rebuild() to capture again")
        k = self.turn
        self.turn = 1 - k
        self.copied[k].synchronize()   # this buffer's previous copy ran
        self.pinned[k].numpy()[...] = rows
        self.scalars.copy_(self.pinned[k], non_blocking=True)
        self.copied[k].record()
        self.static.replay(inputs)
        for (_, p), g in zip(step._items, self.grads):
            p._grad = g
            p._grad_version += 1
        return self.loss.clone()


class TrainStep:
    """One training iteration: forward, loss, backward and the fused
    optimizer update, as one CUDA graph replay a step on the card.

    ``net`` is a HybridBlock; ``loss_fn(out, *labels)`` maps the network
    output and the remaining batch elements to a loss (None: the net's
    output is the loss). The first ``n_data`` positional batch elements
    feed the net, the rest the loss. ``batch_size`` defaults to the first
    input's ``batch_axis`` extent and sets ``rescale_grad = scale /
    batch_size``, as ``Trainer.step`` does. Batch elements may be tensors
    or NDArrays; the loss comes back as the same kind, detached.

    ``mesh=`` (a ``parallel.mesh.Mesh``) and ``axis=`` run the shard_map
    form with the parameters unplaced; without them the trainer's plan, if
    any, decides (module note)."""

    def __init__(self, net, loss_fn, trainer, *, n_data=1, batch_axis=0,
                 mesh=None, axis="dp"):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"TrainStep(mesh=...) takes a parallel.mesh.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        self._net = net
        self._loss = loss_fn
        self._trainer = trainer
        self._n_data = int(n_data)
        self._batch_axis = int(batch_axis)
        self._traces = 0
        self._last_path = None
        self._pool = None
        self._stream = None
        self.rebuild(mesh, axis)

    # -- introspection -----------------------------------------------------
    @property
    def last_path(self):
        """'whole_step' or 'phased': how the most recent call ran."""
        return self._last_path

    def jit_trace_count(self):
        """Step bodies built so far: CUDA-graph captures on the card, first
        runs of a batch signature on the CPU (the JAX package's whole-step
        compiles). A changing LR or Adam's t adds none."""
        return self._traces

    def ineligible_reason(self):
        """Why this step runs phased (None when eligible)."""
        return self._ineligible

    def rebuild(self, mesh=None, axis="dp"):
        """Drop the captured graphs and the cached eligibility verdict and
        re-adopt the trainer's (possibly new) plan (train_step.py:158): the
        next call of a signature warms up and captures again
        (:meth:`jit_trace_count` keeps counting). An explicit ``mesh=``
        keeps the no-plan semantics, as in the constructor."""
        self._plan = None
        if mesh is None:
            plan = getattr(self._trainer, "sharding_plan", None)
            if plan is not None:
                self._plan = plan
                mesh = plan.mesh
                axis = plan.batch_axis
        self._mesh = mesh
        self._axis = axis
        self._form = "local"
        self._graphs = {}
        self._warm = set()
        self._seen = set()
        self._built = False
        self._eligibility_checked = False
        self._ineligible = None
        return self

    # -- eligibility -------------------------------------------------------
    def _check_eligibility(self):
        tr = self._trainer
        opt = tr._optimizer
        if not isinstance(self._net, HybridBlock):
            return "net is not a HybridBlock"
        if not opt._supports_fused():
            return (f"{type(opt).__name__} overrides update/"
                    "update_multi_precision or lacks _rule")
        if opt.clip_global_norm is not None:
            return "clip_global_norm needs the host-combined norm pre-pass"
        # the store's reasons, in the JAX package's words
        if tr._update_on_kvstore:
            return "update_on_kvstore runs the optimizer inside the store"
        kv = tr._kvstore
        if kv is not None:
            if getattr(kv, "_compression", None) is not None:
                return "gradient compression is eager-only"
            distributed = getattr(kv, "num_workers", 1) > 1
            if distributed and self._mesh is None:
                return "multi-worker kvstore without a mesh"
            if self._mesh is not None and \
                    not hasattr(kv, "traced_allreduce") and \
                    kv.is_capable("pushpull"):
                return f"kvstore {type(kv).__name__} has no traced reduce"
        block_params = {id(p) for p in self._net.collect_params().values()}
        seen = set()
        for p in tr._params:
            if p.grad_req == "null":
                continue
            if p.grad_req != "write":
                return (f"param {p.name}: grad_req={p.grad_req!r} "
                        "(grad accumulation is eager-only)")
            if getattr(p, "grad_stype", "default") != "default":
                return f"param {p.name}: sparse gradient"
            if id(p) not in block_params:
                return f"param {p.name} is not owned by the net"
            if id(p) in seen:
                return f"param {p.name} appears twice in the trainer"
            seen.add(id(p))
        # on the card the captured update launches the ladder kernel for
        # every parameter: a member only its plain version takes would
        # read its scalars on the host, which a capture cannot
        cls = type(opt)
        tr._maybe_apply_plan()
        for i, p in enumerate(tr._params):
            if p.grad_req == "null":
                continue
            w = p._tensor()
            tr._ensure_states(i, w)
            st = tr._states[i]
            if p._placement is not None:
                # a placed parameter updates block by block (_sharded.py)
                if not _sharded.fused_eligible(opt, p, st):
                    return (f"param {p.name}: {cls.__name__} does not "
                            f"update a placed parameter block by block")
                w, st = _sharded.update_block(
                    p, st, tr._sharding_plan, tr._param_names[i], 0)
            if not w.is_cuda:
                continue
            mp = opt._is_mp_state(w, st)
            outcome = _kopt._decide(cls, mp, w, st, w)
            if outcome != "kernel":
                return (f"param {p.name}: the optimizer ladder kernel does "
                        f"not take it under {cls.__name__} ({outcome})")
        if self._mesh is not None:
            # a plan that shards parameters runs the logical step over the
            # whole batch (the GSPMD form), any other mesh the per-position
            # shard_map form
            names_shapes = [(n, p.shape) for n, p in
                            zip(tr._param_names, tr._params)
                            if p.shape is not None]
            self._form = "gspmd" if self._plan is not None and \
                self._plan.shards_params(names_shapes) else "mesh"
        return None

    def _eligible(self):
        if not self._eligibility_checked:
            self._ineligible = self._check_eligibility()
            self._eligibility_checked = True
        return self._ineligible is None

    # -- build -------------------------------------------------------------
    def _ensure_initialized(self, inputs):
        """Complete deferred initialization with one predict-mode forward
        (no recording, no noise, no running-stat update)."""
        if any(p._is_deferred for p in self._net.collect_params().values()):
            with _ag.pause(), torch.no_grad():
                self._net(*inputs[:self._n_data])

    def _build(self):
        tr = self._trainer
        opt = tr._optimizer
        items = []
        for i, p in enumerate(tr._params):
            if p.grad_req == "null":
                continue
            tr._ensure_states(i, p._tensor())
            items.append((i, p))
        self._items = items
        self._indices = [i for i, _ in items]
        self._placed = None
        if any(p._placement is not None for _, p in items):
            # the update over every position's blocks (_sharded.py); its
            # members' rows, bucket after bucket
            self._placed = tr.placed_update(self._indices)
            self._order = list(self._placed.rows)
        else:
            keys = opt._bucket_keys([p._tensor() for _, p in items],
                                    [tr._states[i] for i, _ in items], True)
            buckets = {}
            for k, key in enumerate(keys):
                buckets.setdefault(key, []).append(k)
            # rows of the scalar buffer: bucket after bucket, trainer order
            # within one; each bucket a contiguous slice
            self._order, self._buckets = [], []
            for (_, mp), ks in buckets.items():
                start = len(self._order)
                self._order.extend(ks)
                self._buckets.append((mp, ks, start, len(self._order)))
        self._device = items[0][1]._tensor().device if items else None
        self._built = True

    def _storage(self):
        """What a captured graph depends on: each trainable weight's
        tensor and address, and each state's identity."""
        tr = self._trainer
        return (_graph.storage_fingerprint(p._var for _, p in self._items),
                [(id(tr._states[i]), id(p._placement))
                 for i, p in self._items])

    def _static_hyper(self):
        opt = self._trainer._optimizer
        return (dict(opt._hyper()), opt.clip_gradient)

    def _generators(self, device):
        """The net's noise generators on ``device``, each once."""
        gens = {}
        for gen in self._net._noise_generators():
            if gen.device == device:
                gens[id(gen)] = gen
        return list(gens.values())

    # -- the step body -----------------------------------------------------
    def _body(self, inputs, scalars):
        """Forward, loss, backward and the optimizer's device part over
        ``inputs`` (the batch tensors) with the scalar rows ``scalars``;
        returns the loss tensor, detached. What a graph captures."""
        if self._form == "mesh":
            loss = self._shard_fwd_bwd(inputs)
        else:
            loss = _unwrap(self._fwd_bwd(inputs)).detach()
        tr = self._trainer
        if self._placed is not None:
            self._placed.scatter()
            tr._optimizer._fused_device_rows(self._placed.row_buckets(),
                                             scalars)
            self._placed.finish()
            return loss
        items = self._items
        tr._optimizer._fused_device_rows(
            [(mp, [(items[k][1]._tensor(), tr._states[items[k][0]],
                    items[k][1].grad()) for k in ks], start, stop)
             for mp, ks, start, stop in self._buckets], scalars)
        return loss

    def _fwd_bwd(self, inputs):
        """Forward, loss and backward over ``inputs``; the loss."""
        args = [NDArray(t) for t in inputs] if self._nd else list(inputs)
        with _ag.record():
            out = self._net(*args[:self._n_data])
            loss = self._loss(out, *args[self._n_data:]) \
                if self._loss is not None else out
        _ag.backward(loss)
        return loss

    def _shard_fwd_bwd(self, inputs):
        """The shard_map form (module note): each data position's forward
        and backward over its shard of the batch, the gradients summed in
        position order, the running statistics averaged; the per-sample
        losses concatenated back in batch order."""
        n = self._mesh.shape[self._axis]
        ax = self._batch_axis
        for t in inputs:
            if t.dim() <= ax or t.shape[ax] % n:
                raise ShardingError(
                    f"batch dim {ax} of shape {tuple(t.shape)} is not "
                    f"divisible by mesh axis {self._axis} (size {n})")
        parts = [t.chunk(n, ax) for t in inputs]
        items = self._items
        frozen = [p for p in self._net.collect_params().values()
                  if p.grad_req == "null" and p._var is not None]
        before = [p._var.detach().clone() for p in frozen]
        after = []
        losses, trees = [], []
        for k in range(n):
            with torch.no_grad():
                for p, v in zip(frozen, before):
                    p._var.copy_(v)
            for _, p in items:
                p._grad = None
            loss = _unwrap(self._fwd_bwd([c[k] for c in parts])).detach()
            if loss.dim() == 0:
                raise ValueError(
                    "TrainStep with a mesh needs a per-sample loss (batch "
                    "dim kept) so shards concatenate back to the global "
                    "loss; got a scalar")
            losses.append(loss)
            trees.append([p.grad() for _, p in items])
            after.append([p._var.detach().clone() for p in frozen])
        kv = self._trainer._kvstore
        reduce_tree = getattr(kv, "traced_allreduce", None)
        sums = reduce_tree(trees, self._axis) if reduce_tree is not None \
            else psum_tree_flat_traced(trees, self._axis)
        for (_, p), g in zip(items, sums[0]):
            p._grad = g
        with torch.no_grad():
            for j, p in enumerate(frozen):
                total = after[0][j]
                for a in after[1:]:
                    total = total + a[j]
                p._var.copy_(total / n)
        return torch.cat(losses, ax if losses[0].dim() > ax else 0)

    def _rows(self, batch_size):
        """The host part of the update: ``rescale_grad``, then counts, lr,
        wd and t in trainer order, as the ladder's scalar rows."""
        tr = self._trainer
        opt = tr._optimizer
        opt.rescale_grad = tr._scale / batch_size
        steps = opt._resolve(self._indices)
        return _kopt.ladder_scalars(type(opt), opt._hyper(),
                                    opt.rescale_grad,
                                    [steps[k] for k in self._order])

    # -- execution ---------------------------------------------------------
    def __call__(self, *batch, batch_size=None):
        self._nd = any(isinstance(a, NDArray) for a in batch)
        tensors = [_unwrap(a) for a in batch]
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"TrainStep expects tensor or NDArray batch "
                                f"elements, got {type(t).__name__}")
        if batch_size is None:
            batch_size = tensors[0].shape[self._batch_axis]
        if not _env.get("MXTPU_WHOLE_STEP"):
            return self._phased(batch, batch_size)
        if not self._built:
            self._ensure_initialized(batch)
            # deferred parameters just took their shapes: the trainer's
            # plan, if any, can place them now
            self._trainer._maybe_apply_plan()
        if not self._eligible():
            return self._phased(batch, batch_size)
        if not self._built:
            self._build()
        return self._whole(tensors, batch_size)

    def _phased(self, batch, batch_size):
        """The three-phase sequence (record/forward+loss, backward,
        Trainer.step): the fallback contract and the reference semantics
        the whole step is held against."""
        self._last_path = "phased"
        self._trainer._maybe_apply_plan()
        with _ag.record():
            out = self._net(*batch[:self._n_data])
            loss = self._loss(out, *batch[self._n_data:]) \
                if self._loss is not None else out
        _ag.backward(loss)
        self._trainer.step(batch_size)
        loss = _unwrap(loss).detach()
        return NDArray(loss) if self._nd else loss

    def _whole(self, tensors, batch_size):
        self._last_path = "whole_step"
        tr = self._trainer
        rows = self._rows(batch_size)
        sig = (self._nd,) + tuple((tuple(t.shape), t.dtype) for t in tensors)
        if self._device is None or self._device.type != "cuda":
            if sig not in self._seen:
                self._seen.add(sig)
                self._traces += 1
            loss = self._body(tensors, torch.from_numpy(rows))
        else:
            loss = self._cuda_step(sig, tensors, rows)
        tr._mark_grads_consumed(self._indices)
        tr._record_step_complete(batch_size)
        return NDArray(loss) if self._nd else loss

    def _cuda_step(self, sig, tensors, rows):
        _block.check_no_op_hooks(self._net, "gluon.TrainStep's CUDA graph")
        dev = self._device
        graph = self._graphs.get(sig)
        if graph is not None:
            return graph.replay(self, tensors, rows)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self._stream.wait_stream(current)
        if sig not in self._warm:
            # warm-up: the body eagerly, on the side stream the capture
            # will use (builds, cuBLAS workspaces, cuDNN's choices)
            with torch.cuda.stream(self._stream):
                scalars = torch.from_numpy(rows).to(dev)
                loss = self._body([t.to(dev) for t in tensors], scalars)
            current.wait_stream(self._stream)
            self._warm.add(sig)
            return loss
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = _Graph(self, tensors, len(self._order), dev)
        graph.capture(self, self._stream)
        self._traces += 1
        self._graphs[sig] = graph
        return graph.replay(self, tensors, rows)
