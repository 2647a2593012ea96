"""Gluon Trainer (counterpart of mxnet_tpu/gluon/trainer.py).

Applies an Optimizer to a set of Parameters, each on one device, with the
gradients summed through a KVStore (``kvstore=``: a name of
``kvstore.create`` or a store). ``allreduce_grads`` hands every gradient
to the store in one list-form pushpull under ``MXTPU_FUSED_UPDATE`` (the
default), else one pushpull a parameter in descending priority ``-i``;
the store writes the sums back into the gradient buffers, and each write
counts as a fresh gradient. A single copy and a local store need no
reduce. Across processes a row-sparse parameter is updated over the rows
that any process touched. ``compression_params=`` goes to the store;
``update_on_kvstore=True`` hands the store the optimizer, and the Trainer
still updates locally, as the JAX package's does.

``sharding_plan=`` (a ``sharding.ShardingPlan``) or ``mesh=`` (its axes
shorthand, or a built ``parallel.mesh.Mesh``) places every parameter and
its optimizer state by the plan once all parameters are initialized
(``_maybe_apply_plan``; ``sharding.resolve_plan`` folds in MXTPU_MESH and
MXTPU_SHARDING, and None keeps every path below as it was): each
parameter keeps one block a position beside its logical value, its state
one block a position under the plan's state spec (ZeRO), and ``update``
runs the optimizer over every position's blocks (gluon/_sharded.py). A
rule whose update is not elementwise (LAMB, LANS, LARS), an optimizer
without a fused rule, or a row-sparse gradient updates the logical value
and writes it through to the positions. ``set_sharding_plan`` moves a
live trainer onto another plan (elastic re-entry).

``save_states`` / ``load_states`` read and write the JAX package's format-2
pickle (mxnet_tpu/gluon/trainer.py:save_states): the states as numpy
leaves, nested in lists, bf16 leaves through ``_dtype_codec`` (read without
``ml_dtypes``), the optimizer's bookkeeping (``num_update`` and each
parameter's ``t``), each parameter's name and dtype name, the stale
gradients and the loss scale. A load copies into the state tensors that
exist with the same nesting, shapes and dtypes, so the state objects and
their storage stay (a captured ``gluon.TrainStep`` replays on the loaded
values), and creates the others on the parameter's device.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, updates
each parameter with a row-sparse gradient (``grad_stype='row_sparse'``)
alone over the rows its forwards touched, and hands every other parameter
with a fresh gradient to the Optimizer in one list-form call
(``update_fused`` for every rule that has a ``_rule``), which updates
weights and states in place. Each step ends in
``_record_step_complete``, which ``gluon.TrainStep`` calls too.
"""
from __future__ import annotations

import pickle
import time

import numpy as _np
import torch

from .. import env as _env
from .. import optimizer as opt_mod
from .._dtype_codec import dtype_name, pickle_leaf, pickle_load
from ..diagnostics import spans as _spans
from ..kvstore import KVStoreBase, create as kv_create
from ..ndarray.ndarray import NDArray
from ..parallel.mesh import Placed
from . import _sharded
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None, kvstore=None,
                 compression_params=None, update_on_kvstore=None,
                 batch_axis=0, mesh=None, sharding_plan=None):  # noqa: ARG002
        if isinstance(params, dict):
            param_list = [params[k] for k in sorted(params)]
            self._param_names = sorted(params)
        elif isinstance(params, (list, tuple)):
            param_list = list(params)
            self._param_names = [p.name for p in param_list]
        else:
            raise ValueError("params must be dict/list of Parameters")
        for p in param_list:
            if not isinstance(p, Parameter):
                raise ValueError(f"expected Parameter, got {type(p)}")
        self._params = param_list
        self._scale = 1.0
        optimizer_params = optimizer_params or {}
        self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        if isinstance(kvstore, KVStoreBase):
            self._kvstore = kvstore
        elif isinstance(kvstore, str) and kvstore != "None":
            self._kvstore = kv_create(kvstore)
        else:
            self._kvstore = None
        if compression_params is not None:
            if self._kvstore is None:
                raise ValueError("compression_params requires a kvstore")
            self._kvstore.set_gradient_compression(compression_params)
        self._update_on_kvstore = bool(update_on_kvstore) and \
            self._kvstore is not None
        if self._update_on_kvstore:
            self._kvstore.set_optimizer(self._optimizer)
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)
        # param index -> gradient version seen at its last update; a
        # matching version means the gradient is STALE (nothing was
        # backpropagated into it since)
        self._grad_versions = {}
        # host bookkeeping of completed steps (_record_step_complete)
        self._steps_completed = 0
        self._examples_completed = 0
        self._last_step_end = None
        self._last_step_seconds = None
        # hybrid parallelism (module note): resolve_plan returns None when
        # the subsystem is off or nothing names a mesh
        from ..sharding import resolve_plan

        self._sharding_plan = resolve_plan(
            sharding_plan if sharding_plan is not None else mesh)
        self._plan_applied = False
        self._placed_updates = {}
        if self._sharding_plan is not None and self._kvstore is not None:
            setter = getattr(self._kvstore, "set_sharding_plan", None)
            if setter is not None:
                setter(self._sharding_plan)
        self._maybe_apply_plan()

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def sharding_plan(self):
        """The resolved ShardingPlan, or None (unsharded)."""
        return self._sharding_plan

    def set_sharding_plan(self, plan):
        """Move this trainer onto a new ShardingPlan (or None: unplaced),
        the elastic re-entry hook (trainer.py:98): parameters are placed
        under the new plan at once when they are live, and created
        optimizer state under its state specs, so state held 1/N along one
        fsdp axis re-extends along the new one. A caller owning a TrainStep
        must also call its ``rebuild()``: the captured graph holds the old
        blocks."""
        self._sharding_plan = plan
        self._plan_applied = False
        self._placed_updates = {}
        if self._kvstore is not None:
            setter = getattr(self._kvstore, "set_sharding_plan", None)
            if setter is not None:
                setter(plan)
        if plan is None:
            for i, p in enumerate(self._params):
                p._unplace()
                if self._states_created[i]:
                    self._states[i] = opt_mod.place_state_like(
                        self._states[i], p)
            return
        self._maybe_apply_plan()
        if self._plan_applied:
            for i, p in enumerate(self._params):
                if self._states_created[i]:
                    self._states[i] = opt_mod.place_state_like(
                        self._states[i], p, plan=plan,
                        name=self._param_names[i])

    def _maybe_apply_plan(self):
        """Place every parameter per the plan once all are initialized
        (trainer.py:146): deferred-shape models initialize at their first
        forward, so ``step``/``update`` and TrainStep call this again; a
        no-op after the first application and without a plan."""
        plan = self._sharding_plan
        if plan is None or self._plan_applied:
            return
        if any(p._var is None for p in self._params):
            return
        plan.apply(dict(zip(self._param_names, self._params)),
                   label="trainer")
        self._plan_applied = True

    def _ensure_states(self, i, weight):
        if not self._states_created[i]:
            self._states[i] = self._optimizer.create_state_multi_precision(
                i, weight)
            self._states_created[i] = True
            if self._plan_applied:
                # state mirrors its weight: its placement, or the ZeRO
                # layout under a plan with a live fsdp axis
                self._states[i] = opt_mod.place_state_like(
                    self._states[i], self._params[i],
                    plan=self._sharding_plan, name=self._param_names[i])

    def allreduce_grads(self, ignore_stale_grad=False):
        """Sum the gradients through the kvstore (trainer.py:
        allreduce_grads): one list-form pushpull under
        ``MXTPU_FUSED_UPDATE``, else one a parameter in priority ``-i``
        (layer 0 first: its weights gate the next forward). A store that
        cannot pushpull, in one process, has nothing to sum over one copy.
        ``ignore_stale_grad`` skips a gradient untouched since its last
        update: summing it would add stale values and make it look
        fresh. Across processes, a row-sparse parameter's rows become
        those any process touched (``_merge_row_hints``)."""
        kv = self._kvstore
        if kv is None:
            return
        distributed = getattr(kv, "num_workers", 1) > 1 or \
            kv.is_capable("pushpull")
        if not distributed:
            return
        fused = _env.get("MXTPU_FUSED_UPDATE")
        keys, views = [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if ignore_stale_grad and \
                    self._grad_versions.get(i) == p._grad_version:
                continue
            view = NDArray(p.grad())
            if fused:
                keys.append(i)
                views.append(view)
            else:
                kv.pushpull(i, [view], out=[view], priority=-i)
                _land_sum(p, view, kv)
        if len(keys) == 1:
            kv.pushpull(keys[0], [views[0]], out=[views[0]], priority=0)
        elif keys:
            kv.pushpull(keys, [[v] for v in views],
                        out=[[v] for v in views], priority=0)
        for i, view in zip(keys, views):
            _land_sum(self._params[i], view, kv)

    def step(self, batch_size, ignore_stale_grad=False):
        """Optimizer update with the gradients scaled by 1/batch_size."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads(ignore_stale_grad)
        self.update(batch_size, ignore_stale_grad, _skip_rescale=True)
        self._record_step_complete(batch_size)

    def _record_step_complete(self, batch_size):
        """Close one training step on the host, for ``step()`` and
        ``gluon.TrainStep`` alike: close the step's span bucket
        (``diagnostics.spans.mark_step``, the step index a checkpoint
        saved without one takes), count it and its examples, and time the
        interval since the previous step's end (the whole iteration; the
        first step is counted, not timed). Telemetry reads these when it is
        ported."""
        _spans.mark_step()
        now = time.perf_counter()
        if self._last_step_end is not None:
            self._last_step_seconds = now - self._last_step_end
        self._last_step_end = now
        self._steps_completed += 1
        self._examples_completed += int(batch_size)

    def _mark_grads_consumed(self, indices):
        """Mark the gradients of the parameters ``indices`` stale, as an
        update does: what ``gluon.TrainStep`` records after a step whose
        update ran on the card without this trainer's Python."""
        for i in indices:
            self._grad_versions[i] = self._params[i]._grad_version

    def update(self, batch_size, ignore_stale_grad=False,
               _skip_rescale=False):
        if not _skip_rescale:
            self._optimizer.rescale_grad = self._scale / batch_size
        self._maybe_apply_plan()
        # every dense parameter goes to ONE list-form call, which buckets
        # by (dtype, multi-precision); placed ones update by position
        f_idx, f_w, f_g, f_s = [], [], [], []
        placed, logical = [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            # stale = gradient buffer untouched since the last update
            fresh = self._grad_versions.get(i) != p._grad_version
            if ignore_stale_grad and not fresh:
                continue
            w = p._tensor()
            self._ensure_states(i, w)
            self._grad_versions[i] = p._grad_version
            if p._placement is not None:
                (placed if _sharded.fused_eligible(
                    self._optimizer, p, self._states[i]) else
                 logical).append(i)
                continue
            if p.grad_stype == "row_sparse":
                # updated here, in list order as the JAX package does
                # (trainer.py:292): only the rows its forwards touched
                self._optimizer.update_multi_precision(
                    i, w, p._as_row_sparse_grad(p.grad()), self._states[i])
                continue
            f_idx.append(i)
            f_w.append(w)
            f_g.append(p.grad())
            f_s.append(self._states[i])
        if f_idx:
            self._optimizer.update_multi_precision(f_idx, f_w, f_g, f_s)
        if placed:
            self._update_placed(placed)
        for i in logical:
            self._update_logical(i)

    def placed_update(self, indices):
        """The :class:`~._sharded.PlacedUpdate` of the placed parameters
        ``indices``, listed again when a weight or a state was placed
        anew."""
        key = tuple(indices)
        upd = self._placed_updates.get(key)
        if upd is None or upd.key != _sharded.PlacedUpdate.storage_key(
                self, indices):
            upd = _sharded.PlacedUpdate(self, indices)
            upd.set_frozen([p for p in self._params
                            if p.grad_req == "null"])
            self._placed_updates[key] = upd
        return upd

    def _update_placed(self, indices):
        """The fused update over every position's blocks of ``indices``
        (gluon/_sharded.py): gradients handed out, lr/wd/t resolved once a
        parameter, the global-norm scale over the logical gradients (the
        buckets' membership and order of the unplaced step), K3 over the
        blocks, the blocks gathered back."""
        opt = self._optimizer
        upd = self.placed_update(indices)
        upd.scatter()
        steps = opt._resolve(indices)
        scale = 1.0
        if opt.clip_global_norm is not None:
            logical = {}
            for key, members in upd.buckets:
                js = sorted({j for j, *_ in members})
                logical[key] = [(None, None, upd.params[j].grad())
                                for j in js]
            scale = opt._global_norm_scale(logical)
        opt._fused_device(upd.members(steps), opt._fused_hyper(), scale)
        upd.finish()

    def _update_logical(self, i):
        """A placed parameter that cannot update block by block: its
        logical state gathered, the update on the logical value, both
        written through to the positions."""
        p = self._params[i]
        st = self._states[i]
        full = _sharded.full_state(st)
        g = p.grad()
        if p.grad_stype == "row_sparse":
            g = p._as_row_sparse_grad(g)
        self._optimizer.update_multi_precision(i, p._tensor(), g, full)
        p._placement.write(p._tensor())
        _sharded.write_state(st, full)

    def zero_grad(self):
        for p in self._params:
            if p.grad_req != "null" and p._var is not None:
                p.zero_grad()

    # -- checkpoint --------------------------------------------------------
    def _stale_indices(self):
        """Indices of the parameters whose gradient is stale (untouched
        since its last update): the portable form of ``_grad_versions``."""
        return [i for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._var is not None
                and self._grad_versions.get(i) == p._grad_version]

    def save_states(self, fname):
        """Write the optimizer side of a checkpoint (module note), as the
        JAX package's ``Trainer.save_states`` does and readable by it."""
        def to_np(s):
            if s is None:
                return None
            if isinstance(s, Placed):
                return pickle_leaf(s.full())
            if isinstance(s, torch.Tensor):
                return pickle_leaf(s)
            return [to_np(x) for x in s]

        payload = {
            "format": 2,
            "states": [to_np(s) for s in self._states],
            "created": list(self._states_created),
            "num_update": self._optimizer.num_update,  # format-1 readers
            "optimizer": self._optimizer.bookkeeping_state(),
            "param_meta": [(p.name, dtype_name(p.dtype))
                           for p in self._params],
            "stale": self._stale_indices(),
            "scale": self._scale,
        }
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def load_states(self, fname):
        """Inverse of :meth:`save_states`, for the port's files and the JAX
        package's. A payload whose parameter count or dtypes differ from
        this trainer's raises ``ValueError`` before anything is touched; a
        format-1 payload (no bookkeeping) still loads. States load in place
        where they exist alike (module note)."""
        with open(fname, "rb") as f:
            payload = pickle_load(f)
        states = payload["states"]
        if len(states) != len(self._params):
            raise ValueError(
                f"optimizer-state payload {fname!r} holds {len(states)} "
                f"parameter states but this trainer has "
                f"{len(self._params)} parameters: wrong model or stale "
                f"checkpoint")
        for i, (name, dt) in enumerate(payload.get("param_meta") or []):
            p = self._params[i]
            if dt is not None and dt != dtype_name(p.dtype):
                raise ValueError(
                    f"optimizer-state payload {fname!r}: param {i} "
                    f"({name!r}) was saved with dtype {dt}, trainer param "
                    f"{p.name!r} declares {dtype_name(p.dtype)}")
        states = [_state_tensors(s) for s in states]
        for i, s in enumerate(states):
            self._put_state(i, s)
        self._states_created = [bool(c) for c in payload["created"]]
        opt_state = payload.get("optimizer")
        if opt_state is not None:
            self._optimizer.load_bookkeeping_state(opt_state)
        else:
            self._optimizer.num_update = payload["num_update"]
        if "scale" in payload:
            self._scale = float(payload["scale"])
        if "stale" in payload:
            # stale again against this process's gradient versions
            self._grad_versions = {
                i: self._params[i]._grad_version for i in payload["stale"]
                if self._params[i].grad_req != "null"
                and self._params[i]._var is not None}

    def _put_state(self, i, state):
        """Parameter ``i``'s optimizer state becomes ``state`` (CPU
        tensors): copied into the existing state where it was created with
        the same nesting, shapes and dtypes, so the state objects keep their
        identity and storage; else put on the parameter's device."""
        cur = self._states[i]
        if self._states_created[i] and _fits(cur, state):
            with torch.no_grad():
                _copy_into(cur, state)
            return
        p = self._params[i]
        device = p.device if p._var is not None or p._deferred is not None \
            else None
        self._states[i] = _to_device(state, device)
        self._states_created[i] = True
        if self._plan_applied and p._placement is not None:
            self._states[i] = opt_mod.place_state_like(
                self._states[i], p, plan=self._sharding_plan,
                name=self._param_names[i])


def _land_sum(p, view, kv):
    """The store's write-back into ``view`` (an NDArray over ``p``'s
    gradient buffer) lands in the buffer, and each write counts as a new
    gradient version, as the JAX package's store bumps ``_version``."""
    if view._data is not p._grad:
        with torch.no_grad():
            p._grad.copy_(view._data)
    p._grad_version += view._version
    if p.grad_stype == "row_sparse" and getattr(kv, "num_workers", 1) > 1:
        _merge_row_hints(p, kv)


def _merge_row_hints(p, kv):
    """After the sum across processes, ``p``'s row-sparse update covers the
    rows that any process's forwards touched: a row only another process
    looked up has a nonzero summed gradient here too. If a process
    recorded no rows (a hybridized forward), every process updates
    densely. Each process keeps the same rows, so the ranks stay equal
    (the JAX package keeps its own rows only, and its ranks drift)."""
    hints = p._sparse_row_hints
    ids = torch.cat([h.to("cpu", torch.int64) for h in hints]) \
        if hints else None
    merged = kv.allgather_rows(ids)
    p._sparse_row_hints = [] if merged is None else [merged]


def _state_tensors(s):
    """A state of a payload as the port nests it: lists become tuples,
    numpy leaves CPU tensors."""
    if s is None:
        return None
    if isinstance(s, (list, tuple)):
        return tuple(_state_tensors(x) for x in s)
    if isinstance(s, torch.Tensor):
        return s
    return torch.from_numpy(_np.array(s))


def _fits(cur, new):
    if cur is None or new is None:
        return cur is None and new is None
    if isinstance(cur, Placed):
        return (isinstance(new, torch.Tensor)
                and tuple(new.shape) == cur.shape and new.dtype == cur.dtype)
    if isinstance(cur, torch.Tensor) or isinstance(new, torch.Tensor):
        return (isinstance(cur, torch.Tensor) and isinstance(new, torch.Tensor)
                and cur.shape == new.shape and cur.dtype == new.dtype)
    return len(cur) == len(new) and all(_fits(a, b)
                                        for a, b in zip(cur, new))


def _copy_into(cur, new):
    if isinstance(cur, Placed):
        cur.write(new)
    elif isinstance(cur, torch.Tensor):
        cur.copy_(new)
    elif cur is not None:
        for a, b in zip(cur, new):
            _copy_into(a, b)


def _to_device(s, device):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_to_device(x, device) for x in s)
    return s.to(device) if device is not None else s
