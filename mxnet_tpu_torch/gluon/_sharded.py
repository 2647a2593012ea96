"""The optimizer's update of parameters that a sharding plan placed, a block
a position (what mxnet_tpu/gluon/train_step.py's GSPMD step and its eager
Trainer compute with the parameters and the optimizer state laid out by
``NamedSharding``).

A placed parameter (gluon/parameter.py) keeps its logical value, which the
forward and the backward read and write, and one block a mesh position
under ``plan.spec_for``; its optimizer state holds one block a position
under ``plan.state_spec_for`` (optimizer.place_state_like), the ZeRO
layout where the plan has a live fsdp axis. The state's block at a
position lies inside the weight's block there: ZeRO only cuts a dim the
weight keeps whole. One update, :class:`PlacedUpdate`:

  1. hands each position the slice of every logical gradient that its
     state covers, into a gradient buffer the position keeps (the
     reduce-scatter of the JAX package's step: one replica computed the
     whole batch's gradient, so the reduction is done);
  2. runs the optimizer's device part over every position's blocks at
     once: the members of a bucket are every position's (weight block,
     state blocks, gradient block), position after position, so K3 takes
     ``ceil(parameters x positions / 384)`` launches a bucket
     (kernels/opt.py: one table of at most 384 tensors a launch). The
     weight block K3 writes is a contiguous view of the position's weight
     shard where it is one, else a buffer of its own filled from the
     shard first. K3 is elementwise, so a block's update is bit for bit
     that block of the unplaced update;
  3. gathers: each position's weight shard takes the blocks its fsdp peers
     updated (the all-gather that closes the ZeRO cycle), then the logical
     value takes one shard of every distinct block, and parameters the
     optimizer does not update (BatchNorm's running statistics, which the
     forward writes into the logical value) are written back to their
     shards.

Every step is a copy or a K3 launch on tensors that keep their storage, and
nothing reads the host, so ``gluon.TrainStep`` captures the whole update
in its CUDA graph. The copies are listed once (``block_copies``); only the
gradient's, whose tensor a backward replaces, are listed again per call.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import Layout, Placed, _local, _Whole, block_copies

__all__ = ["PlacedUpdate", "state_at", "placed_leaves", "full_state",
           "write_state"]


def state_at(state, k):
    """The nest of ``state`` with each Placed leaf replaced by its block at
    position ``k``."""
    if state is None:
        return None
    if isinstance(state, Placed):
        return state.shards[k]
    if isinstance(state, torch.Tensor):
        return state
    return type(state)(state_at(s, k) for s in state)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (Placed, torch.Tensor)):
        return [state]
    return [x for s in state for x in _leaves(s)]


def placed_leaves(state):
    """The Placed leaves of a state nest, in order."""
    return [x for x in _leaves(state) if isinstance(x, Placed)]


def full_state(state):
    """The logical state: each Placed leaf gathered into a tensor."""
    if state is None:
        return None
    if isinstance(state, Placed):
        return state.full()
    if isinstance(state, torch.Tensor):
        return state
    return type(state)(full_state(s) for s in state)


def write_state(state, values):
    """Copy logical ``values`` (the same nesting) into ``state``'s leaves:
    through to every position of a Placed leaf, in place for a tensor."""
    if state is None:
        return
    if isinstance(state, Placed):
        state.write(values)
    elif isinstance(state, torch.Tensor):
        with torch.no_grad():
            state.copy_(values)
    else:
        for s, v in zip(state, values):
            write_state(s, v)


def fused_eligible(opt, param, state):
    """Whether ``param``'s placed update may run block by block: a fused
    rule whose update is elementwise (not LAMB/LANS/LARS, which take norms
    of the whole weight), every state leaf placed, a dense gradient."""
    return (opt._supports_fused() and type(opt)._row_local
            and param.grad_stype == "default"
            and all(isinstance(x, Placed)
                    and x.layout.shape == tuple(param.shape)
                    for x in _leaves(state)))


def update_layout(param, state, plan, name):
    """The layout of ``param``'s update: its state's, else the plan's
    state spec for it, else its weight's."""
    leaves = placed_leaves(state)
    if leaves:
        return leaves[0].layout
    w = param._placement.layout
    if plan is not None and plan.zero_axis() is not None:
        return Layout(w.mesh, plan.state_spec_for(name, w.shape), w.shape)
    return w


def update_block(param, state, plan, name, k):
    """Position ``k``'s weight block under ``param``'s update layout (a
    view of its shard) and its state blocks: what K3 updates there."""
    wl = param._placement.layout
    ul = update_layout(param, state, plan, name)
    return (param._placement.shards[k][_local(ul.blocks[k], wl.blocks[k])],
            state_at(state, k))


class PlacedUpdate:
    """One update of the placed parameters ``indices`` of ``trainer``
    (module note): the positions' blocks, their gradient buffers and the
    copies around K3, listed once. Rebuilt when a weight or a state is
    placed again (``key`` tells)."""

    def __init__(self, trainer, indices):
        plan = trainer._sharding_plan
        opt = trainer._optimizer
        self.indices = list(indices)
        self.params = [trainer._params[i] for i in indices]
        self.key = self.storage_key(trainer, indices)
        self._pre, self._exchange, self._gather = [], [], []
        self._gpieces, self._ulayouts = [], []
        blocks = []          # per parameter: [(w, st, g)] a position
        for i, p in zip(indices, self.params):
            placed = p._placement
            wl = placed.layout
            st = trainer._states[i]
            ul = update_layout(p, st, plan, trainer._param_names[i])
            if ul.shape != wl.shape or len(ul.blocks) != len(wl.blocks):
                raise ValueError(
                    f"parameter {p.name}: its state's layout {ul.spec} and "
                    f"its weight's {wl.spec} are not over one mesh")
            g_dtype = p._tensor().dtype
            pieces, gpieces = [], []
            for k, (ub, wb) in enumerate(zip(ul.blocks, wl.blocks)):
                if any(u0 < w0 or u1 > w1
                       for (u0, u1), (w0, w1) in zip(ub, wb)):
                    raise ValueError(
                        f"parameter {p.name}: the state block at position "
                        f"{k} is not inside the weight block there")
                view = placed.shards[k][_local(ub, wb)]
                if not view.is_contiguous():
                    own = torch.empty(view.shape, dtype=view.dtype,
                                      device=view.device)
                    self._pre.append((view, own))
                    view = own
                pieces.append(view)
                gpieces.append(torch.empty(ul.block_shape(k),
                                           dtype=g_dtype,
                                           device=ul.devices[k]))
            blocks.append([(w, state_at(st, k), g)
                           for k, (w, g) in enumerate(zip(pieces, gpieces))])
            self._exchange += block_copies(ul, pieces, wl, placed.shards)
            # views of the value's detached alias: a view of the leaf
            # itself would hold its gradient accumulator (made on this
            # stream) alive into every later backward
            value = p._tensor().detach()
            self._gather += block_copies(wl, placed.shards, _Whole(value),
                                         [value])
            self._gpieces.append(gpieces)
            self._ulayouts.append(ul)
        # bucket by (dtype, multi-precision) as update_fused does, position
        # after position within a bucket; ``rows`` names each member's
        # parameter (its row of the ladder's scalars)
        self.positions = len(blocks[0]) if blocks else 0
        keys = opt._bucket_keys([b[0][0] for b in blocks],
                                [b[0][1] for b in blocks], True)
        by_key = {}
        for j, key in enumerate(keys):
            by_key.setdefault(key, []).append(j)
        self.buckets = []    # [(key, [(j, w, st, g)])]
        for key, js in by_key.items():
            self.buckets.append((key, [(j, *blocks[j][k])
                                       for k in range(self.positions)
                                       for j in js]))
        self.rows = [j for _, members in self.buckets for j, *_ in members]
        self._frozen = []

    @staticmethod
    def storage_key(trainer, indices):
        """What the listed blocks and copies depend on: each weight's
        tensor and placement, each state's identity."""
        return tuple((id(trainer._params[i]._var),
                      id(trainer._params[i]._placement),
                      id(trainer._states[i])) for i in indices)

    def set_frozen(self, params):
        """Parameters the forward writes and no update reads (running
        statistics): their shards take the logical value at
        :meth:`finish`."""
        self._frozen = []
        for p in params:
            if p._placement is not None:
                t = p._tensor().detach()
                self._frozen += block_copies(_Whole(t), [t],
                                             p._placement.layout,
                                             p._placement.shards)

    def scatter(self):
        """Each position's slice of every logical gradient into its
        gradient buffer (step 1), and the weight blocks that K3 writes
        outside the shards filled from them."""
        with torch.no_grad():
            for p, ul, gp in zip(self.params, self._ulayouts,
                                 self._gpieces):
                g = p.grad()
                for src, dst in block_copies(_Whole(g), [g], ul, gp):
                    dst.copy_(src, non_blocking=True)
            for src, dst in self._pre:
                dst.copy_(src, non_blocking=True)

    def members(self, steps):
        """``{key: [(w, st, g, lr, wd, t)]}`` for ``Optimizer.
        _fused_device``, ``steps`` the ``(lr, wd, t)`` of each parameter in
        ``indices`` order."""
        return {key: [(w, st, g, *steps[j]) for j, w, st, g in members]
                for key, members in self.buckets}

    def row_buckets(self):
        """``[(mp, [(w, st, g)], start, stop)]`` for ``Optimizer.
        _fused_device_rows``: rows ``start:stop`` of the scalars are the
        bucket's, in :attr:`rows` order."""
        out, at = [], 0
        for (_, mp), members in self.buckets:
            out.append((mp, [(w, st, g) for _, w, st, g in members], at,
                        at + len(members)))
            at += len(members)
        return out

    def finish(self):
        """Step 3: the peers' blocks into each weight shard, the shards
        into the logical values, the frozen parameters' logical values into
        their shards."""
        with torch.no_grad():
            for pairs in (self._exchange, self._gather, self._frozen):
                for src, dst in pairs:
                    dst.copy_(src, non_blocking=True)

    def copies(self):
        """The number of copies a step makes besides the gradients'."""
        return (len(self._pre) + len(self._exchange) + len(self._gather)
                + len(self._frozen))
