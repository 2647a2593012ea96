"""Data-parallel training-step builders on a mesh of positions
(counterpart of mxnet_tpu/parallel/data_parallel.py).

``make_data_parallel_step`` computes what the JAX package's GSPMD step
computes: the batch sharded over ``axis`` is one global batch, so the step
takes the loss of the whole batch and its gradient. ``make_shard_map_step``
runs the JAX package's explicit body on each position: the loss and
gradients of the position's shard of the batch, then their mean over the
positions (``pmean``: the sum in position order, over the axis size).

``loss_fn(params, batch)`` gives a scalar tensor and ``update_fn(params,
grads, opt_state, lr)`` gives ``(new_params, new_opt_state)``, both on
pytrees of tensors (nested dicts, lists and tuples, as
``parallel/collectives.py`` flattens them); a step returns ``(params,
opt_state, loss)``. Positions share devices as the mesh says: one replica
computes the update for all. ``param_specs`` (a PartitionSpec, or a pytree
of them, or of None for replicated, over ``params``' structure) says how the
JAX package's step lays the parameters and their state out; the step
computes the same logical function either way, so here each parameter's
spec is checked against the mesh at the first call (a dim its axes do not
divide raises ``ShardingError`` naming the parameter) and the values stay
whole, as the JAX package's global arrays read.
"""
from __future__ import annotations

import torch

from .collectives import _flatten, _sum_shards
from .mesh import PartitionSpec, ShardingError, _check_divisible, split

__all__ = ["make_data_parallel_step", "make_shard_map_step"]


def _value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn`` at ``params``, grads in params'
    structure; nothing recorded on the caller's tensors."""
    leaves, rebuild = _flatten(params)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(rebuild(xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(xs, grads)]
    return loss.detach(), rebuild(grads)


def _shards(batch, mesh, axis):
    """The batch's leaves split along dim 0 over ``axis``: a list, one
    batch pytree a position."""
    leaves, rebuild = _flatten(batch)
    parts = [split(x, mesh, axis, 0) for x in leaves]
    n = mesh.shape[axis]
    return [rebuild([p[i] for p in parts]) for i in range(n)]


def _spec_pairs(tree, specs, path=""):
    """``[(name, leaf, spec)]`` of ``tree``'s leaves under the spec pytree
    prefix ``specs`` (a PartitionSpec or None covers a whole subtree)."""
    if specs is None or isinstance(specs, PartitionSpec):
        spec = specs if specs is not None else PartitionSpec()
        leaves, _ = _flatten(tree)
        return [(path or "param", x, spec) for x in leaves]
    if isinstance(specs, dict):
        return [pair for k in sorted(tree)
                for pair in _spec_pairs(tree[k], specs.get(k),
                                        f"{path}{k}" if not path
                                        else f"{path}.{k}")]
    return [pair for j, (t, sp) in enumerate(zip(tree, specs))
            for pair in _spec_pairs(t, sp, f"{path}[{j}]")]


def make_data_parallel_step(loss_fn, update_fn, mesh, axis="dp",
                            param_specs=None, donate=True):  # noqa: ARG001
    """``step(params, opt_state, batch, lr) -> (params, opt_state, loss)``
    over the whole batch, which must split evenly over ``axis``.
    ``param_specs`` lays the parameters out (module note); ``donate`` is
    accepted for the JAX signature (torch updates need no donation)."""
    n = mesh.shape[axis]
    checked = []

    def step(params, opt_state, batch, lr):
        if param_specs is not None and not checked:
            for name, x, spec in _spec_pairs(params, param_specs):
                _check_divisible(name, tuple(x.shape), spec, mesh)
            checked.append(True)
        for x in _flatten(batch)[0]:
            if x.shape[0] % n:
                raise ShardingError(
                    f"batch dim 0 ({x.shape[0]}) is not divisible by mesh "
                    f"axis {axis} (size {n})")
        loss, grads = _value_and_grad(loss_fn, params, batch)
        new_params, new_opt = update_fn(params, grads, opt_state, lr)
        return new_params, new_opt, loss

    return step


def make_shard_map_step(loss_fn, update_fn, mesh, axis="dp"):
    """The explicit-collective step: each position's loss and gradients
    over its shard, averaged over the positions, then one update."""
    n = mesh.shape[axis]
    devices = mesh.positions(axis)

    def step(params, opt_state, batch, lr):
        leaves, rebuild = _flatten(params)
        losses, grads = [], []
        for dev, shard in zip(devices, _shards(batch, mesh, axis)):
            local = rebuild([x.to(dev, non_blocking=True) for x in leaves])
            loss, g = _value_and_grad(loss_fn, local, shard)
            losses.append(loss)
            grads.append(_flatten(g)[0])
        # the mean lands where the parameters live (the first position's
        # device, the sum's home, when there are none)
        home = leaves[0].device if leaves else devices[0]
        mean = rebuild([_sum_shards([g[j] for g in grads]).to(home) / n
                        for j in range(len(leaves))])
        loss = _sum_shards(losses).to(home) / n
        new_params, new_opt = update_fn(params, mean, opt_state, lr)
        return new_params, new_opt, loss

    return step
