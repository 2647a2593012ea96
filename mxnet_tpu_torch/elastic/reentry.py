"""Elastic Trainer re-entry: move a live trainer onto a new topology
(counterpart of mxnet_tpu/elastic/reentry.py).

A process that survives a topology change (or one that wants to change
plans mid-flight) calls :func:`reenter` to swap the trainer onto a new
ShardingPlan in place:

  * the plan is swapped and applied (``Trainer.set_sharding_plan``: the
    parameters placed under the new plan, created optimizer state under
    its ``state_spec_for``, so fsdp state re-extends along the new axis);
  * the store adopts the new plan (its defaults follow it);
  * the TrainStep's graphs, eligibility verdict and update lists are
    dropped by :meth:`TrainStep.rebuild`: the next calls capture ONCE for
    the new world and then replay again;
  * the learning rate rescales per :func:`rescale_lr`
    (``MXTPU_ELASTIC_LR_RESCALE``: linear | sqrt | off): the global batch
    shrinks with the data-parallel world;
  * the :func:`world_generation` counter bumps, into the
    ``world_generation`` gauge and the ``elastic_restart_total`` and
    ``reshard_ms`` series.

The JAX package also stamps the generation into its flight recorder's
identity; the port has no flight recorder yet (ROADMAP.md queue 1 item
11) and keeps the counter and its telemetry only. A relaunched process
inherits the generation through ``MXTPU_ELASTIC_GENERATION``
(:func:`current_generation`).
"""
from __future__ import annotations

import math
import time

from .. import env as _env
from ..telemetry import instruments as _telemetry

__all__ = ["reenter", "rescale_lr", "rescale_factor",
           "world_generation", "bump_generation", "current_generation"]

# this process's world generation: 0 for a first launch, inherited from
# MXTPU_ELASTIC_GENERATION for a relaunch, bumped by every reenter()
_generation = [None]


def current_generation():
    """The generation this process STARTED at (env-inherited, else 0)."""
    try:
        return int(_env.get("MXTPU_ELASTIC_GENERATION"))
    except ValueError:
        return 0


def world_generation():
    """The live generation counter: starts at :func:`current_generation`,
    +1 per :func:`reenter` / :func:`bump_generation`."""
    if _generation[0] is None:
        _generation[0] = current_generation()
    return _generation[0]


def bump_generation():
    """Increment the generation and pin the world_generation gauge."""
    g = world_generation() + 1
    _generation[0] = g
    _telemetry.set_world_generation(g)
    return g


def rescale_factor(old_world, new_world, mode=None):
    """LR multiplier for a world-size change: 'linear' (new/old, the Goyal
    et al. global-batch rule), 'sqrt' (sqrt(new/old)), 'off' (1.0).
    ``mode=None`` reads MXTPU_ELASTIC_LR_RESCALE."""
    if mode is None:
        mode = _env.get("MXTPU_ELASTIC_LR_RESCALE")
    mode = str(mode).strip().lower()
    old_world = max(int(old_world), 1)
    new_world = max(int(new_world), 1)
    if mode in ("off", "0", "none", "false", ""):
        return 1.0
    if mode == "linear":
        return new_world / old_world
    if mode == "sqrt":
        return math.sqrt(new_world / old_world)
    raise ValueError(
        f"MXTPU_ELASTIC_LR_RESCALE={mode!r} is not a recognized mode; "
        f"expected linear | sqrt | off")


def rescale_lr(optimizer, old_world, new_world, mode=None):
    """Apply :func:`rescale_factor` to an optimizer's learning rate in
    place; returns the factor. A scheduled LR (lr_scheduler) is left
    alone."""
    factor = rescale_factor(old_world, new_world, mode)
    if factor != 1.0 and getattr(optimizer, "lr_scheduler", None) is None:
        optimizer.set_learning_rate(optimizer.learning_rate * factor)
    return factor


def reenter(trainer, plan, train_step=None, lr_rescale=None):
    """Re-enter a live trainer on a new ShardingPlan.

    ``plan`` is a ShardingPlan, an axes spelling ('dp=2,fsdp=2'), or None
    (unplaced). ``train_step`` (optional) is the TrainStep to rebuild for
    the new world. Returns ``{'generation', 'old_world', 'new_world',
    'lr_factor', 'ms'}``."""
    from ..sharding.plan import ShardingPlan

    t0 = time.perf_counter()
    old_plan = trainer.sharding_plan
    old_world = old_plan.mesh.devices.size if old_plan is not None else 1
    if plan is not None and not isinstance(plan, ShardingPlan):
        plan = ShardingPlan(plan)
    trainer.set_sharding_plan(plan)
    new_world = plan.mesh.devices.size if plan is not None else 1
    if train_step is not None:
        train_step.rebuild()
    factor = rescale_lr(trainer._optimizer, old_world, new_world,
                        lr_rescale)
    g = bump_generation()
    ms = (time.perf_counter() - t0) * 1e3
    _telemetry.record_elastic_restart("reenter", generation=g)
    _telemetry.record_reshard(ms, saved_world=old_world,
                              target_world=new_world, site="reenter")
    return {"generation": g, "old_world": old_world,
            "new_world": new_world, "lr_factor": factor, "ms": ms}
