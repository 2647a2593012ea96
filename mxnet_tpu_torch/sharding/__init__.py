"""Hybrid parallelism: WHERE every array lives (counterpart of
mxnet_tpu/sharding).

One :class:`ShardingPlan` (mesh axes + per-parameter PartitionSpec rules)
threads through Trainer, TrainStep, kvstore and checkpoint, so
``Trainer(..., sharding_plan=ShardingPlan("dp=2,fsdp=2,tp=2",
devices=[mt.gpu(0)] * 8))`` trains with each parameter and its optimizer
state placed a block a position of the mesh; ``mesh=None`` (and
MXTPU_SHARDING=off) keeps every code path as the unsharded framework's.

The JAX package's ``ShardingPass`` (a pass over a traced jaxpr) waits with
the port's ``passes/`` (ROADMAP.md queue 1 item 11).
"""
from .layouts import (DEFAULT_LAYOUT, RECIPES, SpecLayout,  # noqa: F401
                      block_roles, plan_recipe, role_from_name,
                      zero_state_spec)
from .plan import (ShardingError, ShardingPlan, last_applied,  # noqa: F401
                   mode, parse_axes, resolve_plan)

__all__ = ["ShardingError", "ShardingPlan",
           "SpecLayout", "DEFAULT_LAYOUT", "RECIPES", "block_roles",
           "plan_recipe", "role_from_name", "zero_state_spec",
           "last_applied", "mode", "parse_axes", "resolve_plan"]
