"""Elastic training: a topology change as a supported event, not a crash
(counterpart of mxnet_tpu/elastic).

  * :mod:`.reshard`: mesh-migrating checkpoint restore: judge a saved plan
    against a target plan, gate world-size changes behind the typed
    :class:`PlanMismatch`, rewrite checkpoints offline for a new mesh, and
    prove restores bit for bit against the checkpoint's arrays;
  * :mod:`.reentry`: move a live Trainer and its TrainStep onto a new
    plan, rescale the LR (``MXTPU_ELASTIC_LR_RESCALE``), bump the
    :func:`world_generation` counter;
  * :mod:`.policy`: the restart decision (backoff, budget, clean-exit
    contract) and the append-only restart ledger.
"""
from __future__ import annotations

from .policy import LEDGER_NAME, RestartLedger, RestartPolicy
from .reentry import (bump_generation, current_generation, reenter,
                      rescale_factor, rescale_lr, world_generation)
from .reshard import (PlanMismatch, plan_compatibility, plan_world_size,
                      reshard_checkpoint, resharded_restore, verify_parity)

__all__ = [
    "PlanMismatch", "plan_compatibility", "plan_world_size",
    "resharded_restore", "reshard_checkpoint", "verify_parity",
    "reenter", "rescale_lr", "rescale_factor",
    "world_generation", "bump_generation", "current_generation",
    "RestartPolicy", "RestartLedger", "LEDGER_NAME",
]
