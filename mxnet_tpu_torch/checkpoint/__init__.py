"""Fault-tolerant checkpointing: atomic async snapshots, retention,
preemption handling, and exact training resume (counterpart of
mxnet_tpu/checkpoint; the same files, so either package restores the
other's checkpoints).

    mgr = mt.checkpoint.CheckpointManager("ckpts", trainer, keep_last=5)
    mt.checkpoint.install_preemption_handler(mgr)
    for step in range(...):
        ...
        if step % 100 == 0:
            mgr.save(step, user_state={"epoch": epoch, "batch": batch})
    # after a crash / preemption:
    result = mgr.restore()          # latest committed, checksum-verified
    start = result.step + 1
"""
from __future__ import annotations

from .errors import (CheckpointCorrupt, CheckpointError,
                     CheckpointNotFound, PlanMismatch)
from .manager import CheckpointManager, RestoreResult, verify_checkpoint
from .preemption import PreemptionHandler, install_preemption_handler

__all__ = [
    "CheckpointManager", "RestoreResult", "verify_checkpoint",
    "PreemptionHandler", "install_preemption_handler",
    "CheckpointError", "CheckpointCorrupt", "CheckpointNotFound",
    "PlanMismatch",
]
