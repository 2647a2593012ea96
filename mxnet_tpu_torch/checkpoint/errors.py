"""Typed checkpoint errors (counterpart of mxnet_tpu/checkpoint/errors.py).

Callers branch on these: NotFound means "cold start, begin at step 0";
Corrupt means "this checkpoint is damaged". ``restore()`` treats the two
very differently: a corrupt *latest* falls back to the previous committed
step; an explicitly requested step never silently substitutes another.
"""
from __future__ import annotations

from ..error import MXNetError

__all__ = ["CheckpointError", "CheckpointNotFound", "CheckpointCorrupt",
           "PlanMismatch"]


class CheckpointError(MXNetError):
    """Base for checkpoint subsystem failures."""


class CheckpointNotFound(CheckpointError):
    """No committed checkpoint exists (at the requested step, or at all)."""


class CheckpointCorrupt(CheckpointError):
    """A committed checkpoint failed validation (missing files, manifest
    mismatch, or per-array checksum failure)."""


class PlanMismatch(CheckpointError):
    """The checkpoint's recorded sharding plan and the restoring trainer's
    plan disagree on world size (mesh device count). Restoring across world
    sizes is a topology migration, not a resume: ``restore(...,
    allow_reshard=True)`` (or ``elastic.resharded_restore``) opts in."""

    def __init__(self, msg, saved_plan=None, target_plan=None):
        super().__init__(msg)
        self.saved_plan = saved_plan      # manifest dict (or None)
        self.target_plan = target_plan    # manifest dict (or None)
