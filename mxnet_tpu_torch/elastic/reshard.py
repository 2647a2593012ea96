"""Mesh-migrating checkpoint restore (counterpart of
mxnet_tpu/elastic/reshard.py).

Checkpoints are placement-free by construction: ``snapshot.capture``
gathers every placed parameter and state leaf into its logical value, so
the payload of a dp=4 run and of a dp=2·fsdp=2·tp=2 run of the same model
is the same bytes, in either package. Resharding is therefore a contract,
not an array rewrite:

  * :func:`plan_compatibility` judges a saved plan manifest against a
    target plan: ``exact`` (same resolved axes), ``replace`` (same world
    size, another placement: restore places silently) or ``reshard``
    (another world size: a topology migration that :class:`PlanMismatch`
    gates behind ``allow_reshard=True``);
  * :func:`resharded_restore` is the opt-in front door over
    ``CheckpointManager.restore(..., allow_reshard=True)``;
  * :func:`reshard_checkpoint` rewrites a committed checkpoint OFFLINE for
    a target mesh: the same arrays, the manifest's plan replaced by the
    target's, the payload split over the target world's shard files, with
    the manager's tmp + fsync + rename commit;
  * :func:`verify_parity` proves a restore bit for bit against the
    checkpoint's arrays, parameters AND optimizer state.

ZeRO re-extension needs no code here: ``snapshot.apply`` writes restored
state into the restoring trainer's placed blocks (its plan's
``state_spec_for``), so state saved 1/4 a position under fsdp=4 lands 1/2
a position under fsdp=2, or whole, from the same logical arrays.
"""
from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from ..checkpoint.errors import CheckpointError, PlanMismatch

__all__ = ["PlanMismatch", "plan_compatibility", "plan_world_size",
           "resharded_restore", "reshard_checkpoint", "verify_parity"]


def _as_manifest(plan):
    """A plan argument -> manifest dict (or None): a manifest dict
    already, a ShardingPlan, or an axes spelling."""
    if plan is None or isinstance(plan, dict):
        return plan
    from ..sharding.plan import ShardingPlan

    if not isinstance(plan, ShardingPlan):
        plan = ShardingPlan(plan)
    return plan.to_manifest()


def plan_world_size(plan_manifest):
    """Positions a plan manifest's mesh spans (the product of its axis
    sizes); 1 for None (unsharded = one logical device view). -1
    (uninferred) sizes resolve against this host's card count."""
    if plan_manifest is None:
        return 1
    total, infer = 1, 0
    for _name, size in plan_manifest.get("axes") or ():
        if int(size) == -1:
            infer += 1
        else:
            total *= int(size)
    if infer:
        n = max(torch.cuda.device_count(), 1)
        total = n if total == 0 else max(n // total, 1) ** infer * total
    return total


def plan_compatibility(saved, target):
    """Judge a saved plan against a target plan. Both may be manifests,
    ShardingPlans, axes spellings, or None. Returns a JSON-able report:

      verdict   'exact'    same resolved axes (a plain resume),
                'replace'  same world size, another placement: restore()
                           places silently,
                'reshard'  another world size: restore() raises
                           PlanMismatch unless allow_reshard=True;
      saved_world / target_world / saved_axes / target_axes / notes.
    """
    saved = _as_manifest(saved)
    target = _as_manifest(target)
    sw, tw = plan_world_size(saved), plan_world_size(target)
    s_axes = [list(a) for a in (saved or {}).get("axes") or []]
    t_axes = [list(a) for a in (target or {}).get("axes") or []]
    notes = []
    if s_axes == t_axes:
        verdict = "exact"
    elif sw == tw:
        verdict = "replace"
        notes.append("same world size: restore() re-places arrays "
                     "under the target plan silently")
    else:
        verdict = "reshard"
        notes.append(
            f"world size changes {sw} -> {tw}: restore() raises "
            f"PlanMismatch unless allow_reshard=True "
            f"(elastic.resharded_restore / tools/ckpt.py reshard)")
    if (saved or {}).get("zero_axis") != (target or {}).get("zero_axis"):
        notes.append(
            f"ZeRO axis changes "
            f"{(saved or {}).get('zero_axis')!r} -> "
            f"{(target or {}).get('zero_axis')!r}: optimizer state "
            f"re-extends along the target fsdp axis on restore")
    return {"verdict": verdict, "compatible": verdict != "reshard",
            "saved_world": sw, "target_world": tw,
            "saved_axes": s_axes, "target_axes": t_axes, "notes": notes}


def resharded_restore(manager, step=None, trainer=None):
    """Restore a checkpoint onto a trainer whose plan differs from the
    saved one: the explicit opt-in for world-size migrations, over
    ``manager.restore(..., allow_reshard=True)`` (which times the move as
    ``reshard_ms``). Returns ``(RestoreResult, compatibility report)``."""
    result = manager.restore(step=step, trainer=trainer,
                             allow_reshard=True)
    tr = trainer or manager._trainer
    saved = (result.manifest.get("meta") or {}).get("sharding_plan")
    target = getattr(tr, "sharding_plan", None)
    return result, plan_compatibility(saved, target)


def reshard_checkpoint(src, dst, target_plan=None, *, step=None,
                       target_world=1, mode="replicated", verify=True):
    """Rewrite a committed checkpoint for a target mesh, offline.

    Reads the checkpoint at ``src`` (the latest committed step unless
    ``step``), then writes a NEW committed checkpoint under ``dst`` whose
    manifest records ``target_plan`` (a ShardingPlan, an axes spelling, a
    manifest dict, or None for replicated) as the run's plan and whose
    payload is split over ``target_world`` shard files in ``mode``
    ('replicated': one arrays.npz; 'sharded': round-robin
    shard-NNNNN.npz, the split a ``target_world``-rank sharded save
    makes). Arrays are copied verbatim, so the output restores onto the
    target topology as an ``exact`` plan match. The write runs the tmp +
    fsync + rename commit of a live save. Returns a report dict ({'step',
    'dst', 'arrays', 'nbytes', 'compatibility'})."""
    from .._dtype_codec import encode_payload
    from ..checkpoint import manager as _mgr
    from ..telemetry import instruments as _telemetry

    t0 = time.perf_counter()
    src = os.path.abspath(str(src))
    dst = os.path.abspath(str(dst))
    if step is None:
        steps = _mgr._committed_steps(src)
        if not steps:
            from ..checkpoint.errors import CheckpointNotFound

            raise CheckpointNotFound(f"no committed checkpoint in {src}")
        step = steps[-1]
    step = int(step)
    d = os.path.join(src, _mgr._STEP_FMT.format(step))
    arrays, manifest = _mgr._read_checkpoint(d, verify=verify)

    target = _as_manifest(target_plan)
    compat = plan_compatibility(
        (manifest.get("meta") or {}).get("sharding_plan"), target)
    target_world = int(target_world)
    mode = str(mode).lower()
    if mode not in ("replicated", "sharded"):
        raise CheckpointError(
            f"mode must be 'replicated' or 'sharded', got {mode!r}")
    names = sorted(arrays)
    if mode == "sharded" and target_world > 1:
        files = {n: f"shard-{i % target_world:05d}.npz"
                 for i, n in enumerate(names)}
    else:
        files = {n: "arrays.npz" for n in names}

    out = dict(manifest)
    out["world_size"] = target_world
    out["mode"] = mode
    out["reason"] = "reshard"
    out["time"] = time.time()
    out["meta"] = dict(manifest.get("meta") or {})
    out["meta"]["sharding_plan"] = target
    out["arrays"] = {}
    for n in names:
        view, dtype = _mgr._bits(arrays[n])
        out["arrays"][n] = {"file": files[n], "shape": list(view.shape),
                            "dtype": dtype, "crc32": _mgr._crc(view),
                            "nbytes": int(view.nbytes)}

    os.makedirs(dst, exist_ok=True)
    final = os.path.join(dst, _mgr._STEP_FMT.format(step))
    tmp = os.path.join(dst, _mgr._TMP_FMT.format(step))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for fname in sorted(set(files.values())):
        payload = encode_payload({n: arrays[n] for n in names
                                  if files[n] == fname})
        with open(os.path.join(tmp, fname), "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
    _mgr._write_json(os.path.join(tmp, _mgr.MANIFEST_NAME), out)
    _mgr._fsync_dir(tmp)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _mgr._fsync_dir(dst)
    nbytes = sum(e["nbytes"] for e in out["arrays"].values())
    _telemetry.record_reshard(
        (time.perf_counter() - t0) * 1e3,
        saved_world=compat["saved_world"],
        target_world=compat["target_world"], site="offline")
    return {"step": step, "dst": final, "arrays": len(names),
            "nbytes": nbytes, "compatibility": compat}


def verify_parity(trainer, arrays, atol=0.0):
    """Compare a trainer's live parameters and optimizer state (their
    logical values, gathered from the positions' blocks) against a
    checkpoint's arrays (the ``param/{i}`` / ``opt/...`` names
    ``snapshot.capture`` writes), bit for bit with ``atol=0.0``. Returns
    the number of arrays compared; raises CheckpointError naming the
    first that diverges."""
    from .._dtype_codec import host_bits, to_numpy
    from ..gluon import _sharded

    def _bits(x):
        """A host array of ``x``'s bits (bf16 as uint16)."""
        if isinstance(x, torch.Tensor):
            return to_numpy(x)[0]
        return host_bits(x)[0]

    def _cmp(name, live):
        want = np.asarray(_bits(arrays[name]))
        got = np.asarray(_bits(live))
        if got.shape != want.shape or got.dtype != want.dtype:
            raise CheckpointError(
                f"parity: {name} is {got.dtype}{got.shape}, checkpoint "
                f"holds {want.dtype}{want.shape}")
        if atol == 0.0:
            ok = np.array_equal(got, want)
        else:
            ok = np.allclose(got, want, atol=atol, rtol=0.0)
        if not ok:
            delta = float(np.max(np.abs(
                got.astype("float64") - want.astype("float64"))))
            raise CheckpointError(
                f"parity: {name} diverges (max |delta| = {delta:g})")

    compared = 0
    for i, p in enumerate(trainer._params):
        _cmp(f"param/{i}", p._tensor())
        compared += 1
    for i, st in enumerate(trainer._states):
        if st is None:
            continue
        leaves = _sharded._leaves(_sharded.full_state(st))
        spec_keys = sorted(k for k in arrays if k == f"opt/{i}"
                           or k.startswith(f"opt/{i}."))
        if len(leaves) != len(spec_keys):
            raise CheckpointError(
                f"parity: param {i} has {len(leaves)} state leaves, "
                f"checkpoint holds {len(spec_keys)}")
        for key, leaf in zip(spec_keys, leaves):
            _cmp(key, leaf)
            compared += 1
    return compared
