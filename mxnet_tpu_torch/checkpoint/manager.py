"""Atomic, async, retained checkpoints over the IO chain (counterpart of
mxnet_tpu/checkpoint/manager.py; the same directory layout, manifest and
payload, so either package restores the other's checkpoints).

Commit protocol: a checkpoint becomes visible ONLY via a directory
rename:

    .tmp-step-XXXXXXXX/            (invisible to restore)
        arrays.npz                 write + flush + fsync
        MANIFEST.json              write + fsync   (per-array crc32s)
        <dirfsync>
    os.replace(tmp, step-XXXXXXXX) atomic on POSIX
    <parent dirfsync>

so a SIGKILL at ANY point leaves either the previous committed checkpoint
intact (tmp dirs are ignored and reaped) or the new one fully present with
a checksummed manifest. Both write and commit are queued on ONE
``_checkpoint_io`` path, keyed by the final directory, so the commit can
never overtake (or run despite) a failed payload write, training overlaps
the serialization, and ``flush()``/``restore()``/``flush_all()`` barrier on
exactly the right path.

A bf16 array is checksummed and written as its uint16 bits, and the
manifest names its dtype ``bfloat16``, as the JAX package's does: the same
state gives the same names, dtypes and crc32s in both packages.

Distributed (a kvstore of several workers, ``kvstore.create('tpu_dist')``):
EVERY rank, writer or not, runs the identical three-fence sequence
(post-mkdir, pre-commit, post-commit) through ``kv.barrier()``; barrier()
is a collective, so a rank skipping any fence would deadlock the rest.
``replicated`` mode has rank 0 write while the other ranks meet the fences
with no-op write/commit; ``sharded`` mode has each rank persist
``shard-NNNNN.npz`` + its fragment manifest into the shared tmp dir BEFORE
the pre-commit fence, so rank 0's merge into the final MANIFEST.json never
reads a missing or partial fragment. Multi-worker saves are forced
synchronous: the barrier is a collective and must run on the main thread,
not an IO thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zlib

import numpy as np

from .. import _checkpoint_io
from .._dtype_codec import decode_npz, encode_payload, host_bits
from ..diagnostics import spans as _spans
from ..telemetry import instruments as _telemetry
from . import snapshot as _snapshot
from ..elastic.reshard import plan_compatibility, plan_world_size  # noqa: F401
from .errors import (CheckpointCorrupt, CheckpointError,
                     CheckpointNotFound, PlanMismatch)

__all__ = ["CheckpointManager", "RestoreResult", "verify_checkpoint"]

MANIFEST_NAME = "MANIFEST.json"
FORMAT_VERSION = 1
_STEP_FMT = "step-{:08d}"
_TMP_FMT = ".tmp-step-{:08d}"

# test seam: called with the payload path on the IO thread right before
# the npz write starts: lets tests hold a write open (to SIGKILL the
# process mid-write, or to prove save() returns while the write runs)
_WRITE_BEGIN_HOOK = None


def _bits(a):
    """``(numpy view, manifest dtype name)`` of a host array: a bf16 tensor
    as its uint16 bits named ``bfloat16``."""
    view, name = host_bits(a)
    return view, name or str(view.dtype)


def _crc(a):
    """crc32 of an array's raw bytes (a bf16 array's bits), read in place:
    the same value whether computed at capture or at verify time, and in
    either package."""
    view = np.ascontiguousarray(_bits(a)[0])
    return zlib.crc32(view) & 0xFFFFFFFF


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_of(name):
    if name.startswith("step-"):
        try:
            return int(name[5:])
        except ValueError:
            return None
    return None


def _committed_steps(directory):
    """The committed steps under ``directory``, ascending (a step dir
    with its manifest); raises FileNotFoundError for a missing one."""
    out = []
    for n in os.listdir(directory):
        s = _step_of(n)
        if s is not None and os.path.isfile(
                os.path.join(directory, n, MANIFEST_NAME)):
            out.append(s)
    return sorted(out)


class RestoreResult:
    """What restore() hands back: the resumed step, the user-state blob
    saved alongside (dataloader cursor etc.), and the raw manifest."""

    def __init__(self, step, user_state, manifest):
        self.step = step
        self.user_state = user_state
        self.manifest = manifest

    def __repr__(self):
        return f"RestoreResult(step={self.step})"


class CheckpointManager:
    """Snapshot/restore complete training state with atomic commits,
    retention, and async writes (module note)."""

    def __init__(self, directory, trainer=None, *, keep_last=None,
                 keep_every_n_steps=None, mode=None, kvstore=None,
                 verify=None, async_save=None, user_meta=None):
        from .. import env as _env

        self.directory = os.path.abspath(str(directory))
        self._trainer = trainer
        self._kv = kvstore if kvstore is not None else (
            getattr(trainer, "_kvstore", None) if trainer is not None
            else None)
        self.keep_last = _env.get("MXTPU_CKPT_KEEP_LAST") \
            if keep_last is None else int(keep_last)
        self.keep_every_n_steps = _env.get("MXTPU_CKPT_KEEP_EVERY_N") \
            if keep_every_n_steps is None else int(keep_every_n_steps)
        self.mode = (_env.get("MXTPU_CKPT_MODE") if mode is None
                     else mode).lower()
        if self.mode not in ("replicated", "sharded"):
            raise ValueError(
                f"mode must be 'replicated' or 'sharded', got {self.mode!r}")
        self.verify = _env.get("MXTPU_CKPT_VERIFY") \
            if verify is None else bool(verify)
        self.async_save = _env.get("MXTPU_CKPT_ASYNC") \
            if async_save is None else bool(async_save)
        self.user_meta = user_meta
        self._lock = threading.Lock()   # serializes retention vs. scans
        self._pending = []              # final dirs with in-flight ops
        os.makedirs(self.directory, exist_ok=True)
        if self._rank == 0:
            self._clean_stale_tmp()

    # -- topology ----------------------------------------------------------
    @property
    def _rank(self):
        return getattr(self._kv, "rank", 0) if self._kv is not None else 0

    @property
    def _world(self):
        return getattr(self._kv, "num_workers", 1) \
            if self._kv is not None else 1

    def _barrier(self):
        if self._kv is not None and self._world > 1:
            self._kv.barrier()

    def bind(self, trainer):
        """Attach (or swap) the trainer this manager snapshots."""
        self._trainer = trainer
        if self._kv is None:
            self._kv = getattr(trainer, "_kvstore", None)
        return self

    # -- discovery ---------------------------------------------------------
    def steps(self):
        """Committed checkpoint steps, ascending. A step dir without a
        manifest (impossible via the commit protocol, but a truncated copy
        could produce one) is not 'committed'."""
        try:
            return _committed_steps(self.directory)
        except FileNotFoundError:
            return []

    def latest_step(self):
        """Newest committed step, or None when the directory is empty."""
        steps = self.steps()
        return steps[-1] if steps else None

    def step_dir(self, step):
        return os.path.join(self.directory, _STEP_FMT.format(step))

    def _clean_stale_tmp(self):
        """Reap .tmp-* leftovers from a previous process killed mid-write
        (they are by definition uncommitted, never loadable)."""
        for n in os.listdir(self.directory):
            if n.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, n),
                              ignore_errors=True)

    # -- save --------------------------------------------------------------
    def save(self, step=None, user_state=None, sync=None, reason="periodic"):
        """Snapshot now; write/commit asynchronously (unless ``sync``).

        Captures host copies of all state before returning (after the
        card's queued work), so training may continue changing parameters
        immediately: the IO thread serializes and commits in the
        background. Returns the step.

        ``user_state`` must be JSON-serializable; it comes back verbatim
        from ``restore()`` (dataloader epoch/batch cursor, etc.).
        """
        if self._trainer is None:
            raise CheckpointError(
                "CheckpointManager has no trainer bound: pass one at "
                "construction or call bind(trainer)")
        if step is None:
            step = _spans.current_step()
        step = int(step)
        t0 = time.perf_counter()
        with _spans.span("ckpt.capture", cat="checkpoint"):
            arrays, meta = _snapshot.capture(self._trainer,
                                             user_state=user_state)
        world, rank = self._world, self._rank
        sync = (not self.async_save) if sync is None else bool(sync)
        if world > 1:
            sync = True  # commit barrier is a collective: main thread only
        final = self.step_dir(step)
        tmp = os.path.join(self.directory, _TMP_FMT.format(step))
        # which ranks write a payload file into tmp (non-writers still run
        # the exact same barrier sequence below: barrier() is a collective,
        # so EVERY rank must meet EVERY fence or the writers deadlock)
        writer = self.mode == "sharded" or rank == 0
        if world > 1:
            # multi-worker saves are always sync, so no queued async op can
            # still be writing into tmp: main-thread reset is safe here
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            self._barrier()  # writers must not race rank 0's mkdir

        entries = {}      # manifest "arrays" section (this rank's share)
        my_arrays = {}
        if self.mode == "sharded":
            fname = f"shard-{rank:05d}.npz"
            names = sorted(arrays)
            my_names = [n for i, n in enumerate(names) if i % world == rank]
        else:
            fname = "arrays.npz"
            my_names = sorted(arrays) if writer else []
        with _spans.span("ckpt.checksum", cat="checkpoint"):
            for n in my_names:
                a = arrays[n]
                view, dtype = _bits(a)
                my_arrays[n] = a
                entries[n] = {"file": fname, "shape": list(view.shape),
                              "dtype": dtype, "crc32": _crc(view),
                              "nbytes": int(view.nbytes)}
        nbytes = sum(e["nbytes"] for e in entries.values())
        payload_path = os.path.join(tmp, fname)
        manifest = {
            "format_version": FORMAT_VERSION,
            "library_version": _library_version(),
            "step": step,
            "time": time.time(),
            "world_size": world,
            "mode": self.mode,
            "reason": reason,
            "user_meta": self.user_meta,
            "meta": meta,
            "arrays": entries,
        }

        def write_op():
            if world == 1:
                # tmp reset runs on the serialized IO chain, so a queued
                # async write for a re-save of the same step can never have
                # its directory pulled out from under it
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            if not writer:
                return
            hook = _WRITE_BEGIN_HOOK
            if hook is not None:
                hook(payload_path)
            # the snapshot's own host copies: written in place
            payload = encode_payload(my_arrays, copy=False)
            with open(payload_path, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            if self.mode == "sharded" and world > 1:
                # the fragment manifest must be durable BEFORE the
                # pre-commit barrier: rank 0's merge reads every fragment
                _write_json(
                    os.path.join(tmp, f"MANIFEST.shard-{rank:05d}.json"),
                    manifest)

        def commit_op():
            if _checkpoint_io.pending_error(final) is not None:
                # payload write failed: never commit on top of it, but a
                # failed save must still show up in metrics
                if writer:
                    _telemetry.record_ckpt_save(
                        self.mode, (time.perf_counter() - t0) * 1e3,
                        nbytes, "error")
                return
            if rank == 0:
                self._commit(tmp, final, manifest, world)
            if writer:
                _telemetry.record_ckpt_save(
                    self.mode, (time.perf_counter() - t0) * 1e3, nbytes,
                    "ok")

        if sync and world > 1:
            # ops run inline: the fences are collectives and must
            # interleave with the writes on the main thread. Every rank,
            # writer or not, executes this identical barrier sequence.
            write_op()
            self._barrier()  # payloads + fragment manifests all on disk
            commit_op()
            _checkpoint_io.wait_for_path(final)  # an earlier op's failure
            self._barrier()  # nobody proceeds before the rename landed
        elif sync:
            # through the path's chain, so this save serializes with any
            # still-pending async save of the same step, then barrier
            _checkpoint_io.async_run(final, write_op)
            _checkpoint_io.async_run(final, commit_op)
            _checkpoint_io.wait_for_path(final)
        else:
            _checkpoint_io.async_run(final, write_op)
            _checkpoint_io.async_run(final, commit_op)
            with self._lock:
                if final not in self._pending:
                    self._pending.append(final)
        return step

    def _commit(self, tmp, final, manifest, world):
        """Manifest + fsync + rename. Runs on the IO thread (async) or
        inline (sync); in multi-worker mode only rank 0 gets here. Sharded
        fragment manifests are already on disk (each rank's write_op wrote
        its own before the pre-commit barrier): merge them here."""
        if self.mode == "sharded" and world > 1:
            merged = dict(manifest)
            merged["arrays"] = {}
            for r in range(world):
                fp = os.path.join(tmp, f"MANIFEST.shard-{r:05d}.json")
                with open(fp, encoding="utf-8") as f:
                    merged["arrays"].update(json.load(f)["arrays"])
            manifest = merged
        _write_json(os.path.join(tmp, MANIFEST_NAME), manifest)
        _fsync_dir(tmp)
        if os.path.isdir(final):
            # re-saving an existing step replaces it (os.replace cannot
            # overwrite a non-empty dir)
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        with self._lock:
            self._apply_retention()

    def _apply_retention(self):
        if self.keep_last <= 0:
            return
        steps = self.steps()
        drop = steps[:-self.keep_last] if len(steps) > self.keep_last else []
        for s in drop:
            if self.keep_every_n_steps > 0 and \
                    s % self.keep_every_n_steps == 0:
                continue  # milestone: retained forever
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def flush(self):
        """Barrier every save issued by THIS manager; re-raises the first
        write/commit failure (original traceback intact)."""
        with self._lock:
            pending, self._pending = self._pending, []
        first = None
        for p in pending:
            try:
                _checkpoint_io.wait_for_path(p)
            except Exception as e:  # noqa: BLE001, PERF203 - drain all
                if first is None:
                    first = e
        if first is not None:
            raise first

    # -- restore -----------------------------------------------------------
    def restore(self, step=None, trainer=None, allow_reshard=False):
        """Load a committed checkpoint into the trainer, in place
        (``snapshot.apply``).

        step=None walks committed steps newest-first, skipping corrupt ones
        with a warning (telemetry ``ckpt_restore_total{outcome="corrupt"}``);
        raises CheckpointNotFound when none load. An explicit ``step``
        raises CheckpointNotFound if absent and CheckpointCorrupt if
        damaged: it never silently substitutes another step. Returns a
        RestoreResult.

        When both the checkpoint and the trainer carry a sharding plan and
        their world sizes (mesh position counts) differ, restore is a
        topology migration and raises PlanMismatch unless
        ``allow_reshard=True`` opts in (``elastic.resharded_restore`` is the
        front door). Same-world plan changes place silently, as ever: the
        arrays are logical, and ``snapshot.apply`` writes them into the
        restoring trainer's blocks.
        """
        trainer = trainer or self._trainer
        if trainer is None:
            raise CheckpointError("restore() needs a trainer "
                                  "(bind one or pass trainer=)")
        self.flush()
        self._barrier()  # an in-flight rank-0 commit must land first
        if step is not None:
            step = int(step)
            if not os.path.isfile(os.path.join(self.step_dir(step),
                                               MANIFEST_NAME)):
                _telemetry.record_ckpt_restore("not_found")
                raise CheckpointNotFound(
                    f"no committed checkpoint for step {step} "
                    f"in {self.directory}")
            return self._load(step, trainer, allow_reshard)
        candidates = self.steps()
        if not candidates:
            _telemetry.record_ckpt_restore("not_found")
            raise CheckpointNotFound(
                f"no committed checkpoint in {self.directory}")
        last_err = None
        for s in reversed(candidates):
            try:
                return self._load(s, trainer, allow_reshard)
            except CheckpointCorrupt as e:  # noqa: PERF203
                warnings.warn(
                    f"checkpoint step {s} is corrupt ({e}); "
                    f"falling back to an earlier one", stacklevel=2)
                last_err = e
        _telemetry.record_ckpt_restore("not_found")
        raise CheckpointNotFound(
            f"all {len(candidates)} checkpoints in {self.directory} "
            f"are corrupt") from last_err

    def _check_plan(self, manifest, trainer, allow_reshard, d):
        """The PlanMismatch gate (manager.py:426): the compatibility report
        when the restore crosses plans (None for an exact resume). Only a
        plan-to-plan world-size change is gated; restoring onto a
        plan-less trainer or from a plan-less checkpoint stays silent."""
        saved = (manifest.get("meta") or {}).get("sharding_plan")
        plan = getattr(trainer, "sharding_plan", None)
        if saved is None and plan is None:
            return None
        compat = plan_compatibility(saved, plan)
        if compat["verdict"] == "exact":
            return None
        if compat["verdict"] == "reshard" and saved is not None \
                and plan is not None and not allow_reshard:
            _telemetry.record_ckpt_restore("plan_mismatch")
            raise PlanMismatch(
                f"{d}: checkpoint was saved under a "
                f"{compat['saved_world']}-device plan "
                f"({compat['saved_axes']}) but the trainer's plan spans "
                f"{compat['target_world']} devices "
                f"({compat['target_axes']}): a topology migration. "
                f"Pass allow_reshard=True (or use "
                f"elastic.resharded_restore / tools/ckpt.py reshard) "
                f"to opt in",
                saved_plan=saved, target_plan=plan.to_manifest())
        return compat

    def _load(self, step, trainer, allow_reshard=False):
        d = self.step_dir(step)
        try:
            arrays, manifest = _read_checkpoint(d, verify=self.verify)
        except CheckpointError:
            _telemetry.record_ckpt_restore("corrupt")
            raise
        compat = self._check_plan(manifest, trainer, allow_reshard, d)
        t0 = time.perf_counter()
        with _spans.span("ckpt.restore", cat="checkpoint"):
            try:
                _snapshot.apply(trainer, arrays, manifest["meta"])
            except CheckpointError:
                _telemetry.record_ckpt_restore("error")
                raise
        if compat is not None:
            # a cross-plan restore IS the reshard (apply placed every
            # array under the target plan): time it
            _telemetry.record_reshard(
                (time.perf_counter() - t0) * 1e3,
                saved_world=compat["saved_world"],
                target_world=compat["target_world"], site="restore")
        _telemetry.record_ckpt_restore("ok")
        return RestoreResult(step, manifest["meta"].get("user_state"),
                             manifest)


def _library_version():
    from .. import __version__

    return __version__


def _write_json(path, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


def _read_checkpoint(d, verify=True):
    """Load + validate one committed checkpoint dir. Returns
    ``(arrays, manifest)``, bf16 arrays as CPU bf16 tensors; raises
    CheckpointCorrupt on any damage."""
    mpath = os.path.join(d, MANIFEST_NAME)
    try:
        with open(mpath, encoding="utf-8") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorrupt(f"{d}: missing {MANIFEST_NAME}") from None
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorrupt(f"{d}: unreadable manifest: {e}") from e
    if manifest.get("format_version") != FORMAT_VERSION:
        raise CheckpointCorrupt(
            f"{d}: unsupported format_version "
            f"{manifest.get('format_version')!r}")
    entries = manifest.get("arrays")
    if not isinstance(entries, dict):
        raise CheckpointCorrupt(f"{d}: manifest has no arrays section")
    arrays = {}
    for fname in sorted({e["file"] for e in entries.values()}):
        fp = os.path.join(d, fname)
        try:
            with np.load(fp) as npz:
                arrays.update(decode_npz(npz))
        except FileNotFoundError:
            raise CheckpointCorrupt(f"{d}: missing payload {fname}") \
                from None
        except Exception as e:  # noqa: BLE001 - any damage is corruption
            raise CheckpointCorrupt(
                f"{d}: unreadable payload {fname}: {e}") from e
    for name, e in entries.items():
        if name not in arrays:
            raise CheckpointCorrupt(
                f"{d}: manifest lists {name!r} but {e['file']} lacks it")
        view, dtype = _bits(arrays[name])
        if list(view.shape) != list(e["shape"]) or dtype != e["dtype"]:
            raise CheckpointCorrupt(
                f"{d}: {name!r} is {dtype}{list(view.shape)}, manifest "
                f"says {e['dtype']}{e['shape']}")
        if verify and _crc(view) != e["crc32"]:
            raise CheckpointCorrupt(
                f"{d}: checksum mismatch on {name!r} "
                f"(bit-rot or truncated write)")
    extra = set(arrays) - set(entries)
    if extra:
        raise CheckpointCorrupt(
            f"{d}: payload holds arrays absent from manifest: "
            f"{sorted(extra)[:4]}")
    return arrays, manifest


def verify_checkpoint(directory, step=None):
    """Offline integrity report for tools/ckpt.py: checks manifest, payload
    presence, shapes/dtypes, and per-array crc32 WITHOUT needing a trainer.
    Returns a JSON-able report dict (never raises for validation failures:
    they land in report['errors'])."""
    directory = os.path.abspath(str(directory))
    try:
        mgr_steps = _committed_steps(directory)
    except FileNotFoundError:
        return {"directory": directory, "step": step, "ok": False,
                "found": False, "errors": ["directory does not exist"]}
    if step is None:
        if not mgr_steps:
            return {"directory": directory, "step": None, "ok": False,
                    "found": False,
                    "errors": ["no committed checkpoints"]}
        step = mgr_steps[-1]
    step = int(step)
    d = os.path.join(directory, _STEP_FMT.format(step))
    if not os.path.isfile(os.path.join(d, MANIFEST_NAME)):
        return {"directory": directory, "step": step, "ok": False,
                "found": False,
                "errors": [f"no committed checkpoint for step {step}"]}
    report = {"directory": directory, "step": step, "found": True,
              "errors": []}
    try:
        arrays, manifest = _read_checkpoint(d, verify=True)
    except CheckpointCorrupt as e:
        report["ok"] = False
        report["errors"].append(str(e))
        return report
    report["ok"] = True
    report["arrays"] = len(arrays)
    report["nbytes"] = sum(int(e["nbytes"])
                           for e in manifest["arrays"].values())
    report["world_size"] = manifest.get("world_size")
    report["mode"] = manifest.get("mode")
    report["library_version"] = manifest.get("library_version")
    report["manifest_step"] = manifest.get("step")
    # the plan the run trained under (None = unsharded): provenance
    report["sharding_plan"] = (manifest.get("meta") or {}).get(
        "sharding_plan")
    if manifest.get("step") != step:
        report["ok"] = False
        report["errors"].append(
            f"manifest step {manifest.get('step')} != dir step {step}")
    return report
