"""Checkpoint list/inspect/verify/reshard CLI (counterpart of
tools/ckpt.py), for the checkpoints of either package:

    python -m mxnet_tpu_torch.tools.ckpt list    CKPT_DIR [--json]
    python -m mxnet_tpu_torch.tools.ckpt inspect CKPT_DIR [--step N] [--json]
    python -m mxnet_tpu_torch.tools.ckpt verify  CKPT_DIR [--step N]
                                                 [--mesh AXES] [--json]
    python -m mxnet_tpu_torch.tools.ckpt reshard CKPT_DIR --dest DIR
                    [--mesh AXES] [--world N] [--sharded] [--step N] [--json]

``verify`` re-reads the manifest and every payload array, checking shapes,
dtypes and per-array crc32 checksums; with ``--mesh`` it also judges the
saved sharding plan against a target mesh spelling (``dp=4``,
``dp=2,fsdp=2``, ``replicated``) and reports whether a plain restore, a
silent re-place, or an explicit reshard applies
(``elastic.plan_compatibility``). Exit codes: 0 = ok, 1 = corrupt, 2 =
not found, usable straight from a pre-resume guard in a launch script.

``reshard`` rewrites a committed checkpoint offline for a new topology
(``elastic.reshard_checkpoint``): the manifest's recorded plan becomes
``--mesh`` and the payload is split over ``--world`` shard files, so the
output restores onto the target mesh as an exact plan match.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..checkpoint import CheckpointNotFound, verify_checkpoint
from ..checkpoint.manager import _STEP_FMT, MANIFEST_NAME, CheckpointManager
from ..elastic import plan_compatibility, reshard_checkpoint


def _manifest(directory, step):
    path = os.path.join(directory, _STEP_FMT.format(step), MANIFEST_NAME)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _nbytes(manifest):
    return sum(int(e["nbytes"]) for e in manifest.get("arrays", {}).values())


def _scanner(directory):
    """A manager that only scans ``directory`` (no trainer, no reaping)."""
    mgr = CheckpointManager.__new__(CheckpointManager)
    mgr.directory = os.path.abspath(directory)
    return mgr


def cmd_list(args):
    mgr = _scanner(args.dir)
    steps = mgr.steps()
    if args.json:
        rows = []
        for s in steps:
            m = _manifest(mgr.directory, s)
            rows.append({"step": s, "time": m.get("time"),
                         "reason": m.get("reason"), "mode": m.get("mode"),
                         "arrays": len(m.get("arrays", {})),
                         "nbytes": _nbytes(m)})
        print(json.dumps({"directory": mgr.directory, "steps": rows},
                         indent=1))
    else:
        if not steps:
            print(f"no committed checkpoints in {mgr.directory}")
            return 2
        print(f"{'step':>10}  {'reason':<10} {'mode':<10} "
              f"{'arrays':>7} {'MB':>9}")
        for s in steps:
            m = _manifest(mgr.directory, s)
            print(f"{s:>10}  {m.get('reason', '?'):<10} "
                  f"{m.get('mode', '?'):<10} {len(m.get('arrays', {})):>7} "
                  f"{_nbytes(m) / 1e6:>9.2f}")
    return 0


def cmd_inspect(args):
    mgr = _scanner(args.dir)
    step = args.step
    if step is None:
        step = mgr.latest_step()
        if step is None:
            print(f"no committed checkpoints in {mgr.directory}",
                  file=sys.stderr)
            return 2
    try:
        m = _manifest(mgr.directory, step)
    except FileNotFoundError:
        raise CheckpointNotFound(
            f"no committed checkpoint for step {step}") from None
    if args.json:
        print(json.dumps(m, indent=1, sort_keys=True))
        return 0
    print(f"checkpoint step {m['step']}  (format {m['format_version']}, "
          f"library {m.get('library_version')})")
    print(f"  mode={m.get('mode')} world_size={m.get('world_size')} "
          f"reason={m.get('reason')}")
    meta = m.get("meta", {})
    print(f"  params={meta.get('num_params')} "
          f"optimizer num_update={meta.get('optimizer', {}).get('num_update')}")
    if meta.get("user_state") is not None:
        print(f"  user_state={meta['user_state']}")
    print(f"  arrays={len(m.get('arrays', {}))} total "
          f"{_nbytes(m) / 1e6:.2f} MB")
    return 0


def _target_plan(mesh):
    """'replicated'/'none' -> None, else an axes spelling ('dp=2,fsdp=2')
    for plan_compatibility / reshard_checkpoint."""
    if mesh is None or str(mesh).lower() in ("replicated", "none", ""):
        return None
    return str(mesh)


def cmd_verify(args):
    report = verify_checkpoint(args.dir, step=args.step)
    compat = None
    if args.mesh is not None and report.get("found"):
        saved = None
        try:
            m = _manifest(os.path.abspath(args.dir), report["step"])
            saved = (m.get("meta") or {}).get("sharding_plan")
        except FileNotFoundError:
            pass
        compat = plan_compatibility(saved, _target_plan(args.mesh))
        report["plan"] = compat
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        if report.get("ok"):
            print(f"OK step {report['step']}: {report['arrays']} arrays, "
                  f"{report['nbytes'] / 1e6:.2f} MB, checksums verified")
        else:
            for e in report.get("errors", []):
                print(f"FAIL: {e}", file=sys.stderr)
        if compat is not None:
            print(f"plan: saved {compat['saved_axes'] or 'replicated'} "
                  f"({compat['saved_world']} devices) vs target "
                  f"{compat['target_axes'] or 'replicated'} "
                  f"({compat['target_world']} devices) -> "
                  f"{compat['verdict']}")
            for note in compat["notes"]:
                print(f"  note: {note}")
    if report.get("ok"):
        return 0
    return 2 if not report.get("found") else 1


def cmd_reshard(args):
    report = reshard_checkpoint(
        args.dir, args.dest, _target_plan(args.mesh), step=args.step,
        target_world=args.world,
        mode="sharded" if args.sharded else "replicated")
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        c = report["compatibility"]
        print(f"resharded step {report['step']} -> {report['dst']}: "
              f"{report['arrays']} arrays, {report['nbytes'] / 1e6:.2f} MB")
        print(f"  plan {c['saved_axes'] or 'replicated'} "
              f"({c['saved_world']} devices) -> "
              f"{c['target_axes'] or 'replicated'} "
              f"({c['target_world']} devices)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("list", cmd_list), ("inspect", cmd_inspect),
                     ("verify", cmd_verify), ("reshard", cmd_reshard)):
        p = sub.add_parser(name)
        p.add_argument("dir", help="checkpoint directory")
        p.add_argument("--step", type=int, default=None,
                       help="checkpoint step (default: latest)")
        p.add_argument("--json", action="store_true",
                       help="machine-readable output")
        if name in ("verify", "reshard"):
            p.add_argument("--mesh", default=None,
                           help="target mesh axes ('dp=2,fsdp=2') or "
                                "'replicated'")
        if name == "reshard":
            p.add_argument("--dest", required=True,
                           help="directory for the resharded checkpoint")
            p.add_argument("--world", type=int, default=1,
                           help="target world size (shard-file count)")
            p.add_argument("--sharded", action="store_true",
                           help="split the payload round-robin into "
                                "per-rank shard files")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
