"""Launch a data-parallel job of N local ranks (counterpart of
tools/launch.py, which wires ranks into a ``jax.distributed`` job).

    python -m mxnet_tpu_torch.tools.launch -n 2 \\
        python -m mxnet_tpu_torch.tools.distributed_train

The launcher holds the job's ``torch.distributed`` store on a port the
system picks when it binds, so no other job can take that port first;
each rank runs the command with the store's address and
``MXTPU_LAUNCHER_STORE=1`` (every rank joins as a client), in the JAX
launcher's variables
(``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_RANK``; ``DMLC_NUM_WORKER``,
``DMLC_WORKER_ID``) and torch's (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), which
``kvstore.tpu_dist.init_distributed_from_env`` reads. When a rank exits
with a nonzero code the others are killed and the launcher returns that
code (the first nonzero one); ``--timeout`` kills every rank after that
many seconds and returns 124.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch", "rank_env", "main"]


def _job_store():
    """The job's store, bound here on port 0: the system's free port."""
    from torch.distributed import TCPStore

    return TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)


def rank_env(n, rank, port, addr="127.0.0.1"):
    """The variables that place one rank in a job of ``n`` on this host."""
    return {
        "MXTPU_NUM_WORKERS": str(n), "MXTPU_WORKER_RANK": str(rank),
        "DMLC_NUM_WORKER": str(n), "DMLC_WORKER_ID": str(rank),
        "MASTER_ADDR": addr, "MASTER_PORT": str(port),
        "RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(n), "MXTPU_LAUNCHER_STORE": "1"}


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def launch(n, cmd, env_extra=None, timeout=None):
    """Run ``cmd`` as ``n`` ranks and wait for them; the first nonzero exit
    code (a signal counts as 1), 124 after ``timeout`` seconds, else 0."""
    store = _job_store()
    port = store.port
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update(rank_env(n, rank, port))
            # a session of its own, so that a kill takes its children too
            procs.append(subprocess.Popen(cmd, env=env,
                                          start_new_session=True))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0] if failed[0] > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                return 124
            time.sleep(0.05)
    finally:
        _stop(procs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("--launcher", default="local", choices=["local"],
                   help="local ranks only")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before every rank is killed (exit 124)")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.command:
        p.error("no command given")
    sys.exit(launch(args.num_workers, args.command, timeout=args.timeout))


if __name__ == "__main__":
    main()
