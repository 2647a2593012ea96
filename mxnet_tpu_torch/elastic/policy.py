"""Restart policy and restart ledger (counterpart of
mxnet_tpu/elastic/policy.py).

Pure decision logic: a supervisor feeds it exit observations and it
answers restart / give_up with a backoff, so the policy is testable
without launching a process. The supervisor loop that drives it (the JAX
package's tools/supervisor.py) is ported with the pipeline and MoE
schedules (ROADMAP.md queue 1 item 9).

  * Clean exits (``MXTPU_CKPT_PREEMPT_EXIT_CODE``, the PreemptionHandler's
    snapshot-then-exit path, plus plain 0) mean the job FINISHED or was
    preempted resumably: the supervisor stops.
  * Any other exit is a rank death: restart from the latest good
    checkpoint onto the surviving devices, with exponential backoff
    (``MXTPU_ELASTIC_BACKOFF_S`` doubling up to
    ``MXTPU_ELASTIC_BACKOFF_MAX_S``) and a lifetime budget
    (``MXTPU_ELASTIC_MAX_RESTARTS``).

Every decision lands in a :class:`RestartLedger`: an append-only JSON
file, the record of which incarnations ran, why each ended, and what the
supervisor decided. The file is the JAX package's, read by either.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["RestartPolicy", "RestartLedger", "LEDGER_NAME"]

LEDGER_NAME = "restart_ledger.json"


def _env_get(name, default):
    from .. import env as _env

    try:
        return _env.get(name)
    except (KeyError, TypeError, ValueError):
        return default


class RestartPolicy:
    """Decides what the supervisor does after an incarnation exits."""

    def __init__(self, max_restarts=None, backoff_s=None,
                 backoff_max_s=None, clean_exit_codes=None):
        self.max_restarts = _env_get("MXTPU_ELASTIC_MAX_RESTARTS", 3) \
            if max_restarts is None else int(max_restarts)
        self.backoff_s = _env_get("MXTPU_ELASTIC_BACKOFF_S", 1.0) \
            if backoff_s is None else float(backoff_s)
        self.backoff_max_s = _env_get("MXTPU_ELASTIC_BACKOFF_MAX_S", 30.0) \
            if backoff_max_s is None else float(backoff_max_s)
        if clean_exit_codes is None:
            preempt = _env_get("MXTPU_CKPT_PREEMPT_EXIT_CODE", 0)
            clean_exit_codes = {0, int(preempt)}
        self.clean_exit_codes = frozenset(int(c) for c in clean_exit_codes)
        self.restarts = 0

    def is_clean(self, exit_code):
        """True for the resumable-shutdown contract: 0 or the
        PreemptionHandler's MXTPU_CKPT_PREEMPT_EXIT_CODE."""
        return exit_code in self.clean_exit_codes

    def backoff(self, restart_index=None):
        """Delay before restart N (0-based): base * 2^N, capped."""
        n = self.restarts if restart_index is None else int(restart_index)
        return min(self.backoff_s * (2 ** n), self.backoff_max_s)

    def decide(self, exit_codes):
        """One incarnation ended with per-rank ``exit_codes`` (a dict
        {rank: code} or a list; None entries = killed by the supervisor
        during teardown, not counted as deaths). Returns a decision dict
        {'action': 'stop'|'restart'|'give_up', 'reason', 'backoff_s',
        'dead_ranks'} and (on restart) advances the restart counter.
        """
        if isinstance(exit_codes, dict):
            codes = exit_codes
        else:
            codes = dict(enumerate(exit_codes))
        dead = sorted(r for r, c in codes.items()
                      if c is not None and not self.is_clean(c))
        if not dead:
            return {"action": "stop", "reason": "clean_exit",
                    "backoff_s": 0.0, "dead_ranks": []}
        if self.max_restarts >= 0 and self.restarts >= self.max_restarts:
            return {"action": "give_up",
                    "reason": f"restart budget exhausted "
                              f"({self.max_restarts})",
                    "backoff_s": 0.0, "dead_ranks": dead}
        delay = self.backoff()
        self.restarts += 1
        return {"action": "restart", "reason": "rank_death",
                "backoff_s": delay, "dead_ranks": dead}


class RestartLedger:
    """Append-only restart history in ``directory``.

    One JSON document {'entries': [...]} rewritten atomically
    (tmp+replace) per append — a supervisor crash never truncates it,
    and fleet tooling can read it mid-run.
    """

    def __init__(self, directory):
        self.path = os.path.join(os.path.abspath(str(directory)),
                                 LEDGER_NAME)

    def entries(self):
        try:
            with open(self.path, encoding="utf-8") as f:
                return list(json.load(f).get("entries") or [])
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return []

    def append(self, **entry):
        entry.setdefault("time", time.time())
        entries = self.entries()
        entries.append(entry)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"entries": entries}, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        return entry
