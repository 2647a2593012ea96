"""Checkpoint IO on the port's own IO threads (counterpart of
mxnet_tpu/_checkpoint_io.py).

The JAX package pushes save work through its native dependency engine, one
engine variable a checkpoint path. The port has no engine (ROADMAP.md queue
1 item 11), so it keeps the same contract with a FIFO a path, keyed by the
absolute path, drained by an IO thread of its own that exists while the
FIFO holds work:

  * training continues while a ``.npz`` serializes on the IO thread,
  * ops queued on one path run one at a time, in the order queued (ops on
    different paths run concurrently),
  * a load (or ``mx.waitall()``) blocks until the pending ops of its path
    have run, and the first failed op's exception is raised there: the
    ORIGINAL exception object, its IO-thread traceback intact.

Every write is asynchronous; nothing here falls back to writing inline.
:func:`async_run` takes any callable: checkpoint/manager.py chains a payload
write and then a manifest-and-rename commit on one path, so the commit can
never overtake the write. A failed op does not stop the ops queued after it
(the commit peeks :func:`pending_error` and refuses to run on top of a
failed write).

At interpreter exit every path is drained; an unconsumed failure (a final
checkpoint write that failed and that nobody waited for) is printed and the
process exits 1, as the JAX package's engine shutdown does
(mxnet_tpu/_native.py), so a scheduler sees the loss.
"""
from __future__ import annotations

import atexit
import collections
import os
import sys
import threading
import traceback

import numpy as _np

__all__ = ["async_save_npz", "async_run", "wait_for_path", "flush_all",
           "pending_error", "reap_idle"]

_lock = threading.Lock()
_chains = {}     # key -> _Chain of the ops queued on that path
_errors = {}     # key -> first failed op's ORIGINAL exception (tb attached)
_exit_hook = []  # non-empty once the at-exit drain is registered


class _Chain:
    """The FIFO of one path: ``ops`` not yet started, ``pending`` ops
    queued and not finished (the one running included), ``idle`` notified
    when ``pending`` drops to 0. An IO thread drains it while ``pending``
    is positive."""

    __slots__ = ("ops", "pending", "idle")

    def __init__(self):
        self.ops = collections.deque()
        self.pending = 0
        self.idle = threading.Condition(_lock)


def _key(path):
    # canonical key: save('ck') and load(abspath('ck')) must synchronize
    return os.path.abspath(str(path))


def _drain(key, chain):
    """The IO thread of ``chain``: runs its ops in order and ends when the
    FIFO is empty (the next :func:`async_run` starts another)."""
    while True:
        with _lock:
            fn = chain.ops.popleft()
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - kept for the waiter
            with _lock:
                # keep the FIRST failure per path; a later success does
                # not unrecord it (the op sequence is already broken)
                _errors.setdefault(key, e)
        with _lock:
            chain.pending -= 1
            if chain.pending == 0:
                chain.idle.notify_all()
                return


def async_run(path, fn):
    """Run ``fn()`` on an IO thread, after every op already queued on
    ``path``. Returns at once; :func:`wait_for_path` barriers and raises a
    failed op's original exception."""
    key = _key(path)
    with _lock:
        if not _exit_hook:
            atexit.register(_drain_at_exit)
            _exit_hook.append(True)
        chain = _chains.get(key)
        if chain is None:
            chain = _chains[key] = _Chain()
        chain.ops.append(fn)
        chain.pending += 1
        start = chain.pending == 1   # no IO thread is draining it
    if start:
        threading.Thread(target=_drain, args=(key, chain), daemon=True,
                         name="mxtpu-checkpoint-io").start()


def async_save_npz(path, arrays):
    """Write ``arrays`` (name -> numpy array or tensor) to ``path`` as an
    ``.npz`` on the IO chain. The host copies (and the bf16 bit views) are
    taken before this returns, so the caller may change its tensors at
    once; :func:`wait_for_path` (or ``mx.waitall()``) barriers."""
    from ._dtype_codec import encode_payload

    path = _key(path)  # bind the directory at save time, not flush time
    arrays = encode_payload(arrays)  # bf16 -> uint16 view + dtype sidecar

    def write():
        with open(path, "wb") as f:
            _np.savez(f, **arrays)

    async_run(path, write)


def pending_error(path):
    """The first recorded failure of ``path``'s op chain (or None). Does not
    consume the record: checkpoint commit ops peek at it to skip committing
    on top of a failed payload write."""
    with _lock:
        return _errors.get(_key(path))


def wait_for_path(path):
    """Block until the ops queued on ``path`` have run; raise the first
    failed op's ORIGINAL exception (its IO-thread traceback intact, so
    ``except <Type>`` clauses see the real type), consuming it."""
    key = _key(path)
    with _lock:
        chain = _chains.get(key)
        if chain is not None:
            while chain.pending:
                chain.idle.wait()
            if _chains.get(key) is chain and chain.pending == 0:
                del _chains[key]
        err = _errors.pop(key, None)
    if err is not None:
        raise err


def flush_all():
    """Barrier EVERY path with pending ops or an unconsumed failure (the
    preemption handler's pre-exit fence: an emergency snapshot must not
    exit before earlier saves land). Waits every path even when one fails;
    raises the first failure afterwards."""
    with _lock:
        keys = list(dict.fromkeys([*_chains, *_errors]))
    first = None
    for k in keys:
        try:
            wait_for_path(k)
        except Exception as e:  # noqa: BLE001, PERF203 - drain the rest
            if first is None:
                first = e
    if first is not None:
        raise first


def reap_idle():
    """Drop the bookkeeping of every idle path: ``mx.waitall()`` calls it
    after draining, so saves to paths that are never loaded do not grow
    the map."""
    with _lock:
        for k in [k for k, c in _chains.items() if c.pending == 0]:
            del _chains[k]


def _drain_at_exit():
    """Interpreter exit: drain every path; a failure nobody consumed
    turns the exit into 1 (module note)."""
    try:
        flush_all()
    except Exception as e:  # noqa: BLE001 - reported, then exit 1
        traceback.print_exception(e, file=sys.stderr)
        print(f"[mxtpu] checkpoint IO failed at exit (lost async write?): "
              f"{e!r}", file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _after_fork_in_child():
    # the parent's IO threads do not exist in a forked child: forget their
    # chains, or a wait there would block for ever
    global _lock
    _lock = threading.Lock()
    _chains.clear()
    _errors.clear()


os.register_at_fork(after_in_child=_after_fork_in_child)
