"""Preemption-to-checkpoint: signal -> emergency snapshot -> clean exit
(counterpart of mxnet_tpu/checkpoint/preemption.py).

Schedulers announce eviction with SIGTERM (or SIGUSR1 under some launchers)
and grant a grace window. The handler turns that notice into a SYNCHRONOUS
snapshot (async would race the kill), fences every still-pending earlier
save with ``_checkpoint_io.flush_all()``, then exits with a configurable
code: zero by default, so supervisors see a clean, resumable shutdown
rather than a crash loop. If the emergency snapshot itself FAILS the
process exits 1 whatever the configured code: the state was not saved, and
reporting it as resumable would be a lie.

Signal handlers must be installed from the main thread (CPython rule) and
the handler body itself runs on the main thread, between two bytecodes of
the training loop: on the card that is between steps as the host sees
them, and the snapshot synchronizes the card before it copies (the work of
the step the host last queued lands in the snapshot). It is also where the
collective barrier of a distributed save is legal. The JAX package also
writes the eviction into its flight record and a postmortem dump; the port
has neither yet (ROADMAP.md queue 1 item 11), and the JAX package ignores
their failures, so no exit code or file differs for their absence.
"""
from __future__ import annotations

import signal
import sys
import threading
import traceback

from .. import _checkpoint_io
from ..diagnostics import spans as _spans

__all__ = ["PreemptionHandler", "install_preemption_handler"]


def _parse_signals(spec):
    out = []
    for name in str(spec).split(","):
        name = name.strip().upper()
        if not name:
            continue
        if not name.startswith("SIG"):
            name = "SIG" + name
        sig = getattr(signal, name, None)
        if sig is None:
            raise ValueError(f"unknown signal {name!r}")
        out.append(sig)
    return out


class PreemptionHandler:
    """Installs signal handlers that snapshot through ``manager`` and exit.

    Use as a context manager or call install()/uninstall() explicitly;
    uninstall restores the previous handlers. ``preempted`` flips True
    before the snapshot starts, so polling loops can also drain gracefully
    when ``exit=False``.
    """

    def __init__(self, manager, signals=None, exit_code=None, exit=True,
                 user_state_fn=None):
        from .. import env as _env

        self.manager = manager
        if signals is None:
            signals = _parse_signals(_env.get("MXTPU_CKPT_PREEMPT_SIGNALS"))
        elif isinstance(signals, str):
            signals = _parse_signals(signals)
        self.signals = list(signals)
        self.exit_code = _env.get("MXTPU_CKPT_PREEMPT_EXIT_CODE") \
            if exit_code is None else int(exit_code)
        self.exit = bool(exit)
        self.user_state_fn = user_state_fn
        self.preempted = False
        self._prev = {}
        self._installed = False
        self._once = threading.Lock()   # double-delivery guard

    def install(self):
        if self._installed:
            return self
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # non-main thread / teardown
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _on_signal(self, signum, frame):  # noqa: ARG002
        if not self._once.acquire(blocking=False):
            return  # second delivery while the snapshot runs: ignore
        self.preempted = True
        saved = False
        try:
            user_state = self.user_state_fn() if self.user_state_fn \
                else None
            with _spans.span("ckpt.preempt", cat="checkpoint"):
                self.manager.save(sync=True, reason="preempt",
                                  user_state=user_state)
                _checkpoint_io.flush_all()  # earlier async saves too
            saved = True
        except BaseException:
            # a FAILED emergency snapshot must not masquerade as a clean,
            # resumable shutdown: the supervisor would believe the latest
            # state was saved when it was not
            if not self.exit:
                self._once.release()  # stay armed for a retry
                raise
            traceback.print_exc(file=sys.stderr)
            print("mxnet_tpu_torch.checkpoint: emergency preemption "
                  "snapshot FAILED; exiting 1 (latest state NOT saved)",
                  file=sys.stderr)
        if self.exit:
            sys.exit(self.exit_code if saved else 1)
        self._once.release()  # stay armed for a later re-delivery


def install_preemption_handler(manager, **kwargs):
    """Convenience: build + install, returning the handler (for
    ``uninstall()`` or ``preempted`` polling)."""
    return PreemptionHandler(manager, **kwargs).install()
