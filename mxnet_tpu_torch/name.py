"""Name manager (counterpart of mxnet_tpu/name.py): ``NameManager`` and
``Prefix`` scopes that give auto names per op type."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_local = threading.local()


class NameManager:
    """Assigns unique names per op type; usable as a context manager."""

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return f"{hint}{i}"

    def __enter__(self):
        self._old = current()
        _local.manager = self
        return self

    def __exit__(self, *exc):
        _local.manager = self._old


class Prefix(NameManager):
    """Prepends a prefix to every auto name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return name if name else self._prefix + super().get(None, hint)


def current():
    mgr = getattr(_local, "manager", None)
    if mgr is None:
        mgr = NameManager()
        _local.manager = mgr
    return mgr
