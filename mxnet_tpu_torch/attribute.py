"""Attribute scopes (counterpart of mxnet_tpu/attribute.py): ``AttrScope``
attaches key/value attributes to what is created inside the scope."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_local = threading.local()


class AttrScope:
    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings")
        self._attrs = kwargs  # own attributes only; never changed
        self._old = None
        self._effective = None  # the merged view while entered

    def get(self, attrs=None):
        """The scope's attributes merged with ``attrs`` (``attrs`` win)."""
        out = dict(self._effective if self._effective is not None
                   else self._attrs)
        if attrs:
            out.update(attrs)
        return out

    def __enter__(self):
        self._old = current()
        parent = self._old._effective if self._old._effective is not None \
            else self._old._attrs
        merged = dict(parent)
        merged.update(self._attrs)
        self._effective = merged
        _local.scope = self
        return self

    def __exit__(self, *exc):
        self._effective = None
        _local.scope = self._old


def current():
    sc = getattr(_local, "scope", None)
    if sc is None:
        sc = AttrScope()
        _local.scope = sc
    return sc
