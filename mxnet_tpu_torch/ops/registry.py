"""Operator registry (counterpart of mxnet_tpu/ops/registry.py:16-32).

An op is a plain function over ``torch.Tensor``s; autograd comes from
torch's tape, so the registry holds nothing beyond the function. It exists
for discoverability and for the ``mx.nd`` namespace, which wraps every
registered op for NDArrays (``ndarray/__init__.py``).
"""
from __future__ import annotations

__all__ = ["register_op", "get_op", "list_ops"]

_OPS = {}


def register_op(name, fn=None):
    """Register ``fn`` (a function over tensors) as the operator ``name``;
    usable as a decorator."""
    def _do(f):
        _OPS[name] = f
        return f

    if fn is not None:
        return _do(fn)
    return _do


def get_op(name):
    return _OPS[name]


def list_ops():
    return sorted(_OPS)
