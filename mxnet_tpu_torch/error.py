"""Typed framework errors (counterpart of mxnet_tpu/error.py): classes for
``except`` clauses, each a subclass of ``MXNetError`` and of the Python
exception of its name."""
from .base import MXNetError

__all__ = ["MXNetError", "InternalError", "ValueError", "TypeError",
           "IndexError", "NotImplementedForSymbol", "register"]


class InternalError(MXNetError):
    """Framework-internal invariant violation."""


class NotImplementedForSymbol(MXNetError):
    def __init__(self, function, alias=None, *args):  # noqa: ARG002
        super().__init__(f"{getattr(function, '__name__', function)} is "
                         "not supported for Symbol")


ValueError = type("ValueError", (MXNetError, ValueError), {})  # noqa: A001
TypeError = type("TypeError", (MXNetError, TypeError), {})      # noqa: A001
IndexError = type("IndexError", (MXNetError, IndexError), {})   # noqa: A001

_ERR_REGISTRY = {}


def register(cls):
    """Register an error class by name."""
    _ERR_REGISTRY[cls.__name__] = cls
    return cls
