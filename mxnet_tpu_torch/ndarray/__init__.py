"""``mx.nd``: the legacy imperative namespace (counterpart of
mxnet_tpu/ndarray/__init__.py).

Filled from the op registry as the JAX package's is (``register.py``
there): every op of ``ops/tensor.py`` resolves as ``mx.nd.<name>`` with
the reference's call signature, over NDArrays and recorded inside
``autograd.record()``. Creation comes from ``mx.np``; ``arange`` keeps the
legacy float32 default and ``repeat``.
"""
from __future__ import annotations

import functools

from ..ops import tensor as _tensor  # noqa: F401 - registers the ops
from ..ops.registry import _OPS
from . import random, utils  # noqa: F401
from .ndarray import NDArray, apply_op, waitall  # noqa: F401
from .utils import load, save  # noqa: F401


#: taken from mx.np at first use (mx.np imports this package's NDArray)
_FROM_NP = ("array", "concatenate", "full", "maximum", "minimum", "ones",
            "ones_like", "power", "zeros", "zeros_like")


def __getattr__(name):
    if name in _FROM_NP:
        from .. import numpy as _np_mod

        return getattr(_np_mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32",
           **kwargs):  # noqa: ARG001
    """Legacy arange (ndarray.py:3510 of the reference): float32 even for
    int arguments; ``repeat`` repeats each element in place."""
    from ..numpy import arange as _np_arange

    out = _np_arange(start, stop, step, dtype=dtype, ctx=ctx)
    return out.repeat(repeat) if repeat != 1 else out


def empty(shape, ctx=None, dtype=None):
    """Zero-filled, as the JAX package's."""
    from ..numpy import zeros

    return zeros(shape, dtype=dtype, ctx=ctx)


def make_eager(name, fn):
    """An NDArray function from the registered op ``fn``: NDArrays among
    the positional and keyword arguments run through ``apply_op``; ``out=``
    takes the result in place (ndarray/register.py:make_eager)."""

    @functools.wraps(fn)
    def eager(*args, out=None, **kwargs):
        pos = [i for i, a in enumerate(args) if isinstance(a, NDArray)]
        keys = [k for k, v in kwargs.items() if isinstance(v, NDArray)]

        def pure(*xs):
            call, kw = list(args), dict(kwargs)
            for i, x in zip(pos, xs):
                call[i] = x
            for k, x in zip(keys, xs[len(pos):]):
                kw[k] = x
            return fn(*call, **kw)

        res = apply_op(pure, *[args[i] for i in pos],
                       *[kwargs[k] for k in keys])
        if out is not None:
            out._assign((res if isinstance(res, NDArray) else res[0])._data)
            return out
        return res

    eager.__name__ = eager.__qualname__ = name
    return eager


def _populate(namespace):
    for opname, fn in sorted(_OPS.items()):
        if opname not in namespace:   # the hand-written functions win
            namespace[opname] = make_eager(opname, fn)


_populate(globals())
