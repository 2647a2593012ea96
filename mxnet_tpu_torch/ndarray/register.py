"""NDArray functions generated from the op registry (counterpart of
mxnet_tpu/ndarray/register.py).

Every registered op is a plain function over ``torch.Tensor``s;
:func:`make_eager` wraps one for NDArrays (recorded inside
``autograd.record()`` through ``apply_op``) and :func:`populate` fills a
namespace with such wrappers. ``mx.nd``, ``mx.nd.linalg`` and ``mx.npx``
are filled by the same function.
"""
from __future__ import annotations

import functools

import torch

from ..ops.registry import _OPS
from .ndarray import NDArray, apply_op

__all__ = ["make_eager", "populate", "write_into"]


def write_into(dst, src):
    """Give the NDArray ``dst`` the value of ``src`` (an NDArray or a
    tensor) and return ``dst``.

    A result that autograd records (it requires grad), or a ``dst`` whose
    tensor is itself part of a recorded graph, is rebound as the JAX
    package's ``_assign_from`` does: ``dst`` takes the result's tensor, so
    gradients flow through ``out=`` and no tensor that autograd saved is
    written. Any other result (an update op's new weight, a sample, the
    running statistics) is copied into ``dst``'s own storage, so the tensor
    that a Parameter, a captured CUDA graph or another handle holds keeps
    its identity and takes the new value. A shape or dtype that differs
    raises, as a copy into a buffer of another layout would."""
    data = src._data if isinstance(src, NDArray) else src
    if (tuple(data.shape), data.dtype) != (tuple(dst._data.shape),
                                           dst._data.dtype):
        raise ValueError(
            f"out= is {tuple(dst._data.shape)} {dst._data.dtype}, the "
            f"result {tuple(data.shape)} {data.dtype}")
    if data.requires_grad or dst._data.grad_fn is not None:
        dst._assign(data)
        return dst
    with torch.no_grad():
        dst._data.copy_(data)
    dst._version += 1
    return dst


def _find(value, slots, where):
    """Record in ``slots`` the NDArrays of an argument: ``value`` itself,
    or the items of a list or tuple (``multi_dot``'s, ``add_n``'s)."""
    if isinstance(value, NDArray):
        slots.append((where, None))
    elif isinstance(value, (list, tuple)):
        slots.extend((where, j) for j, v in enumerate(value)
                     if isinstance(v, NDArray))


def make_eager(name, fn):
    """An NDArray function from the registered op ``fn``: NDArrays among
    the positional and keyword arguments, and inside list or tuple
    arguments, run through ``apply_op``; anything else passes as it is.
    ``out=`` (an NDArray, or a sequence of them for an op of several
    outputs) takes the result by :func:`write_into` and is returned."""

    @functools.wraps(fn)
    def eager(*args, out=None, **kwargs):
        slots = []
        for i, a in enumerate(args):
            _find(a, slots, i)
        for k, v in kwargs.items():
            _find(v, slots, k)

        def get(where, j):
            a = args[where] if isinstance(where, int) else kwargs[where]
            return a if j is None else a[j]

        def pure(*xs):
            call, kw = list(args), dict(kwargs)
            for (where, j), x in zip(slots, xs):
                box = call if isinstance(where, int) else kw
                if j is None:
                    box[where] = x
                else:   # the list or tuple, with this item replaced
                    seq = [*box[where][:j], x, *box[where][j + 1:]]
                    box[where] = tuple(seq) if isinstance(
                        box[where], tuple) else seq
            return fn(*call, **kw)

        res = apply_op(pure, *[get(w, j) for w, j in slots])
        if out is None:
            return res
        if isinstance(out, (list, tuple)):
            for o, r in zip(out, res):
                write_into(o, r)
            return out
        return write_into(out, res if isinstance(res, NDArray) else res[0])

    eager.__name__ = eager.__qualname__ = name
    return eager


def populate(namespace, predicate=None, rename=None):
    """Install an eager wrapper of every registered op into ``namespace``
    (a module's ``globals()``), under ``rename(op name)`` where given and
    only for the names ``predicate`` accepts. A name the namespace already
    holds is left alone: the hand-written functions win. Returns the names
    installed."""
    installed = []
    for opname, fn in sorted(_OPS.items()):
        if predicate is not None and not predicate(opname):
            continue
        name = rename(opname) if rename else opname
        if name in namespace:
            continue
        namespace[name] = make_eager(opname, fn)
        installed.append(name)
    return installed
