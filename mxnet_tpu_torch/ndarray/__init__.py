"""``mx.nd``: the legacy imperative namespace (counterpart of
mxnet_tpu/ndarray/__init__.py).

Filled from the op registry as the JAX package's is (``register.py``):
every registered op (``ops/tensor.py``, ``nn.py``, ``legacy.py``,
``vision.py``, ``linalg.py``, ``optimizer_ops.py``, ``random_legacy.py``,
``flash_attention.py``) resolves as ``mx.nd.<name>`` with the reference's
call signature, over NDArrays and recorded inside ``autograd.record()``.
The hand-written functions below win over the generated ones: the stateful
``BatchNorm`` and ``Dropout``, the update ops that write their states in
place, the legacy random spellings. Creation comes from ``mx.np``;
``arange`` keeps the legacy float32 default and ``repeat``.
"""
from __future__ import annotations

from ..ops import flash_attention as _fa  # noqa: F401 - registers the ops
from ..ops import legacy as _legacy  # noqa: F401
from ..ops import linalg as _linalg_ops  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import np_linalg as _np_linalg  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import random_legacy as _random_legacy  # noqa: F401
from ..ops import tensor as _tensor  # noqa: F401
from ..ops import vision as _vision  # noqa: F401
from ..ops.registry import get_op
from . import random, register, sparse, utils  # noqa: F401
from .ndarray import NDArray, apply_op, waitall  # noqa: F401
from .sparse import (BaseSparseNDArray, CSRNDArray,  # noqa: F401
                     RowSparseNDArray)
from .register import make_eager, populate, write_into
from .utils import load, save, savez  # noqa: F401

# the frontends that register ops of their own (the _npi_* samplers, the
# _npx_* spellings, control flow), so that populate below sees every op
from .. import numpy_extension as _numpy_extension  # noqa: F401
from ..numpy import random as _np_random  # noqa: F401


#: taken from mx.np at first use (mx.np imports this package's NDArray)
_FROM_NP = ("array", "concatenate", "full", "linspace", "maximum",
            "minimum", "ones", "ones_like", "power", "zeros", "zeros_like",
            "add", "multiply", "subtract")
_SUBMODULES = {"np": "numpy", "numpy": "numpy", "npx": "numpy_extension",
               "numpy_extension": "numpy_extension"}


def __getattr__(name):
    import importlib

    if name in _FROM_NP:
        return getattr(importlib.import_module("..numpy", __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"..{_SUBMODULES[name]}", __name__)
    if name in ("linalg", "op", "_internal"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def arange(start, stop=None, step=1.0, repeat=1, infer_range=None,
           ctx=None, dtype="float32", **kwargs):  # noqa: ARG001
    """Legacy arange (ndarray.py:3510 of the reference): float32 even for
    int arguments; ``repeat`` repeats each element in place."""
    from ..numpy import arange as _np_arange

    out = _np_arange(start, stop, step, dtype=dtype, ctx=ctx)
    return out.repeat(repeat) if repeat != 1 else out


def empty(shape, ctx=None, dtype=None):
    """Zero-filled, as the JAX package's."""
    from ..numpy import zeros

    return zeros(shape, dtype=dtype, ctx=ctx)


def from_jax(x):
    """An NDArray sharing the memory of an array of another framework
    through DLPack (``__dlpack__``), a JAX array among them."""
    import torch

    return NDArray(torch.from_dlpack(x))


def split_v2(ary, indices_or_sections, axis=0, squeeze_axis=False):
    """The reference's split_v2 (matrix_op.cc): an int is that many equal
    sections, a sequence the cut points; ``squeeze_axis`` drops the axis
    when each section has extent 1."""
    from ..numpy import split

    outs = list(split(ary, indices_or_sections, axis=axis))
    return [o.squeeze(axis=axis) for o in outs] if squeeze_axis else outs


# -- the stateful ops: hand-written, ahead of the generated corpus --------

def Dropout(data, p=0.5, mode="training", axes=None, **kwargs):  # noqa: ARG001, N802
    """Inverted dropout while training (or ``mode="always"``), the mask
    from the device's generator."""
    from ..numpy_extension import dropout as _npx_dropout

    return _npx_dropout(data, p=p, axes=axes, mode=mode)


def dropout(data, p=0.5, mode="training", axes=None, **kwargs):  # noqa: ARG001
    return Dropout(data, p=p, mode=mode, axes=axes)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,  # noqa: N802
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, **kwargs):  # noqa: ARG001
    """The stateful BatchNorm of the JAX package's ``mx.nd``
    (ndarray/__init__.py:123): ``npx.batch_norm`` with the legacy
    defaults (``eps=1e-3``, ``fix_gamma=True``): while training the batch
    statistics normalize, through K1/K2 on a card, and the moving ones
    are updated in place; otherwise the moving statistics normalize. The
    registry's pure ``BatchNorm`` (ops/legacy.py) is
    ``mx.nd._internal.BatchNorm``."""
    from ..numpy_extension import batch_norm

    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats,
                      output_mean_var=output_mean_var, axis=axis)


def shuffle(data, **kwargs):  # noqa: ARG001
    from ..numpy.random import permutation

    return permutation(data)


# the legacy top-level random_* names over nd.random; only exponential
# differs: the legacy op takes the rate lam = 1 / scale (sample_op.cc)
random_uniform = random.uniform
random_normal = random.normal
random_gamma = random.gamma
random_poisson = random.poisson
random_negative_binomial = random.negative_binomial
random_generalized_negative_binomial = random.generalized_negative_binomial
random_randint = random.randint


def random_exponential(lam=1.0, shape=None, dtype=None, ctx=None, out=None,
                       **kwargs):  # noqa: ARG001
    return random.exponential(1.0 / lam, shape=shape, dtype=dtype, ctx=ctx,
                              out=out)


# sample_*: the registry's per-row samplers (ops/random_legacy.py), each
# drawing ``shape`` samples for every element of its parameter arrays
for _d in ("uniform", "normal", "gamma", "exponential", "poisson"):
    globals()[f"sample_{_d}"] = make_eager(f"sample_{_d}",
                                           get_op(f"_sample_{_d}"))
del _d
sample_multinomial = random.multinomial


def _stateful_update(op_name, n_state):
    """The update op ``op_name`` with the reference's in-place convention
    (optimizer_op.cc FMutateInputs): its ``n_state`` state arrays, after
    weight and grad, take their new values in their own storage, and the
    new weight goes into ``out`` (or is returned)."""
    eager = make_eager(op_name, get_op(op_name))

    def update(weight, grad, *args, out=None, **kwargs):
        states = args[:n_state]
        res = eager(weight, grad, *states, *args[n_state:], **kwargs)
        for st, new in zip(states, res[1:]):
            write_into(st, new)
        return write_into(out, res[0]) if out is not None else res[0]

    update.__name__ = update.__qualname__ = op_name
    return update


for _opname, _nstate in (
        ("sgd_mom_update", 1), ("nag_mom_update", 1), ("signum_update", 1),
        ("adam_update", 2), ("adamw_update", 2), ("lamb_update_phase1", 2),
        ("rmsprop_update", 1), ("rmspropalex_update", 3), ("ftrl_update", 2),
        ("adagrad_update", 1), ("adadelta_update", 2)):
    globals()[_opname] = _stateful_update(_opname, _nstate)
del _opname, _nstate

populate(globals())

ElementWiseSum = globals()["add_n"]  # noqa: N816
