"""Carry weights and optimizer states across from the JAX package.

``load_jax_params(block, params)`` takes ``{name: numpy array}`` as the JAX
package's ``collect_params()`` gives them (``p.data().asnumpy()``) and
copies each into the port block's parameter of the same dotted name,
BatchNorm's running stats (``grad_req='null'``) and channels-last
convolution weights ``(O, *k, I/g)`` included: the two packages declare the
same names and shapes.
``load_jax_trainer_states(trainer, states)`` does the same for a Trainer's
optimizer states (masters, momenta, Adam's m and v, the update counts), so
that both packages take the same step k+1.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_tensor", "load_jax_params", "load_jax_trainer_states"]


def to_tensor(arr):
    """A CPU tensor from a numpy array. bfloat16 arrays (``ml_dtypes``,
    as JAX hands them out) convert by bit view, their 16-bit patterns
    reinterpreted as ``torch.bfloat16``, never through a wider float."""
    arr = np.array(arr)  # a writable, contiguous copy the tensor owns
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_jax_params(block, params):
    """Copy ``params`` into ``block``'s parameters, strictly.

    Missing or unexpected names and shape mismatches raise; each value is
    cast to the port parameter's dtype and put on its device. The block
    must be initialized (or hold deferred-init parameters, which take
    their shape from the value)."""
    ours = block.collect_params()
    missing = sorted(set(ours) - set(params))
    unexpected = sorted(set(params) - set(ours))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in ours.items():
        value = to_tensor(params[name])
        # a deferred dim (0) takes the value's; a known one must match
        # (the shape setter raises ValueError on a mismatch)
        p.shape = tuple(value.shape)
        p.set_data(value)
    return block


def _state_to_tensors(state):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_state_to_tensors(s) for s in state)
    return to_tensor(state)


def load_jax_trainer_states(trainer, states):
    """Put the JAX Trainer's optimizer states into the port's ``trainer``.

    ``states`` is a dict with ``"states"``: ``{parameter name: state}``,
    each state as the JAX optimizer nests it (None, an array, a tuple of
    arrays, or ``(master, inner)`` under multi-precision) with numpy
    leaves; ``"index_update_count"``: ``{parameter name: t}``; and
    ``"num_update"``. Names are the dotted names both Trainers were built
    from (``collect_params()``). Every trainable parameter of the port's
    trainer must be named. Each state goes in as ``Trainer.load_states``
    puts it: copied into an existing state of the same nesting, shapes and
    dtypes, else onto the parameter's device."""
    names = trainer._param_names
    given = states["states"]
    trainable = [n for n, p in zip(names, trainer._params)
                 if p.grad_req != "null"]
    missing = sorted(set(trainable) - set(given))
    unexpected = sorted(set(given) - set(names))
    if missing or unexpected:
        raise KeyError(f"state names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    counts = states.get("index_update_count") or {}
    opt = trainer._optimizer
    opt._index_update_count = {}
    for i, name in enumerate(names):
        if name in given:
            trainer._put_state(i, _state_to_tensors(given[name]))
        if name in counts:
            opt._index_update_count[i] = int(counts[name])
    opt.num_update = int(states.get("num_update", 0))
    return trainer
