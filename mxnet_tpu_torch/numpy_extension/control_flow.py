"""``npx.foreach``, ``npx.while_loop`` and ``npx.cond`` (counterpart of
mxnet_tpu/numpy_extension/control_flow.py).

The JAX package lowers them to ``lax.scan``, ``lax.while_loop`` and
``lax.cond`` so that a hybridized block can trace them. The port runs
each eagerly, a Python loop over the body on NDArrays, with the same
results: the per-step outputs stacked on a new first axis and the final
states; ``while_loop``'s outputs padded with zeros to ``max_iterations``
rows; ``cond`` the branch the predicate picks (read on the host). The
bodies' ops are recorded like any others, so gradients flow through
torch's tape.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(arrays):
    from ..numpy import stack

    return stack(arrays, axis=0)


def foreach(body, data, init_states):
    """``body(x_t, states) -> (out_t, new_states)`` over axis 0 of
    ``data`` (an NDArray or a list of them); returns ``(outputs stacked
    over the steps, final states)``, each a list where the body's was one
    of several."""
    multi_data = isinstance(data, (list, tuple))
    multi_state = isinstance(init_states, (list, tuple))
    datas = _as_list(data)
    states = _as_list(init_states)
    steps = []
    for t in range(datas[0].shape[0]):
        xs = [d[t] for d in datas]
        out, new_states = body(xs if multi_data else xs[0],
                               states if multi_state else states[0])
        steps.append(_as_list(out))
        states = _as_list(new_states)
    outs = tuple(_stack([s[i] for s in steps]) for i in range(len(steps[0])))
    return (outs if len(outs) > 1 else outs[0],
            states if multi_state else states[0])


def _tensor_of(v):
    return v if isinstance(v, NDArray) else NDArray(torch.as_tensor(v))


def while_loop(cond, func, loop_vars, max_iterations=None):
    """While ``cond(*loop_vars)`` and fewer than ``max_iterations`` steps,
    ``func(*loop_vars) -> (step_output, new_loop_vars)``; returns
    ``(outputs, final loop_vars)``, the outputs stacked on a new first axis
    of ``max_iterations`` rows, those past the last step zero."""
    if max_iterations is None:
        raise ValueError("max_iterations is required (reference parity)")
    multi = isinstance(loop_vars, (list, tuple))
    lv = [_tensor_of(v) for v in _as_list(loop_vars)]
    rows = []
    while len(rows) < max_iterations and bool(cond(*lv)):
        out, new_vars = func(*lv)
        rows.append([] if out is None else
                    [_tensor_of(o) for o in _as_list(out)])
        lv = [_tensor_of(v) for v in _as_list(new_vars)]
    if rows:
        shapes = rows[0]
    else:   # the outputs' shapes, from one step nobody keeps
        with torch.no_grad():
            out, _ = func(*lv)
        shapes = [] if out is None else [_tensor_of(o) for o in
                                         _as_list(out)]
    outputs = []
    for i, like in enumerate(shapes):
        pad = [NDArray(torch.zeros_like(like._data))] * (max_iterations
                                                           - len(rows))
        outputs.append(_stack([r[i] for r in rows] + pad))
    return (outputs if len(outputs) != 1 else outputs[0],
            lv if multi else lv[0])


def cond(pred, then_func, else_func, inputs=()):
    """``then_func(*inputs)`` where ``pred`` holds, else
    ``else_func(*inputs)``."""
    ins = _as_list(inputs)
    return then_func(*ins) if bool(pred) else else_func(*ins)
