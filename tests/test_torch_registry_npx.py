"""``mx.npx``'s hand-written functions and its control flow
(numpy_extension/__init__.py, control_flow.py) against the JAX
package's, on the CPU with NDArrays of the same numpy inputs: the masked
softmaxes, the tanh and exact GELU, the npx reshape codes,
``batch_flatten``, ``boolean_mask``, ``index_update``/``index_add``,
``nonzero``, ``constraint_check``, ``arange_like``, ``broadcast_like``,
``batch_dot``, the special functions and the np-semantics flags; then
``foreach``, ``while_loop`` and ``cond``, outputs and gradients (the
port runs them eagerly, the JAX package through ``lax``).

Tolerance: f32 within 1e-5 relative (plus 1e-6 absolute).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from test_torch_registry_coverage import mismatch

_R = onp.random.RandomState(0)
X = _R.uniform(-1, 1, (3, 4, 5)).astype("f")
M = (_R.uniform(0, 1, (3, 4, 5)) > 0.4).astype("f")
B = _R.uniform(-1, 1, (3, 5, 2)).astype("f")
POS = _R.uniform(0.3, 2.5, (3, 4)).astype("f")


def _pair(mx, a):
    kw = {} if mx is jmx else dict(device=mt.cpu())
    return mx.np.array(a, dtype=a.dtype, **kw)


_CASES = [
    ("masked_softmax", (X, M), dict(axis=-1, temperature=2.0)),
    ("masked_log_softmax", (X, M), dict(axis=1)),
    ("gelu", (X,), {}),
    ("gelu", (X,), dict(approximate=False)),
    ("reshape", (X,), dict(newshape=(-2, -1))),
    ("reshape", (X,), dict(newshape=(-5, -4))),
    ("reshape", (X,), dict(newshape=(-6, 1, 3, -4))),
    ("reshape", (X,), dict(newshape=(-1, 5), reverse=True)),
    ("reshape", (X[:, :1],), dict(newshape=(-2, -3, -2))),
    ("batch_flatten", (X,), {}),
    ("boolean_mask", (X, onp.array([1.0, 0.0, 1.0], "f")), {}),
    ("boolean_mask", (X, onp.array([0.0, 1.0, 1.0, 0.0], "f")),
     dict(axis=1)),
    ("index_update", (X[0], onp.array([[0, 1], [2, 3]], "int32"),
                      onp.array([7.0, 8.0], "f")), {}),
    ("index_add", (X[0], onp.array([[0, 1], [2, 3]], "int32"),
                   onp.array([7.0, 8.0], "f")), {}),
    ("index_update", (X[0], onp.array([2, 0], "int32"),
                      onp.ones((2, 5), "f")), {}),
    ("nonzero", (M[0],), {}),
    ("arange_like", (X,), dict(start=1.0, step=0.5, repeat=3)),
    ("arange_like", (X,), dict(axis=2, repeat=2)),
    ("broadcast_like", (X[:, :1], X), {}),
    ("broadcast_like", (X[:1, :, :1], X), dict(lhs_axes=(0, 2),
                                               rhs_axes=(0, 2))),
    ("batch_dot", (X, B), {}),
    ("batch_dot", (X, X), dict(transpose_b=True)),
    ("batch_dot", (X, X), dict(transpose_a=True)),
    ("gamma", (POS,), {}),
    ("gamma", (-POS - 0.5,), {}),
    ("erf", (X,), {}),
    ("erfinv", (X * 0.9,), {}),
]


def test_hand_written_functions():
    bad = []
    for name, arrays, kw in _CASES:
        outs = [getattr(mx.npx, name)(*[_pair(mx, a) for a in arrays], **kw)
                for mx in (jmx, mt)]
        err = mismatch(f"{name} {kw}", *outs)
        if err:
            bad.append(err)
    assert not bad, bad


def test_gradients_through_npx():
    """The gradients of the data through boolean_mask, index_add,
    masked_softmax and the tanh GELU, from the same head."""
    head = _R.uniform(-1, 1, (3, 4, 5)).astype("f")
    for name, arrays, kw in (("boolean_mask", (X, onp.array(
            [1.0, 0.0, 1.0], "f")), {}),
            ("index_add", (X, onp.array([0, 2], "int32"),
                           onp.ones((2, 4, 5), "f")), {}),
            ("masked_softmax", (X, M), {}), ("gelu", (X,), {})):
        grads = []
        for mx in (jmx, mt):
            data = [_pair(mx, a) for a in arrays]
            data[0].attach_grad()
            with mx.autograd.record():
                out = getattr(mx.npx, name)(*data, **kw)
            out.backward(_pair(mx, head[:out.shape[0]]))
            grads.append(data[0].grad)
        assert mismatch(f"d {name}", *grads) is None, name


def test_checks_and_flags():
    ok = _pair(mt, onp.ones((2, 2), "f"))
    assert mt.npx.constraint_check(ok).asnumpy().tolist() == [1.0]
    with pytest.raises(ValueError, match="bad input"):
        mt.npx.constraint_check(_pair(mt, onp.zeros(2, "f")), "bad input")
    with mt.cpu():   # creation follows the current device
        arr = mt.npx.from_numpy(onp.arange(6, dtype="f").reshape(2, 3))
    back = mt.npx.from_dlpack(mt.npx.to_dlpack_for_read(arr))
    assert onp.array_equal(back.asnumpy(), arr.asnumpy())
    try:
        mt.npx.reset_np()
        assert not mt.npx.is_np_array() and not mt.npx.is_np_shape()
        mt.npx.set_np(dtype=True)
        assert mt.npx.is_np_array() and mt.npx.is_np_default_dtype()
    finally:
        mt.npx.set_np()
    assert mt.npx.use_np(len) is len
    assert mt.npx.BatchNorm is not mt.nd._internal.BatchNorm


def _fe_body(x, states):
    h, c = states
    return [x * h, x + 1.0], [h * 0.5 + x, c - x]


def test_foreach():
    """Outputs stacked over the steps and the final states, two of each;
    then the gradient of the data and the initial state."""
    xs = _R.uniform(-1, 1, (4, 3)).astype("f")
    h0 = _R.uniform(-1, 1, (3,)).astype("f")
    results, grads = [], []
    for mx in (jmx, mt):
        data, h, c = (_pair(mx, a) for a in (xs, h0, h0))
        data.attach_grad()
        h.attach_grad()
        with mx.autograd.record():
            outs, states = mx.npx.foreach(_fe_body, data, [h, c])
            loss = (outs[0] * outs[1]).sum() + (states[0] * states[1]).sum()
        loss.backward()
        results.append([outs, states])
        grads.append([data.grad, h.grad])
    assert mismatch("foreach", *results) is None
    assert mismatch("d foreach", *grads) is None


def test_while_loop_and_cond():
    """``while_loop``: the step outputs padded with zero rows to
    ``max_iterations``, the final loop variables; ``cond``: each branch
    and the gradient through the one taken."""
    results = []
    for mx in (jmx, mt):
        i, acc = _pair(mx, onp.array([0.0], "f")), _pair(mx, onp.ones(
            2, "f"))
        results.append(mx.npx.while_loop(
            lambda i, acc: i < 3, lambda i, acc: (acc * 2.0, (i + 1.0,
                                                              acc + i)),
            [i, acc], max_iterations=6))
    assert mismatch("while_loop", *results) is None
    assert results[1][0].shape == (6, 2)
    x = _R.uniform(-1, 1, (2, 3)).astype("f")
    for pred in (1.0, 0.0):
        outs, grads = [], []
        for mx in (jmx, mt):
            data = _pair(mx, x)
            data.attach_grad()
            with mx.autograd.record():
                out = mx.npx.cond(_pair(mx, onp.array([pred], "f")),
                                  lambda v: v * v, lambda v: v * 3.0,
                                  [data])
            out.backward()
            outs.append(out)
            grads.append(data.grad)
        assert mismatch(f"cond {pred}", *outs) is None
        assert mismatch(f"d cond {pred}", *grads) is None
