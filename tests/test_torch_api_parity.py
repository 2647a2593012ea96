"""Two results in which the port once differed from the JAX package, held
against it on the CPU.

- An integer or bool NDArray with a Python float: the JAX package runs with
  64-bit types on (mxnet_tpu/__init__.py:34), so its weak-typed float takes
  float64; the port computed in float32. Dtypes must be equal, values equal
  to 1e-12 relative (both sides compute in float64).
- ``Parameter.data()``: the JAX package returns an NDArray over the
  parameter's value (mxnet_tpu/gluon/parameter.py:253); the port returned a
  tensor, so ``p.data().asnumpy()`` raised. It must be an NDArray that reads
  the value, writes into it, and passes a recorded gradient on to
  ``p.grad()``.
"""
import operator

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.parameter import Parameter as JParameter
from mxnet_tpu_torch.ndarray.ndarray import NDArray

OPS = [operator.add, operator.sub, operator.mul, operator.truediv,
       operator.floordiv, operator.mod, operator.pow, operator.lt,
       operator.eq]
VALUES = {"int32": [1, 2, 3, 7], "int64": [1, 2, 3, 7], "int8": [1, 2, 3, 7],
          "uint8": [1, 2, 3, 7], "bool": [True, True, True, True],
          "float32": [0.5, 1.5, 2.0, 7.0]}


def _pairs(a_t, a_j, scalar):
    """(op name, side, port result, JAX result) for each op, each side."""
    for op in OPS:
        for side, fn in (("left", lambda a, op=op: op(a, scalar)),
                         ("right", lambda a, op=op: op(scalar, a))):
            yield op.__name__, side, fn(a_t), fn(a_j)


@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "uint8",
                                   "bool"])
def test_int_array_with_python_float_gives_the_jax_dtype(dtype):
    with mt.cpu():
        a_t = mt.np.array(VALUES[dtype], dtype=dtype)
    a_j = jmx.np.array(VALUES[dtype], dtype=dtype)
    for name, side, got, want in _pairs(a_t, a_j, 2.5):
        assert isinstance(got, NDArray), (name, side)
        assert str(got.dtype) == str(want.dtype), (name, side)
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=1e-12, err_msg=f"{name} {side}")
    assert str((a_t + 2.5).dtype) == "float64"


def test_float_array_and_int_scalars_keep_their_dtype():
    """What the repair leaves alone: a float32 array with a Python float,
    and an integer array with a Python int, keep the array's dtype (or the
    JAX package's true-division dtype) as before."""
    for dtype, scalar in (("float32", 2.5), ("int32", 2), ("int8", 3)):
        with mt.cpu():
            a_t = mt.np.array(VALUES[dtype], dtype=dtype)
        a_j = jmx.np.array(VALUES[dtype], dtype=dtype)
        for name, side, got, want in _pairs(a_t, a_j, scalar):
            assert str(got.dtype) == str(want.dtype), (dtype, name, side)
            onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                        rtol=1e-6, err_msg=f"{name} {side}")


def _params():
    init = onp.array([1.0, -2.0, 3.0], dtype="float32")
    tp = mt.gluon.Parameter("w", shape=(3,))
    tp.initialize(device=mt.cpu())
    tp.set_data(torch.from_numpy(init))
    jp = JParameter("w", shape=(3,))
    jp.initialize()
    jp.set_data(jmx.np.array(init))
    return tp, jp


def test_parameter_data_is_an_ndarray_over_its_storage():
    tp, jp = _params()
    got, want = tp.data(), jp.data()
    assert isinstance(got, NDArray)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert str(got.dtype) == str(want.dtype) and got.shape == want.shape
    assert got._data.data_ptr() == tp._tensor().data_ptr()
    # a write through data() lands in the parameter, in both packages
    for p in (tp, jp):
        d = p.data()
        d[1:] = 5.0
        d += 1.0
    onp.testing.assert_array_equal(tp.data().asnumpy(), jp.data().asnumpy())
    onp.testing.assert_array_equal(tp._tensor().detach().numpy(),
                                   [2.0, 6.0, 6.0])


def test_parameter_data_sends_a_recorded_gradient_to_grad():
    tp, jp = _params()
    x = onp.array([4.0, 8.0, 12.0], dtype="float32")
    with mt.autograd.record():
        loss_t = (tp.data() * mt.np.array(x, device=mt.cpu())).sum()
    loss_t.backward()
    with jmx.autograd.record():
        loss_j = (jp.data() * jmx.np.array(x)).sum()
    loss_j.backward()
    onp.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    onp.testing.assert_allclose(tp.grad().numpy(), jp.grad().asnumpy(),
                                rtol=1e-6)
    onp.testing.assert_array_equal(tp.grad().numpy(), x)
