"""The result dtypes of ``mxnet_tpu_torch/ops/promote.py`` on the card: the
NDArray operators and ``mx.np`` functions with Python scalars on either
side and integer division by zero give on CUDA what they give on the CPU
(where tests/test_torch_dtype_parity.py holds them against the JAX
package), and a Python scalar costs no device allocation of its own.
Marked ``cuda``; every test skips without a card. The file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_promote.py
"""
import operator

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt

OPS = (operator.add, operator.sub, operator.mul, operator.truediv,
       operator.floordiv, operator.mod, operator.pow)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return mt.gpu(0)


def _arrays(values, dtype, gpu):
    with mt.cpu():
        cpu = mt.np.array(values, dtype=dtype)
    with gpu:
        card = mt.np.array(values, dtype=dtype)
    return cpu, card


def _same(got, want, tag):
    assert str(got.dtype) == str(want.dtype), (tag, got.dtype, want.dtype)
    assert got._data.is_cuda, tag
    onp.testing.assert_allclose(onp.asarray(got.asnumpy(), "f8"),
                                onp.asarray(want.asnumpy(), "f8"),
                                rtol=1e-6, atol=0, equal_nan=True,
                                err_msg=str(tag))


@pytest.mark.cuda
def test_cuda_scalars_and_zero_divisors_match_the_cpu(cuda_device):
    values = {"bool": [True, False, True], "float32": [2.5, -1.5, 0.0]}
    for dtype in ("int32", "int64", "uint8", "bool", "float32"):
        cpu, card = _arrays(values.get(dtype, [7, 0, 5]), dtype, cuda_device)
        for op in OPS:
            for s in (2, 2.5, True, 0, False):
                for side in ("left", "right"):
                    if op is operator.sub and dtype == "bool" and isinstance(
                            s, bool):
                        continue  # bool - bool raises in both packages
                    if op is operator.pow and (side == "right" or s == 2.5):
                        continue
                    tag = (dtype, op.__name__, s, side)
                    if side == "left":
                        _same(op(card, s), op(cpu, s), tag)
                    else:
                        _same(op(s, card), op(s, cpu), tag)
        for name in ("floor_divide", "mod", "fmod", "heaviside", "hypot",
                     "maximum"):
            fn = getattr(mt.np, name)
            for s in (0, 3, 0.5):
                _same(fn(card, s), fn(cpu, s), (dtype, name, s))
            _same(fn(card, card * 0), fn(cpu, cpu * 0), (dtype, name, "0s"))


@pytest.mark.cuda
def test_cuda_python_scalar_allocates_nothing_on_the_card(cuda_device):
    """A Python scalar is a 0-dim CPU tensor that torch reads on the host:
    ``x * 2.0`` allocates its result on the card and nothing else."""
    _, x = _arrays([1.0, 2.0, 3.0], "float32", cuda_device)
    _, i = _arrays([7, 0, 5], "int32", cuda_device)
    for k, f in enumerate((lambda: x * 2.0, lambda: x + 1, lambda: 2 - x,
              lambda: 1.0 / x, lambda: i // 3, lambda: i % 3,
              lambda: mt.np.add(x, 1.5))):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        out = f()
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()["allocation.all.allocated"]
        assert out._data.is_cuda
        assert after - before == 1, (k, after - before)
