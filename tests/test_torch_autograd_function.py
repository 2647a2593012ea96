"""``autograd.Function``, ``set_recording`` and ``set_training`` of the
PyTorch port against the JAX package's, on the CPU.

The same custom functions are written once against each package's
``mx.np`` and run on the same numpy inputs; outputs and gradients agree
within rtol 1e-6 (f32: the same elementwise operations on both sides).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag

TOL = dict(rtol=1e-6, atol=1e-7)


def _functions(pkg, ag):
    class Sigmoid(ag.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.np.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    class ProdSum(ag.Function):
        """Two outputs; the second input gets no gradient (None)."""

        def forward(self, x, y):
            self.save_for_backward(x, y)
            return x * y, x + 2 * y

        def backward(self, dprod, dsum):
            x, y = self.saved_tensors
            return dprod * y + dsum, None

    class Scale(ag.Function):
        """A non-array input passes through; backward returns None
        for it."""

        def forward(self, x, k):
            self.k = k
            return x * k

        def backward(self, dy):
            return dy * self.k, None

    return Sigmoid, ProdSum, Scale


def _run(pkg, ag, dev, x0, y0, grad_req="write"):
    Sigmoid, ProdSum, Scale = _functions(pkg, ag)
    with dev():
        x, y = pkg.np.array(x0), pkg.np.array(y0)
        x.attach_grad(grad_req)
        y.attach_grad()
        y.grad[:] = 7.0       # a None gradient leaves the buffer as it was
        with ag.record():
            s = Sigmoid()(x)
            p, q = ProdSum()(s, y)
            out = Scale()(p * q, 3.0)
        out.backward()
        res = [a.asnumpy() for a in (s, p, q, out, x.grad, y.grad)]
        # outside record() the function runs unrecorded
        plain = Sigmoid()(x).asnumpy()
    return res, plain


def test_function_outputs_and_gradients_match_jax():
    r = onp.random.RandomState(0)
    x0 = r.standard_normal((3, 4)).astype("f")
    y0 = r.standard_normal((3, 4)).astype("f")
    jres, jplain = _run(mx, jag, mx.cpu, x0, y0)
    tres, tplain = _run(mt, tag, mt.cpu, x0, y0)
    names = ("sigmoid", "prod", "sum", "out", "x.grad", "y.grad")
    for name, a, b in zip(names, tres, jres):
        onp.testing.assert_allclose(a, b, err_msg=name, **TOL)
    assert (tres[-1] == 7.0).all()
    onp.testing.assert_allclose(tplain, jplain, **TOL)


def test_function_grad_req_add_and_repeat():
    """Two backward passes through a Function into an 'add' buffer sum."""
    r = onp.random.RandomState(1)
    x0 = r.standard_normal((5,)).astype("f")
    for pkg, ag, dev in ((mx, jag, mx.cpu), (mt, tag, mt.cpu)):
        Sigmoid = _functions(pkg, ag)[0]
        with dev():
            x = pkg.np.array(x0)
            x.attach_grad("add")
            for _ in range(2):
                with ag.record():
                    y = Sigmoid()(x)
                y.backward()
            g = x.grad.asnumpy()
        s = 1 / (1 + onp.exp(-x0))
        onp.testing.assert_allclose(g, 2 * s * (1 - s), rtol=1e-6,
                                    err_msg=pkg.__name__)


def test_function_on_tensors():
    """A Function over torch tensors: backward gets tensors, the gradient
    lands in the attached buffer (or in ``.grad`` of a plain leaf)."""
    class Cube(tag.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x ** 3

        def backward(self, dy):
            (x,) = self.saved_tensors
            assert isinstance(dy, torch.Tensor)
            return 3 * x * x * dy

    x = torch.tensor([1.0, -2.0, 0.5], requires_grad=True)
    with tag.record():
        y = Cube()(x)
    assert isinstance(y, torch.Tensor) and y.grad_fn is not None
    tag.backward(y)
    assert torch.allclose(x.grad, 3 * x.detach() ** 2)
    buf = torch.zeros(3)
    leaf = torch.tensor([2.0, 1.0, -1.0])
    tag.mark_variables([leaf], [buf])
    with tag.record():
        tag.backward(Cube()(leaf) * 2)
    assert torch.allclose(buf, 6 * leaf ** 2)
    with pytest.raises(ValueError, match="gradients for"):
        class Wrong(tag.Function):
            def forward(self, x):
                return x * 2

            def backward(self, dy):
                return dy, dy

        z = torch.ones(2, requires_grad=True)
        with tag.record():
            out = Wrong()(z)
        tag.backward(out)


def test_set_recording_and_set_training_return_the_previous_state():
    for ag in (jag, tag):
        assert not ag.is_recording() and not ag.is_training()
        seq = [ag.set_recording(True), ag.is_recording(),
               ag.set_training(True), ag.is_training(),
               ag.set_recording(False), ag.is_recording(),
               ag.set_training(False), ag.is_training()]
        assert seq == [False, True, False, True, True, False, True, False], \
            ag.__name__
        with ag.record():
            assert ag.set_recording(False) is True
            assert not ag.is_recording()
        assert not ag.is_recording()
