"""The activation table of the PyTorch port against the JAX package on the
CPU, and the activation blocks of ``gluon.nn.activations``.

The port's ``ops/nn.py:_ACTS`` refused ten act_types the JAX package
computes (relu6, softrelu, softsign, silu, swish, mish, hard_sigmoid,
hard_swish, softmax, log_softmax); each is held here, with the rest of the
table, through all four surfaces: ``ops.nn.activation``,
``mx.npx.activation``, ``nn.Activation`` and ``Dense(activation=...)``.
Inputs hold -0.0, +-3, -5, +-6, -8 and large +-x beside seeded normals.
Tolerances:
float32 1e-6 relative (plus 1e-7 absolute, and 1e-6 of the largest value
for the row-normalised softmax family); bfloat16 two units in the last
place of the JAX value (2^-6 relative): the JAX package rounds each op of
a chain (silu's sigmoid, then the product) to bfloat16, torch's fused
CPU ops once. Gradients through ``jax.vjp`` against torch autograd,
float32, 1e-5 relative plus 1e-6 absolute (a chain of several ops rounds
several times in another order; a saturating derivative such as
``1 - tanh^2`` cancels).

The exact GELU (``gelu``, ``erf_gelu``, the GELU block, ``leaky_relu``'s
gelu) is held to the table's own tolerances: both packages compute
``0.5 * x * erfc(-x * sqrt_half)`` op by op (``ops/nn.py:gelu_exact``), so
the negative tail (-3, -5, -8 among the inputs) does not cancel. The tanh
form keeps a wider tolerance, for a gap in the JAX package's tanh
(``_TANH_GELU`` below).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import nn as jnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import nn as tnn

ALL = sorted(jnn._ACTS)
REPAIRED = ["relu6", "softrelu", "softsign", "silu", "swish", "mish",
            "hard_sigmoid", "hard_swish", "softmax", "log_softmax"]
SPECIAL = [-0.0, 0.0, 3.0, -3.0, 6.0, -6.0, 2.5, -2.5, 40.0, -40.0, 1e3,
           -1e3, -5.0, -8.0]


def _inputs(seed=0):
    r = onp.random.RandomState(seed)
    x = r.standard_normal((4, 24)).astype("f") * 4
    x[0, :len(SPECIAL)] = SPECIAL
    return x


#: the tanh form (``gelu_tanh``, ``GELU('tanh')``) alone keeps 1e-6
#: absolute in float32 (1e-5 for gradients): XLA's tanh saturates to -1
#: for arguments below about -7.9 where torch's tanh is one float32 ulp of
#: 1 above it, and ``1 + tanh`` cancels there, so the two differ by up to
#: 3.0e-7 for x in [-5, -4] (measured on these inputs; 4.0e-7 at x = -4.5
#: op by op in the JAX package's order). In bfloat16 it keeps 2^-6 of the
#: largest value: the JAX package rounds each of its seven intermediates
#: to bfloat16, torch's fused op rounds once (measured 2.9e-3 absolute)
_TANH_GELU = ("gelu_tanh", "GELU('tanh',)")


def _close(got, want, dtype, name, scale=False, grad=False):
    got, want = onp.asarray(got, "f"), onp.asarray(want, "f")
    if dtype == "bfloat16":
        rtol, atol = 2.0 ** -6, 2.0 ** -6 * 1e-3
    else:
        rtol, atol = (1e-5, 1e-6) if grad else (1e-6, 1e-7)
    if scale:
        atol = max(atol, rtol * onp.abs(want).max())
    elif name.startswith(_TANH_GELU):
        atol = (max(atol, rtol * onp.abs(want).max()) if dtype == "bfloat16"
                else 1e-5 if grad else 1e-6)
    onp.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                err_msg=f"{name} {dtype}")


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_act_type_through_ops_and_npx(dtype):
    """Both packages' tables hold the same names; every name computes the
    same values through ``ops.nn.activation`` and ``mx.npx.activation``,
    keeping the input's dtype."""
    assert sorted(tnn._ACTS) == ALL
    x = _inputs()
    for name in ALL:
        want = jnn.activation(jnp.asarray(x, _jdtype(dtype)), name)
        got = tnn.activation(torch.from_numpy(x).to(
            getattr(torch, dtype)), name)
        assert str(got.dtype) == f"torch.{dtype}", name
        soft = name in ("softmax", "log_softmax")
        _close(got.float().numpy(), onp.asarray(want.astype(jnp.float32)),
               dtype, name, soft)
        with mt.cpu():
            nd = mt.npx.activation(mt.np.array(x, dtype=dtype), name)
        jnd = jmx.npx.activation(jmx.np.array(x, dtype=dtype), act_type=name)
        _close(nd.asnumpy(), onp.asarray(jnd.asnumpy(), "f"), dtype, name,
               soft)


def test_every_act_type_gradient():
    """The vector-Jacobian product of every act_type, float32."""
    x = _inputs(1)
    ct = onp.random.RandomState(2).standard_normal(x.shape).astype("f")
    for name in ALL:
        _, vjp = jax.vjp(lambda v, n=name: jnn.activation(v, n),
                         jnp.asarray(x))
        want = onp.asarray(vjp(jnp.asarray(ct))[0])
        xt = torch.from_numpy(x).requires_grad_()
        tnn.activation(xt, name).backward(torch.from_numpy(ct))
        _close(xt.grad.numpy(), want, "float32", name,
               name in ("softmax", "log_softmax"), grad=True)


def test_unknown_act_type_raises_in_both():
    with pytest.raises(ValueError, match="unknown act_type"):
        tnn.activation(torch.zeros(2), "no_such_act")
    with pytest.raises(ValueError, match="unknown act_type"):
        jnn.activation(jnp.zeros(2), "no_such_act")


def _pair_block(make_j, make_t, x, in_shape=None):
    """The same block in both packages with the JAX weights carried
    across; returns (jax out, jax input gradient, port out, port input
    gradient) of ``sum(out * ct)``."""
    from mxnet_tpu_torch.convert import load_jax_params

    jmx.seed(3)
    jb, tb = make_j(), make_t()
    jb.initialize()
    jb(jmx.np.array(x))
    tb.initialize(device=mt.cpu())
    tb(torch.from_numpy(x))
    load_jax_params(tb, {k: p.data().asnumpy() for k, p in
                         jb.collect_params().items()})
    jx = jmx.np.array(x)
    jx.attach_grad()
    with jmx.autograd.record():
        jo = jb(jx)
        ct = onp.random.RandomState(4).standard_normal(jo.shape).astype("f")
        (jo * jmx.np.array(ct)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    with mt.autograd.record():
        to = tb(tx)
        (to * torch.from_numpy(ct)).sum().backward()
    return (jo.asnumpy(), jx.grad.asnumpy(), to.detach().numpy(),
            tx.grad.numpy(), jb, tb)


def test_activation_layer_and_dense_activation():
    """``nn.Activation(name)`` and ``Dense(5, activation=name)`` for the
    ten repaired names: outputs and input gradients; Dense's weight
    gradient too."""
    x = _inputs(5)[:, :12]
    for name in REPAIRED:
        jo, jg, to, tg, _, _ = _pair_block(
            lambda n=name: jmx.gluon.nn.Activation(n),
            lambda n=name: mt.gluon.nn.Activation(n), x)
        soft = name in ("softmax", "log_softmax")
        _close(to, jo, "float32", f"Activation {name}", soft)
        _close(tg, jg, "float32", f"Activation {name} grad", soft,
               grad=True)
        jo, jg, to, tg, jb, tb = _pair_block(
            lambda n=name: jmx.gluon.nn.Dense(5, activation=n),
            lambda n=name: mt.gluon.nn.Dense(5, activation=n), x)
        _close(to, jo, "float32", f"Dense {name}", True)
        _close(tg, jg, "float32", f"Dense {name} grad", True, grad=True)
        _close(tb.weight.grad().numpy(), jb.weight.grad().asnumpy(),
               "float32", f"Dense {name} weight grad", True, grad=True)


BLOCKS = [
    ("LeakyReLU", (0.1,)), ("PReLU", ()), ("ELU", (0.7,)), ("SELU", ()),
    ("GELU", ()), ("GELU", ("tanh",)), ("Swish", ()), ("Swish", (2.0,)),
    ("SiLU", ()),
]


def test_activation_blocks():
    """The seven blocks of ``gluon/nn/activations.py`` (GELU both ways,
    Swish at beta 1 and 2): outputs, input gradients and PReLU's alpha
    gradient, float32. Inputs hold exact zeros, where each family's
    ``where`` takes the positive side's slope."""
    x = _inputs(6)
    x[1, :4] = 0.0
    for name, args in BLOCKS:
        jo, jg, to, tg, jb, tb = _pair_block(
            lambda n=name, a=args: getattr(jmx.gluon.nn, n)(*a),
            lambda n=name, a=args: getattr(mt.gluon.nn, n)(*a), x)
        _close(to, jo, "float32", f"{name}{args}")
        _close(tg, jg, "float32", f"{name}{args} grad", grad=True)
        if name == "PReLU":
            assert list(tb.collect_params()) == ["alpha"]
            _close(tb.alpha.grad().numpy(), jb.alpha.grad().asnumpy(),
                   "float32", "PReLU alpha grad", True, grad=True)


def test_prelu_per_channel_and_leaky_relu_op():
    """PReLU with one slope per channel of an NCHW input, and every
    ``leaky_relu`` act_type of the op, against the JAX package."""
    r = onp.random.RandomState(7)
    x = r.standard_normal((2, 3, 4, 5)).astype("f")
    gamma = r.uniform(0.1, 0.5, 3).astype("f")
    for act in ("leaky", "prelu", "elu", "selu", "gelu", "rrelu"):
        want = jnn.leaky_relu(jnp.asarray(x), jnp.asarray(gamma),
                              act_type=act, slope=0.3)
        got = tnn.leaky_relu(torch.from_numpy(x), torch.from_numpy(gamma),
                             act_type=act, slope=0.3)
        _close(got.numpy(), onp.asarray(want), "float32", act)
    jo, jg, to, tg, jb, tb = _pair_block(
        lambda: jmx.gluon.nn.PReLU(in_channels=3),
        lambda: mt.gluon.nn.PReLU(in_channels=3), x)
    _close(to, jo, "float32", "PReLU(3)")
    _close(tg, jg, "float32", "PReLU(3) grad", grad=True)
    _close(tb.alpha.grad().numpy(), jb.alpha.grad().asnumpy(), "float32",
           "PReLU(3) alpha grad", True, grad=True)
