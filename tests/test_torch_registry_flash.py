"""The registered ``flash_attention`` op against the JAX package's
(ops/pallas_attention.py:466), on the CPU: off a TPU the JAX op takes its
reference path, the port's CPU tensors the kernels' plain version. Out
and the gradients of q, k and v, causal or not, with dropout; the dropout
mask bit for bit (both are the counter hash ``_dropout_keep``); the
``mx.nd``/``mx.npx`` spellings bit for bit with a direct call of
``ops/flash_attention.flash_attention``; the Pallas tiling arguments
accepted and without effect.

Tolerance: f32 within 1e-5 relative (plus 1e-6 absolute).
"""
import functools

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops.registry import _OPS as JOPS
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import flash_attention as fa
from test_torch_registry_coverage import mismatch

_SHAPE = (2, 3, 24, 16)


def _qkv(seed=0):
    rs = onp.random.RandomState(seed)
    return [rs.uniform(-1, 1, _SHAPE).astype("f") for _ in range(3)]


_CONFIGS = [(False, 0.0), (True, 0.0), (False, 0.2), (True, 0.3)]


def _kw(causal, p):
    return dict(causal=causal, dropout_p=p, dropout_seed=17 if p else None)


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Out and (dq, dk, dv) of the JAX op for every configuration, from
    one ``jax.jit``."""
    q, k, v = map(jnp.asarray, _qkv())
    dout = jnp.asarray(_dout())

    def everything(q, k, v, dout):
        res = []
        for causal, p in _CONFIGS:
            out, vjp = jax.vjp(lambda *xs, kw=_kw(causal, p): JOPS[
                "flash_attention"](*xs, **kw), q, k, v)
            res.append((out, vjp(dout)))
        return res

    return jax.jit(everything)(q, k, v, dout)


def _dout():
    return onp.random.RandomState(1).uniform(-1, 1, _SHAPE).astype("f")


@pytest.mark.parametrize("causal,p", _CONFIGS)
def test_forward_and_backward(causal, p):
    jout, jgrads = _jax_results()[_CONFIGS.index((causal, p))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in _qkv())
    tout = mt.ops.registry.get_op("flash_attention")(tq, tk, tv,
                                                     **_kw(causal, p))
    tgrads = torch.autograd.grad(tout, (tq, tk, tv),
                                 torch.from_numpy(_dout()))
    assert mismatch("out", jout, tout) is None
    for name, a, b in zip("qkv", jgrads, tgrads):
        assert mismatch(f"d{name}", a, b) is None, name


def test_dropout_mask_bit_for_bit():
    """q = k = 0 spreads each row evenly over the keys, and v = I makes
    out[i, j] the kept share of key j: the zero pattern of out is the
    keep mask, which must be the JAX package's exactly."""
    s = d = 32
    q = onp.zeros((1, 2, s, d), "f")
    v = onp.broadcast_to(onp.eye(s, dtype="f"), (1, 2, s, d)).copy()
    kw = dict(dropout_p=0.4, dropout_seed=1234567)
    jout = onp.asarray(jax.jit(lambda *xs: JOPS["flash_attention"](
        *xs, **kw))(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v)))
    tout = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(q),
                              torch.from_numpy(v), **kw).numpy()
    assert onp.array_equal(jout != 0, tout != 0)
    assert 0.45 < (tout != 0).mean() < 0.75


def test_namespaces_and_tiling_arguments():
    """``mx.nd``/``mx.npx.flash_attention`` on NDArrays inside
    ``record()``: out and the gradients bit for bit with the direct call;
    ``block_q``, ``block_k`` and ``interpret`` change nothing."""
    q, k, v = _qkv(2)
    kw = dict(causal=True, dropout_p=0.1, dropout_seed=5)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = fa.flash_attention(tq, tk, tv, **kw)
    want_g = torch.autograd.grad(want.sum(), (tq, tk, tv))
    for fn, extra in ((mt.nd.flash_attention, {}),
                      (mt.npx.flash_attention,
                       dict(block_q=16, block_k=8, interpret=True))):
        xs = [mt.np.array(a, device=mt.cpu()) for a in (q, k, v)]
        for x in xs:
            x.attach_grad()
        with mt.autograd.record():
            out = fn(*xs, **kw, **extra)
        out.backward()
        assert torch.equal(out._data, want.detach())
        for x, g in zip(xs, want_g):
            assert torch.equal(x.grad._data, g)
