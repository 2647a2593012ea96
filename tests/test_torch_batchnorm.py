"""BatchNorm training in the PyTorch port against the JAX package, on the
CPU: the plain versions of the K1/K2 kernels (ops/nn.py ``_bn_train_impl``
and ``_bn_train_bwd``) against the reference's ``_bn_train`` and its
custom VJP, and against its Pallas ``kernels.norm.bn_train`` run in
interpret mode; the ``batch_norm`` op; and the ``BatchNorm`` layer's moving
statistics and inference branch. Inputs come from a numpy seed; bf16 inputs
are the same f32 values rounded to nearest even on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.kernels import norm as jknorm
from mxnet_tpu.ops import nn as jnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params, to_tensor
from mxnet_tpu_torch.kernels import norm as tknorm
from mxnet_tpu_torch.ops import nn as tnn

EPS = 1e-5


def _operands(shape, axis, seed=0):
    r = onp.random.RandomState(seed)
    c = shape[axis]
    return dict(
        x=(r.standard_normal(shape) * 2.0 + 1.5).astype("f"),
        gamma=r.uniform(0.5, 1.5, c).astype("f"),
        beta=r.standard_normal(c).astype("f"),
        shift=(r.standard_normal(c) * 0.1 + 1.5).astype("f"),
        dy=r.standard_normal(shape).astype("f"),
        dmean=r.standard_normal(c).astype("f"),
        dvar=r.standard_normal(c).astype("f"))


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _np(t):
    return onp.asarray(jnp.asarray(t).astype(jnp.float32)) \
        if not isinstance(t, torch.Tensor) else t.float().numpy()


def _reference(op, axis, jdt, cts=True):
    """(out, mean, var), (dx, dgamma, dbeta) of the JAX package's _bn_train
    through jax.vjp with cotangents (dy, dmean, dvar)."""
    shift = jnp.asarray(op["shift"])

    def f(x, g, b):
        return jnn._bn_train(x, g, b, shift, EPS, axis)

    outs, vjp = jax.vjp(f, _jax(op["x"], jdt), jnp.asarray(op["gamma"]),
                        jnp.asarray(op["beta"]))
    dm, dv = ((op["dmean"], op["dvar"]) if cts
              else (onp.zeros_like(op["dmean"]),) * 2)
    grads = vjp((_jax(op["dy"], jdt), jnp.asarray(dm), jnp.asarray(dv)))
    return outs, grads


# (shape, axis, bf16 x, MXTPU_BN_COMPUTE, non-zero dmean/dvar)
CASES = [
    ((4, 5, 6, 24), -1, False, "f32", True),     # NHWC
    ((4, 24, 5, 6), 1, False, "f32", False),     # NCHW
    ((6, 7, 3, 40), -1, True, "f32", True),
    ((6, 40, 7, 3), 1, True, "bf16", True),
]


@pytest.mark.parametrize("shape,axis,low,compute,cts", CASES)
def test_plain_twins_match_reference_bn_train_and_vjp(monkeypatch, shape,
                                                      axis, low, compute,
                                                      cts):
    """f32: 1e-5 relative (the sums run in another order). bf16 x: out and
    dx within 2 bf16 ulps of their scale (2^-7), since XLA on the CPU keeps
    excess precision inside a fused bf16 chain where PyTorch rounds each
    operation; statistics and dgamma/dbeta, f32 sums, within 1e-4."""
    monkeypatch.setenv("MXTPU_BN_COMPUTE", compute)
    axis = axis % len(shape)
    op = _operands(shape, axis)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if low
                else (jnp.float32, torch.float32))
    (jout, jmean, jvar), (jdx, jdg, jdb) = _reference(op, axis, jdt, cts)
    t = {k: _torch(v, tdt if k in ("x", "dy") else torch.float32)
         for k, v in op.items()}
    out, mean, var, inv = tnn._bn_train_impl(t["x"], t["gamma"], t["beta"],
                                             t["shift"], EPS, axis)
    zeros = torch.zeros_like(t["dmean"])
    dx, dg, db, dshift = tnn._bn_train_bwd(
        EPS, axis, (t["x"], t["gamma"], t["beta"], t["shift"], mean, inv),
        (t["dy"], t["dmean"] if cts else zeros, t["dvar"] if cts else zeros))
    assert out.dtype == dx.dtype == tdt and not dshift.any()
    stat = dict(atol=1e-4, rtol=1e-4) if low else dict(atol=1e-5, rtol=1e-5)
    for got, want in ((mean, jmean), (var, jvar), (dg, jdg), (db, jdb)):
        onp.testing.assert_allclose(_np(got), _np(want), **stat)
    for got, want in ((out, jout), (dx, jdx)):
        w = _np(want)
        atol = 2.0 ** -7 * onp.abs(w).max() if low else 1e-5
        onp.testing.assert_allclose(_np(got), w, atol=atol,
                                    rtol=0 if low else 1e-5)


@pytest.mark.parametrize("m,c,low", [(64, 128, False), (32, 256, True)])
def test_plain_twins_match_reference_pallas_kernels(monkeypatch, m, c, low):
    """The reference's Pallas K1/K2 (interpret mode, its own gates: C a
    multiple of 128, channels last) against the port's plain versions, the
    same tolerances as above."""
    monkeypatch.setenv("MXTPU_KERNELS", "force")
    monkeypatch.setenv("MXTPU_KERNELS_INTERPRET", "1")
    op = _operands((m, c), 1)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if low
                else (jnp.float32, torch.float32))
    shift = jnp.asarray(op["shift"])

    def f(x, g, b):
        return jknorm.bn_train(x, g, b, shift, EPS, 1)

    jouts, vjp = jax.vjp(f, _jax(op["x"], jdt), jnp.asarray(op["gamma"]),
                         jnp.asarray(op["beta"]))
    jgrads = vjp((_jax(op["dy"], jdt), jnp.asarray(op["dmean"]),
                  jnp.asarray(op["dvar"])))
    x = _torch(op["x"], tdt).requires_grad_()
    g, b = (torch.from_numpy(op[k]).requires_grad_() for k in ("gamma",
                                                               "beta"))
    outs = tknorm.bn_train(x, g, b, torch.from_numpy(op["shift"]), EPS, 1)
    torch.autograd.backward(outs, (_torch(op["dy"], tdt),
                                   torch.from_numpy(op["dmean"]),
                                   torch.from_numpy(op["dvar"])))
    stat = dict(atol=1e-4, rtol=1e-4) if low else dict(atol=1e-5, rtol=1e-5)
    for got, want in zip((outs[1], outs[2], g.grad, b.grad),
                         (jouts[1], jouts[2], jgrads[1], jgrads[2])):
        onp.testing.assert_allclose(_np(got.detach()), _np(want), **stat)
    for got, want in ((outs[0], jouts[0]), (x.grad, jgrads[0])):
        w = _np(want)
        atol = 2.0 ** -7 * onp.abs(w).max() if low else 1e-5
        onp.testing.assert_allclose(_np(got.detach()), w, atol=atol,
                                    rtol=0 if low else 1e-5)


def test_batch_norm_op_training_and_inference():
    """``batch_norm``'s blended moving statistics (biased variance,
    momentum on the old value) and its inference and global-stats branches,
    f32, 1e-5."""
    op = _operands((3, 10, 4, 5), 1, seed=2)
    rm = onp.random.RandomState(3).standard_normal(10).astype("f")
    rv = onp.random.RandomState(4).uniform(0.5, 2.0, 10).astype("f")
    args = ("x", "gamma", "beta")
    for training, ugs in ((True, False), (False, False), (True, True)):
        want = jnn.batch_norm(*(jnp.asarray(op[k]) for k in args),
                              jnp.asarray(rm), jnp.asarray(rv), eps=EPS,
                              momentum=0.8, training=training,
                              use_global_stats=ugs, axis=1)
        got = tnn.batch_norm(*(torch.from_numpy(op[k]) for k in args),
                             torch.from_numpy(rm), torch.from_numpy(rv),
                             eps=EPS, momentum=0.8, training=training,
                             use_global_stats=ugs, axis=1)
        for a, w in zip(got, want):
            onp.testing.assert_allclose(a.detach().numpy(), onp.asarray(w),
                                        atol=1e-5, rtol=1e-5)


def test_batchnorm_layer_moving_stats_gradients_and_inference():
    """The layer, NHWC, weights carried across by load_jax_params: two
    training forwards (running stats blended twice, in place, f32 1e-5),
    the gradients of the second through backward with a head gradient,
    then a predict-mode forward on the running stats."""
    mx.seed(1)
    jbn = mx.gluon.nn.BatchNorm(axis=-1, momentum=0.7)
    jbn.initialize()
    tbn = mt.gluon.nn.BatchNorm(axis=-1, momentum=0.7)
    tbn.initialize(device=mt.cpu())
    r = onp.random.RandomState(6)
    xs = [(r.standard_normal((4, 3, 5, 16)) * 3 + 2).astype("f")
          for _ in range(3)]
    dy = r.standard_normal((4, 3, 5, 16)).astype("f")
    jbn(mx.np.array(xs[0]))  # deferred shapes: a predict-mode forward
    load_jax_params(tbn, {k: p.data().asnumpy()
                          for k, p in jbn.collect_params().items()})
    for i in (0, 1):
        jx, tx = mx.np.array(xs[i]), torch.from_numpy(xs[i])
        jx.attach_grad()
        tx.requires_grad_()
        with mx.autograd.record():
            jy = jbn(jx)
        with mt.autograd.record():
            ty = tbn(tx)
        onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(),
                                    atol=1e-5, rtol=1e-5)
    jy.backward(mx.np.array(dy))
    mt.autograd.backward(ty, torch.from_numpy(dy))
    onp.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                atol=1e-5, rtol=1e-5)
    for name, p in tbn.collect_params().items():
        jp = jbn.collect_params()[name]
        onp.testing.assert_allclose(p._tensor().detach().numpy(),
                                    jp.data().asnumpy(), atol=1e-5,
                                    rtol=1e-5, err_msg=name)
        if p.grad_req != "null":
            onp.testing.assert_allclose(p.grad().numpy(),
                                        jp.grad().asnumpy(), atol=1e-4,
                                        rtol=1e-5, err_msg=name)
    assert tbn.running_mean.grad_req == "null"
    assert not to_tensor(jbn.running_var.data().asnumpy()).equal(
        torch.ones(16))
    onp.testing.assert_allclose(
        tbn(torch.from_numpy(xs[2])).numpy(),
        jbn(mx.np.array(xs[2])).asnumpy(), atol=1e-5, rtol=1e-5)
