"""The layers of the port's second Gluon slice against the JAX package on
the CPU: the containers, the norms, the transposed convolutions, the
reflection pad and ``ops.tensor.pad``, the pixel shuffles and
(modulated) deformable convolution.

Each block is built in both packages from the same constructor arguments,
the JAX package's weights are carried across by
``convert.load_jax_params`` (which also checks that the ``collect_params()``
names and shapes agree), and both run ``sum(out * ct)`` backward on one
seeded input. Outputs, the input's gradient and every parameter's gradient
agree within 1e-5 relative, plus 1e-5 of the tensor's largest value (f32;
the packages sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import tensor as jtensor
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.ops import tensor as ttensor

TOL = 1e-5


def _close(got, want, msg):
    want = onp.asarray(want, "f")
    onp.testing.assert_allclose(onp.asarray(got, "f"), want, rtol=TOL,
                                atol=TOL * max(onp.abs(want).max(), 1e-30),
                                err_msg=msg)


def _x(shape, seed=0):
    return onp.random.RandomState(seed).standard_normal(shape).astype("f")


def _pair(make_j, make_t, x, train=False, jinit=None):
    """Build, initialize and carry the weights; then one recorded forward
    (``train``: BatchNorm-style layers in training mode) and
    ``sum(out * ct)`` backward in each package. Returns the two blocks and
    ``(out, input grad, {param: grad})`` of each."""
    jmx.seed(7)
    jb, tb = make_j(), make_t()
    jb.initialize(init=jinit)
    with jmx.autograd.predict_mode():
        jb(jmx.np.array(x))
    tb.initialize(device=mt.cpu())
    tb(torch.from_numpy(x))
    load_jax_params(tb, {k: p.data().asnumpy()
                         for k, p in jb.collect_params().items()})
    jx = jmx.np.array(x)
    jx.attach_grad()
    with jmx.autograd.record(train_mode=train):
        jo = jb(jx)
        ct = _x(jo.shape, 9)
        (jo * jmx.np.array(ct)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    with mt.autograd.record(train_mode=train):
        to = tb(tx)
        (to * torch.from_numpy(ct)).sum().backward()
    jg = {k: p.grad().asnumpy() for k, p in jb.collect_params().items()
          if p.grad_req != "null"}
    tg = {k: p.grad().numpy() for k, p in tb.collect_params().items()
          if p.grad_req != "null"}
    return jb, tb, (jo.asnumpy(), jx.grad.asnumpy(), jg), (
        to.detach().numpy(), tx.grad.numpy(), tg)


def _check(label, j, t):
    _close(t[0], j[0], f"{label}: out")
    _close(t[1], j[1], f"{label}: input grad")
    assert sorted(t[2]) == sorted(j[2]), label
    for k in j[2]:
        _close(t[2][k], j[2][k], f"{label}: grad {k}")


def _dense_children(pkg, container, *args):
    net = container(*args)
    net.add(pkg.gluon.nn.Dense(4), pkg.gluon.nn.Dense(3, activation="tanh"))
    return net


def test_containers():
    """Sequential, HybridSequential (and a slice of it), Concatenate and
    HybridConcatenate over Dense children, Identity, and Lambda /
    HybridLambda of an operator name and of a callable."""
    x = _x((5, 6))
    for name, args in (("Sequential", ()), ("HybridSequential", ()),
                       ("Concatenate", (1,)), ("HybridConcatenate", (-1,))):
        jb, tb, j, t = _pair(
            lambda n=name, a=args: _dense_children(jmx, getattr(
                jmx.gluon.nn, n), *a),
            lambda n=name, a=args: _dense_children(mt, getattr(
                mt.gluon.nn, n), *a), x)
        assert list(tb.collect_params()) == list(jb.collect_params())
        _check(name, j, t)
        assert len(tb) == len(jb) == 2
    seq = mt.gluon.nn.HybridSequential(mt.gluon.nn.Dense(2),
                                       mt.gluon.nn.Dense(3))
    part = seq[1:]
    assert type(part) is mt.gluon.nn.HybridSequential and len(part) == 1
    assert part[0] is seq[1]
    for make in (lambda p: p.gluon.nn.Identity(),
                 lambda p: p.gluon.nn.Lambda("tanh"),
                 lambda p: p.gluon.nn.HybridLambda(lambda v: v * 2 + 1)):
        _, _, j, t = _pair(lambda: make(jmx), lambda: make(mt), x)
        _check("lambda", j, t)
    with pytest.raises(ValueError, match="no operator"):
        mt.gluon.nn.Lambda("no_such_op")


def test_group_instance_and_sync_batch_norm():
    """GroupNorm (2 groups), InstanceNorm and SyncBatchNorm on an NCHW
    input, each with gamma and beta from a seeded draw; SyncBatchNorm in
    training mode, its running statistics too."""
    x = _x((3, 4, 5, 6), 1) * 2 + 1
    init = jmx.initializer.Uniform(1.0)
    for name, args in (("GroupNorm", dict(num_groups=2)),
                       ("InstanceNorm", {}), ("SyncBatchNorm", {})):
        jb, tb, j, t = _pair(
            lambda n=name, a=args: getattr(jmx.gluon.nn, n)(**a),
            lambda n=name, a=args: getattr(mt.gluon.nn, n)(**a), x,
            train=name == "SyncBatchNorm", jinit=init)
        _check(name, j, t)
        if name == "SyncBatchNorm":
            assert isinstance(tb, mt.gluon.nn.BatchNorm)
            for k in ("running_mean", "running_var"):
                _close(getattr(tb, k)._tensor().detach().numpy(),
                       getattr(jb, k).data().asnumpy(), f"{name} {k}")


@pytest.mark.parametrize("case", [
    ("Conv1DTranspose", (4, 3), dict(strides=2, padding=1, output_padding=1),
     (2, 3, 7)),
    ("Conv2DTranspose", (4, (3, 2)), dict(strides=(2, 1), padding=(1, 0),
                                          output_padding=(1, 0),
                                          dilation=(1, 2)), (2, 3, 5, 6)),
    ("Conv2DTranspose", (4, 3), dict(strides=2, padding=1, layout="NHWC"),
     (2, 5, 6, 3)),
    ("Conv3DTranspose", (2, 2), dict(strides=2, padding=0), (1, 3, 3, 4, 2)),
], ids=["1d", "2d_dilated", "2d_nhwc", "3d"])
def test_conv_transpose(case):
    """Transposed convolutions: stride, padding on the dilated kernel
    extent, output_padding, dilation, both layouts; the weight
    ``(I, O/g, *k)`` (channels-last ``(I, *k, O/g)``) and a bias."""
    name, args, kwargs, shape = case
    x = _x(shape, 2)
    jb, tb, j, t = _pair(
        lambda: getattr(jmx.gluon.nn, name)(*args, **kwargs),
        lambda: getattr(mt.gluon.nn, name)(*args, **kwargs), x,
        jinit=jmx.initializer.Uniform(0.5))
    assert tb.weight.shape == jb.weight.shape
    _check(name, j, t)


def test_pad_reflection_and_depth_to_space():
    """ReflectionPad2D through its block; ``ops.tensor.pad`` in the
    constant, reflect and edge modes over pads wider than the dim (the
    reflection repeats) and its gradient; ``depth_to_space``."""
    x = _x((2, 3, 4, 5), 3)
    _, _, j, t = _pair(lambda: jmx.gluon.nn.ReflectionPad2D((1, 2)),
                       lambda: mt.gluon.nn.ReflectionPad2D((1, 2)), x)
    _check("ReflectionPad2D", j, t)
    widths = (0, 1, 2, 0, 5, 3, 1, 6)
    for mode in ("constant", "reflect", "edge"):
        want = jtensor.pad(jnp.asarray(x), mode=mode, pad_width=widths,
                           constant_value=1.5)
        xt = torch.from_numpy(x).requires_grad_()
        got = ttensor.pad(xt, mode=mode, pad_width=widths,
                          constant_value=1.5)
        _close(got.detach().numpy(), onp.asarray(want), f"pad {mode}")
        ct = _x(got.shape, 4)
        got.backward(torch.from_numpy(ct))
        _, vjp = jax.vjp(lambda v, m=mode: jtensor.pad(
            v, mode=m, pad_width=widths, constant_value=1.5), jnp.asarray(x))
        _close(xt.grad.numpy(), onp.asarray(vjp(jnp.asarray(ct))[0]),
               f"pad {mode} grad")
    y = _x((2, 12, 3, 4), 5)
    _close(ttensor.depth_to_space(torch.from_numpy(y), 2).numpy(),
           onp.asarray(jtensor.depth_to_space(jnp.asarray(y), 2)),
           "depth_to_space")


def test_pixel_shuffles():
    """PixelShuffle1D/2D/3D with per-axis factors."""
    for name, factor, shape in (
            ("PixelShuffle1D", 3, (2, 6, 5)),
            ("PixelShuffle2D", (2, 3), (2, 12, 3, 4)),
            ("PixelShuffle3D", (2, 1, 2), (1, 8, 2, 3, 2))):
        _, tb, j, t = _pair(lambda n=name, f=factor: getattr(
            jmx.gluon.nn, n)(f), lambda n=name, f=factor: getattr(
            mt.gluon.nn, n)(f), _x(shape, 6))
        _check(name, j, t)


def test_deformable_convolution():
    """DCNv1 and DCNv2 with offsets from a seeded (non-zero) offset
    convolution, stride 1 and padding 1, 2 deformable groups; gradients of
    the input, the weight, the bias and the offset convolution's
    parameters, through the bilinear gathers."""
    x = _x((2, 4, 6, 7), 8)
    kw = dict(channels=3, kernel_size=(3, 3), padding=(1, 1),
              num_deformable_group=2,
              offset_weight_initializer=None)
    for name in ("DeformableConvolution", "ModulatedDeformableConvolution"):
        _, tb, j, t = _pair(lambda n=name: getattr(jmx.gluon.nn, n)(**kw),
                            lambda n=name: getattr(mt.gluon.nn, n)(**kw), x,
                            jinit=jmx.initializer.Uniform(0.3))
        assert any(abs(v).max() > 0 for k, v in t[2].items()
                   if k.startswith("offset_conv"))
        _check(name, j, t)
