"""The vision zoo of the port against the JAX package on the CPU.

Every constructor's ``collect_params()`` names and shapes at full width
(the JAX package's full list of ``get_model`` names), MobileNetV2-1.0's
shapes inferred from a forward, the grouped (depthwise) convolution's
weight layout in bfloat16, and MobileNetV2 trained narrow. The other
families train narrow or on small inputs in
``tests/test_torch_vision_zoo_{more,deep,inception}.py``, through
:func:`train_pair` here.

A narrow build runs in both packages from the same weights (the port's,
loaded into the JAX net from its ``save_parameters`` file): two
SGD-momentum steps with BatchNorm in training mode, compared step by step
(tolerances in :func:`train_pair`).
Two things would differ for reasons that are not the port's, so both
packages get the same substitute for the test (:func:`same_noise`):

* Dropout draws its masks from threefry in the JAX package and from
  Philox in the port: one numpy mask generator serves both, the k-th
  dropout call of a forward drawing the k-th mask (the JAX package traces
  its hybridized step once, so its masks are fixed per call site; here
  too).
* ReLU and ReLU6 have kinks: an activation within rounding of 0 takes
  the other branch in one package, and through a chain of BatchNorms in
  training mode the gradients of a 12-deep relu chain then differ by 3 %
  of the largest gradient where softplus or tanh stay within 6e-6
  (measured). Both packages' relu and relu6 become softplus here; the
  activations themselves are held in ``tests/test_torch_activations.py``.
"""
import os
import tempfile

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import nn as jnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.ops import nn as tnn

OPT = dict(learning_rate=1e-3, momentum=0.9, wd=1e-4)


def same_noise(monkeypatch):
    """Both packages' dropout take mask k of a forward from
    ``RandomState(1000 + k)``, and their relu and relu6 become softplus
    (module docstring); returns the per-forward counter reset."""
    for acts in (jnn._ACTS, tnn._ACTS):
        for name in ("relu", "relu6"):
            monkeypatch.setitem(acts, name, acts["softrelu"])
    calls = [0]

    def mask(shape, p):
        k = calls[0]
        calls[0] += 1
        return onp.random.RandomState(1000 + k).uniform(size=shape) >= p

    def jax_dropout(x, key, p=0.5, training=True, axes=None):  # noqa: ARG001
        if not training or p <= 0.0:
            return x
        return jnp.where(jnp.asarray(mask(x.shape, p)), x / (1.0 - p),
                         jnp.zeros((), x.dtype))

    def torch_dropout(x, p=0.5, training=True, axes=None,
                      generator=None):  # noqa: ARG001
        if not training or p <= 0.0:
            return x
        m = torch.from_numpy(mask(tuple(x.shape), p))
        return torch.where(m, x / (1.0 - p), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(jnn, "dropout", jax_dropout)
    monkeypatch.setattr(tnn, "dropout", torch_dropout)

    def reset():
        calls[0] = 0

    return reset


def _close(got, want, msg, tol=1e-4):
    """Within ``tol`` of the largest element of ``want``."""
    want = onp.asarray(want, "f")
    onp.testing.assert_allclose(onp.asarray(got, "f"), want, rtol=tol,
                                atol=tol * max(onp.abs(want).max(), 1e-30),
                                err_msg=msg)


def train_pair(make, x, y, steps=2, reset=lambda: None):
    """``make(pkg)`` builds the net of a package (``jmx`` or ``mt``). The
    port's is initialized by Xavier from a seeded generator (the default
    Uniform(0.07) leaves a narrow net's activations so small that
    BatchNorm's gradients reach 1e3 and one step at lr 1e-3 moves a
    weight by 1) and takes its shapes from a forward; the JAX net loads
    the port's ``save_parameters`` file, which refuses any name it lacks,
    and is hybridized (so it compiles once, with no eager pass). Each
    step: logits and the per-sample softmax cross entropy within 1e-4 of
    their largest value; the first step's gradients within 1e-4 of the
    net's largest gradient (as the ResNet test holds them: a BatchNorm's
    beta that feeds another BatchNorm has a gradient of exact zero, here
    cancellation noise); the parameters and running statistics after each
    ``Trainer.step`` within 1e-4 of their largest value (at least 1e-2: a
    running mean of an input whose mean is exactly zero holds rounding
    noise) plus 1e-4 of the steps the largest gradient has taken. Returns
    the port's net."""
    tnet, jnet = make(mt), make(jmx)
    tnet.initialize(init=mt.initializer.Xavier(), device=mt.cpu(),
                    generator=torch.Generator().manual_seed(11))
    with mt.autograd.predict_mode():
        tnet(torch.from_numpy(x))
    # the load overwrites every parameter: Zero only spares the JAX
    # package's default Uniform, a random draw compiled for each weight
    # shape (~12 s of MobileNetV2's test)
    jnet.initialize(init=jmx.initializer.Zero())
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "net.params")
        tnet.save_parameters(path)
        mt.waitall()   # the port writes on an IO thread too
        jnet.load_parameters(path)
    jnet.hybridize()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    jlf, tlf = (jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                mt.gluon.loss.SoftmaxCrossEntropyLoss())
    for step in range(steps):
        reset()
        with jmx.autograd.record():
            jl = jnet(jmx.np.array(x))
            jloss = jlf(jl, jmx.np.array(y))
        jloss.backward()
        reset()
        with mt.autograd.record():
            tl = tnet(torch.from_numpy(x))
            tloss = tlf(tl, torch.from_numpy(y).long())
        mt.autograd.backward(tloss)
        _close(tl.detach().numpy(), jl.asnumpy(), f"logits, step {step}")
        _close(tloss.detach().numpy(), jloss.asnumpy(), f"loss, step {step}")
        if step == 0:
            jg = {k: p.grad().asnumpy() for k, p in
                  jnet.collect_params().items() if p.grad_req != "null"}
            tg = {k: p.grad().numpy() for k, p in
                  tnet.collect_params().items() if p.grad_req != "null"}
            assert sorted(tg) == sorted(jg)
            big = max(onp.abs(g).max() for g in jg.values())
            for k in jg:
                onp.testing.assert_allclose(tg[k], jg[k], rtol=1e-4,
                                            atol=1e-4 * big, err_msg=k)
        jtr.step(x.shape[0])
        ttr.step(x.shape[0])
        jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
        for k, p in tnet.collect_params().items():
            onp.testing.assert_allclose(
                p._tensor().detach().numpy(), jp[k], rtol=1e-4,
                atol=1e-4 * (max(onp.abs(jp[k]).max(), 1e-2)
                             + OPT["learning_rate"] * (step + 1) * big),
                err_msg=f"{k} after step {step}")
    return tnet

@pytest.fixture
def noise(monkeypatch):
    return same_noise(monkeypatch)


ZOO = ["alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
       "inception_v3", "lenet", "mobilenet0_25", "mobilenet0_5",
       "mobilenet0_75", "mobilenet1_0", "mobilenet_v2_0_25",
       "mobilenet_v2_0_5", "mobilenet_v2_0_75", "mobilenet_v2_1_0",
       "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
       "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
       "resnet101_v2", "resnet152_v2", "squeezenet1_0", "squeezenet1_1",
       "vgg11", "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn",
       "vgg19", "vgg19_bn"]


def _shapes(net):
    return [(k, tuple(p.shape)) for k, p in net.collect_params().items()]


def test_every_constructor_names_and_declared_shapes():
    """``get_model`` knows the JAX package's names; each full-width net
    has the same ``collect_params()`` names, in order, and declared shapes
    (unknown input dims 0 in both); ``pretrained=True`` raises."""
    jv, tv = jmx.gluon.model_zoo.vision, mt.gluon.model_zoo.vision
    assert sorted(tv._MODELS) == sorted(jv._MODELS) == sorted(ZOO)
    for name in ZOO:
        assert _shapes(tv.get_model(name)) == _shapes(jv.get_model(name)), \
            name
    for name in ("alexnet", "densenet121", "inception_v3", "mobilenet1_0",
                 "mobilenet_v2_1_0", "squeezenet1_1", "vgg16_bn"):
        with pytest.raises(ValueError, match="pretrained"):
            tv.get_model(name, pretrained=True)
    with pytest.raises(ValueError, match="unknown model"):
        tv.get_model("no_such_net")


def test_mobilenet_v2_full_width_inferred_shapes():
    """MobileNetV2-1.0 (classes 1000) after a forward: every inferred
    shape equals the JAX package's (the shapes do not depend on the
    input's size past its pooling, so 32x32 stands for 224x224); 53
    BatchNorm sites; and the port's checkpoint of it loads into the JAX
    net with no name or shape refused."""
    x = onp.random.RandomState(0).standard_normal((1, 3, 32, 32)).astype("f")
    jnet = jmx.gluon.model_zoo.vision.mobilenet_v2_1_0()
    jnet.initialize(init=jmx.initializer.Zero())
    jnet.infer_shape(jmx.np.array(x))
    tnet = mt.gluon.model_zoo.vision.mobilenet_v2_1_0()
    tnet.initialize(device=mt.cpu())
    tnet.infer_shape(torch.from_numpy(x))
    assert _shapes(tnet) == _shapes(jnet)
    assert sum(isinstance(m, mt.gluon.nn.BatchNorm)
               for m in tnet.modules()) == 53
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mnv2.params")
        tnet.save_parameters(path)
        mt.waitall()   # the port writes on an IO thread too
        fresh = jmx.gluon.model_zoo.vision.mobilenet_v2_1_0()
        fresh.load_parameters(path)
    assert _shapes(fresh) == _shapes(tnet)


def test_depthwise_conv_weight_layout_bf16():
    """``Conv2D(groups=C)`` in bfloat16 NCHW, as MobileNet's depthwise
    layers run: the (C, 1, 3, 3) weight and a stride of 2 against the JAX
    package's ``conv`` with ``groups``, forward within one bfloat16 unit
    (2^-7) of the largest value, and the layer's f32 gradients within
    1e-5 of the largest."""
    r = onp.random.RandomState(1)
    x = r.standard_normal((2, 24, 9, 9)).astype("f")
    w = r.standard_normal((24, 1, 3, 3)).astype("f")
    want = jnn.conv(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), stride=(2, 2), pad=(1, 1),
                     groups=24)
    got = tnn.conv(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16(), stride=(2, 2), pad=(1, 1),
                   groups=24)
    want = onp.asarray(want.astype(jnp.float32))
    _close(got.float().numpy(), want, "depthwise bf16", tol=2.0 ** -7)
    make = lambda p: p.gluon.nn.Conv2D(24, 3, 2, 1, groups=24,  # noqa: E731
                                       use_bias=False)
    jb, tb = make(jmx), make(mt)
    jb.initialize()
    jb(jmx.np.array(x))
    tb.initialize(device=mt.cpu())
    tb(torch.from_numpy(x))
    load_jax_params(tb, {"weight": jb.weight.data().asnumpy()})
    assert tb.weight.shape == jb.weight.shape == (24, 1, 3, 3)
    with jmx.autograd.record():
        jb(jmx.np.array(x)).sum().backward()
    with mt.autograd.record():
        tb(torch.from_numpy(x)).sum().backward()
    _close(tb.weight.grad().numpy(), jb.weight.grad().asnumpy(),
           "depthwise weight grad", tol=1e-5)


def _batch(n, hw, classes=10, seed=0):
    r = onp.random.RandomState(seed)
    return (r.standard_normal((n, 3, hw, hw)).astype("f"),
            r.randint(0, classes, n).astype("int32"))


def test_mobilenet_v2_narrow_training(noise):
    """MobileNetV2 at multiplier 0.25, batch 8 of 64x64: 17 bottlenecks,
    the residual adds, 53 BatchNorm sites in training mode."""
    x, y = _batch(8, 64)
    net = train_pair(lambda p: p.gluon.model_zoo.vision.MobileNetV2(
        0.25, classes=10), x, y, reset=noise)
    assert sum(isinstance(m, mt.gluon.nn.BatchNorm)
               for m in net.modules()) == 53
