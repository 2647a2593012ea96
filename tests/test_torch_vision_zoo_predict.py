"""The vision zoo's families in predict mode against the JAX package on
the CPU, each with the activations and pools it defines (relu, relu6, max
pooling: none of the substitutes the training comparisons of
``tests/test_torch_vision_zoo.py`` give both packages; dropout is the
identity in predict mode).

A kink moves a gradient element but not a value: a forward agrees to
rounding through it, so the logits are held within 1e-4 of their largest
value. The port's net is initialized by Xavier from a seeded generator,
takes its shapes from a forward, and then takes BatchNorm gamma, beta and
running statistics from a seeded ``RandomState`` (running variances in
[0.05, 0.5], so that relu6 clips at both ends); the JAX net loads the
port's ``save_parameters`` file and is hybridized.
"""
import os
import tempfile

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt


def _small_densenet(p):
    return p.gluon.model_zoo.vision.DenseNet(8, 4, [2, 2, 2, 2], bn_size=2,
                                             classes=10)


def _small_vgg_bn(p):
    return p.gluon.model_zoo.vision.VGG([1, 1, 1, 1, 1], [4, 8, 8, 16, 16],
                                        classes=10, batch_norm=True)


def _zoo(name, **kwargs):
    return lambda p: p.gluon.model_zoo.vision.get_model(name, **kwargs)


#: name: (builder of either package's net, input side). Full width where
#: the net is small enough for the CPU; DenseNet and VGG narrow, as their
#: training comparisons build them. Inception v3 and AlexNet are in
#: ``tests/test_torch_vision_zoo_predict_more.py``
FAMILIES = {
    "mobilenet_v2_1_0": (_zoo("mobilenet_v2_1_0"), 64),
    "mobilenet1_0": (_zoo("mobilenet1_0"), 64),
    "densenet": (_small_densenet, 224),
    "vgg_bn": (_small_vgg_bn, 32),
    "squeezenet1_0": (_zoo("squeezenet1_0"), 64),
    "squeezenet1_1": (_zoo("squeezenet1_1"), 64),
}


def _random_bn_state(net, seed):
    r = onp.random.RandomState(seed)
    for m in net.modules():
        if isinstance(m, mt.gluon.nn.BatchNorm):
            c = m.gamma.shape[0]
            for prm, value in (
                    (m.gamma, r.uniform(0.5, 1.5, c)),
                    (m.beta, r.standard_normal(c) * 0.5),
                    (m.running_mean, r.standard_normal(c) * 0.5),
                    (m.running_var, r.uniform(0.05, 0.5, c))):
                prm.set_data(torch.from_numpy(value.astype("f")))


def predict_pair(name, make, hw):
    """One predict-mode forward of batch 2: the port's logits within 1e-4
    of the JAX package's largest; where the net has relu6 (MobileNetV2),
    some of its inputs lie above 6 and some below 0."""
    x = onp.random.RandomState(7).standard_normal(
        (2, 3, hw, hw)).astype("f")
    tnet, jnet = make(mt), make(jmx)
    tnet.initialize(init=mt.initializer.Xavier(), device=mt.cpu(),
                    generator=torch.Generator().manual_seed(11))
    with mt.autograd.predict_mode():
        tnet(torch.from_numpy(x))
    _random_bn_state(tnet, 12)
    # the load overwrites every parameter (test_torch_vision_zoo.train_pair)
    jnet.initialize(init=jmx.initializer.Zero())
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "net.params")
        tnet.save_parameters(path)
        mt.waitall()   # the port writes on an IO thread too
        jnet.load_parameters(path)
    jnet.hybridize()
    relu6_in = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: relu6_in.append(
            (args[0].min().item(), args[0].max().item())))
        for m in tnet.modules()
        if isinstance(m, mt.gluon.nn.Activation) and m._act == "relu6"]
    with mt.autograd.predict_mode():
        got = tnet(torch.from_numpy(x)).detach().numpy()
    for h in hooks:
        h.remove()
    want = jnet(jmx.np.array(x)).asnumpy()
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=1e-4,
                                atol=1e-4 * onp.abs(want).max())
    if name == "mobilenet_v2_1_0":
        assert len(relu6_in) == 36
        assert min(lo for lo, _ in relu6_in) < 0 < 6 < max(
            hi for _, hi in relu6_in)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_predict_forward_real_activations(name):
    """:func:`predict_pair` on each family of :data:`FAMILIES`."""
    predict_pair(name, *FAMILIES[name])
