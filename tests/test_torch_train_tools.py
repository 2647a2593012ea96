"""The port's training tools fed by its DataLoader against the JAX
package's example loops (example/train_mnist.py,
example/train_cifar_resnet.py) on the CPU, from the same weights
(``convert.load_jax_params``) and the same batch order (``np.random.seed``
before both loaders: neither package's ``mx.seed`` seeds numpy).

Tolerances: LeNet's losses and parameters over two SGD-momentum steps
within 1e-4 of each tensor's largest value (as tests/test_torch_lenet.py);
the CIFAR tool's first loss, a narrow ResNet v1 with BatchNorm in
training mode, within 1e-5 relative (the deep-BatchNorm parity issues of
PERF.md §6 concern gradients through many steps; one forward agrees to
float rounding)."""
import numpy as onp

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.tools import train_cifar_resnet, train_mnist


def _close(got, want, what, rel=1e-4):
    got, want = onp.asarray(got, "f"), onp.asarray(want, "f")
    scale = max(float(onp.abs(want).max()), 1e-6)
    err = float(onp.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3g} (scale {scale:.3g})"


def _jax_loop(net, dataset, batch, prep, opt, steps, lossfn):
    """The example's loop in the JAX package, ``steps`` steps."""
    jmx.seed(0)
    loader = jmx.gluon.data.DataLoader(dataset, batch_size=batch,
                                       shuffle=True, last_batch="discard")
    trainer = jmx.gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]))
    onp.random.seed(0)
    losses = []
    for x, y in loader:
        x = prep(x)
        with jmx.autograd.record():
            loss = lossfn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean()))
        if len(losses) == steps:
            break
    return losses


def _carry(jnet, tnet):
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})


def test_train_mnist_two_steps_match_the_example():
    dev = mt.cpu()
    net, trainer, loader, lossfn, metric = train_mnist.build_mnist_train(
        batch_size=16, limit=64, device=dev)
    jds = jmx.gluon.data.vision.MNIST(train=True)
    jds = jmx.gluon.data.SimpleDataset([jds[i] for i in range(64)])
    jnet = jvision.get_model("lenet", classes=10)
    jnet.initialize()
    jnet.hybridize()
    jnet(jmx.np.zeros((16, 1, 28, 28)))
    _carry(jnet, net)
    stats = train_mnist.run_epochs(net, trainer, loader, lossfn, metric, 1,
                                   train_mnist.mnist_prep, dev, max_steps=2,
                                   log=lambda *_: None)
    want = _jax_loop(jnet, jds, 16, lambda x: (x.astype("float32") / 255.0)
                     .transpose(0, 3, 1, 2),
                     ("sgd", {"learning_rate": 0.05, "momentum": 0.9}), 2,
                     jmx.gluon.loss.SoftmaxCrossEntropyLoss())
    assert stats["steps"] == 2 and len(stats["wait_ms"]) == 2
    _close(stats["losses"], want, "losses")
    jp = jnet.collect_params()
    for k, p in net.collect_params().items():
        _close(p.data().asnumpy(), jp[k].data().asnumpy(), k)
    assert metric.num_inst == 32


def test_train_cifar_tool_first_loss_matches_the_example():
    dev = mt.cpu()

    def narrow(v):
        return v.resnet.ResNetV1(v.resnet.BasicBlockV1, [1, 1], [8, 8, 16],
                                 classes=10)

    net, trainer, loader, lossfn, metric = \
        train_cifar_resnet.build_cifar_train(batch_size=8, limit=16,
                                             device=dev, model=narrow(tvision))
    jds = jmx.gluon.data.vision.CIFAR10(train=True)
    jds = jmx.gluon.data.SimpleDataset([jds[i] for i in range(16)])
    jnet = narrow(jvision)
    jnet.initialize()
    jnet.hybridize()
    jnet(jmx.np.zeros((8, 3, 32, 32)))
    _carry(jnet, net)
    stats = train_mnist.run_epochs(
        net, trainer, loader, lossfn, metric, 1,
        train_cifar_resnet.cifar_prep("float32"), dev, max_steps=1,
        log=lambda *_: None)
    want = _jax_loop(jnet, jds, 8, lambda x: (x.astype("float32") / 255.0)
                     .transpose(0, 3, 1, 2),
                     ("nag", {"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4}), 1,
                     jmx.gluon.loss.SoftmaxCrossEntropyLoss())
    onp.testing.assert_allclose(stats["losses"], want, rtol=1e-5)
