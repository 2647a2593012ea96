"""The ResNet-50 training step of the port, built the way a user would
(counterpart of bench.py:build_resnet_train, which times the same model
with a hand-written momentum update; here the update is the Trainer's, the
entry point users call, as bench.py:bench_whole_step's phased step).

``resnet50_v1(classes=1000, layout, stem_s2d)``, bf16 weights with f32
masters through ``amp.convert_hybrid_block`` (BatchNorm's gamma, beta and
running stats stay f32) and ``multi_precision=True``, SGD with momentum 0.9,
lr 0.1 and wd 1e-4 through the ``Trainer``, softmax cross-entropy on f32
logits, and one synthetic batch (224x224x3 images, 1000 classes) from a
seeded generator. Shared by chip_smoke.py and tools/profile_training.py.
``train_step=True`` runs the same step through ``gluon.TrainStep`` (one
CUDA graph replay a step on the card). ``kvstore=`` goes to the Trainer:
with a store of several workers each rank takes its own batch
(``data_seed``) and the step divides by the global batch.
"""
from __future__ import annotations

import functools

import torch

from .. import amp, autograd
from .. import device as _device
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo import vision
from ..gluon.train_step import TrainStep
from ..gluon.trainer import Trainer

__all__ = ["build_resnet_train", "synthetic_batch", "OPTIMIZER_PARAMS"]

#: SGD's settings beside the learning rate (bench.py's: momentum 0.9, wd 1e-4)
OPTIMIZER_PARAMS = dict(momentum=0.9, wd=1e-4)


def synthetic_batch(batch, layout, image, classes, seed, device):
    """``(x, y)``: ``batch`` images (normal draws) and labels from a
    generator seeded ``seed``, on ``device``."""
    data_gen = torch.Generator().manual_seed(seed)
    shape = ((batch, image, image, 3) if layout[-1] == "C"
             else (batch, 3, image, image))
    x = torch.randn(shape, generator=data_gen).to(device)
    y = torch.randint(0, classes, (batch,), generator=data_gen).to(device)
    return x, y


def build_resnet_train(batch=256, layout="NHWC", stem_s2d=True,
                       dtype="bfloat16", device=None, seed=0, image=224,
                       classes=1000, model=None, learning_rate=0.1,
                       train_step=False, init=None, kvstore=None,
                       data_seed=None):
    """``(net, trainer, step)``: ``step()`` runs one recorded forward on the
    one fixed batch, backward on the per-sample loss vector and
    ``trainer.step(batch)``, and returns that loss vector (on the device,
    f32). Weights and batch are drawn from ``seed``. ``model`` replaces
    ResNet-50 by another vision net built with the same ``layout`` (a narrow
    one for tests); ``init`` is the global initializer (default Uniform).
    With ``train_step=True``, ``step`` is
    ``functools.partial`` of a ``gluon.TrainStep`` over the same net, loss
    and trainer and the fixed batch (``step.func`` is the TrainStep).
    ``kvstore`` is the Trainer's; the batch comes from ``data_seed``
    (default ``seed + 1``), and ``trainer.step`` divides by ``batch``
    times the store's workers."""
    device = _device.resolve(device)
    net = model if model is not None else vision.resnet50_v1(
        classes=classes, layout=layout, stem_s2d=stem_s2d)
    gen = torch.Generator().manual_seed(seed)
    net.initialize(init=init, device=device, generator=gen)
    opt = dict(OPTIMIZER_PARAMS, learning_rate=learning_rate)
    if dtype == "bfloat16":
        amp.convert_hybrid_block(net, "bfloat16")
        opt["multi_precision"] = True
    elif dtype != "float32":
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
    x, y = synthetic_batch(batch, layout, image, classes,
                           seed + 1 if data_seed is None else data_seed,
                           device)
    trainer = Trainer(net.collect_params(), "sgd", opt, kvstore=kvstore)
    workers = trainer._kvstore.num_workers if trainer._kvstore else 1
    loss_fn = SoftmaxCrossEntropyLoss()
    if train_step:
        # the loss in f32, as mixed-precision training takes it
        return net, trainer, functools.partial(TrainStep(
            net, lambda out, label: loss_fn(out.float(), label), trainer),
            x, y)

    def step():
        with autograd.record():
            # the loss in f32, as mixed-precision training takes it
            loss = loss_fn(net(x).float(), y)
        autograd.backward(loss)
        trainer.step(batch * workers)
        return loss.detach()

    return net, trainer, step
