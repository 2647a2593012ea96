"""LeNet-MNIST imperative training, BASELINE config #1 as
``bench.py:bench_lenet_imperative`` (:280-310) builds it, on the port's
NDArray frontend:

    python -m mxnet_tpu_torch.tools.train_lenet [--batch 256] [--steps 7]
        [--cpu]

``lenet(classes=10)`` at its full width, a batch of 1x28x28 f32 images from
``mx.np.random.uniform`` and labels from ``mx.np.random.randint``,
``SoftmaxCrossEntropyLoss`` and ``Trainer("sgd", lr 0.05)``; every step is
``with autograd.record(): L = lossfn(net(x), y)`` -> ``L.backward()`` ->
``trainer.step(batch)`` with nothing but NDArrays in user code. Runs on
``cuda:0`` (the optimizer update through the ladder kernel, 10 launches a
step), or on the CPU with ``--cpu``. Prints the loss and host ms of each
step (each ends in a synchronising read of the loss).
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from .. import _random, autograd
from .. import device as _device
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo.vision import lenet
from ..gluon.train_step import TrainStep
from ..gluon.trainer import Trainer
from ..numpy import random as np_random

__all__ = ["build_lenet_train"]


def build_lenet_train(batch=256, device=None, seed=0, learning_rate=0.05,
                      optimizer_params=None, train_step=False):
    """``(net, trainer, step, (x, y))``: ``step()`` runs one recorded
    forward of the one fixed batch, ``L.backward()`` on the per-sample loss
    and ``trainer.step(batch)``, and returns the loss NDArray. Weights come
    from ``seed``, the batch from ``mx.random.seed(seed)``. With
    ``train_step=True``, ``step`` is ``functools.partial`` of a
    ``gluon.TrainStep`` over the same net, loss and trainer and the batch
    (``step.func`` is the TrainStep; one CUDA graph replay a step)."""
    device = _device.resolve(device)
    net = lenet(classes=10)
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(seed))
    _random.seed(seed)
    x = np_random.uniform(size=(batch, 1, 28, 28), device=device)
    y = np_random.randint(0, 10, (batch,), device=device)
    lossfn = SoftmaxCrossEntropyLoss()
    trainer = Trainer(net.collect_params(), "sgd",
                      dict(optimizer_params or {},
                           learning_rate=learning_rate))
    if train_step:
        return (net, trainer,
                functools.partial(TrainStep(net, lossfn, trainer), x, y),
                (x, y))

    def step():
        with autograd.record():
            loss = lossfn(net(x), y)
        loss.backward()
        trainer.step(batch)
        return loss

    return net, trainer, step, (x, y)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = _device.cpu() if args.cpu else _device.default_device()
    _, _, step, _ = build_lenet_train(batch=args.batch, device=dev)
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss = float(step().mean())       # synchronises
        print(f"step {i}: loss {loss:.6f} "
              f"{1e3 * (time.perf_counter() - t0):.2f} ms on {dev}")


if __name__ == "__main__":
    main()
