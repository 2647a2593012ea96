"""ResNet-18 on CIFAR-10 fed by the port's DataLoader (counterpart of
example/train_cifar_resnet.py, BASELINE config #2's style):

    python -m mxnet_tpu_torch.tools.train_cifar_resnet [--epochs 1]
        [--batch-size 64] [--lr 0.05] [--limit N] [--bf16]
        [--device cuda:0|cpu] [--num-workers 0] [--thread-pool]
        [--device-prefetch N] [--pin-memory] [--train-step]

The example's loop and defaults: ``gluon.data.vision.CIFAR10`` (the
synthetic 1024 samples when its root is no directory) through
``DataLoader(shuffle=True, last_batch="discard")``, ``resnet18_v1(classes=
10)`` at full width, ``amp.convert_hybrid_block(net, "bfloat16")`` with
``--bf16`` (BatchNorm's parameters stay f32), hybridized, ``nag`` with lr
0.05, momentum 0.9 and wd 1e-4 through the Trainer (``multi_precision``
with ``--bf16``, the f32 masters), ``SoftmaxCrossEntropyLoss`` and
``Accuracy``; each step is ``x.astype("bfloat16" or "float32") / 255.0``
and ``x.transpose(0, 3, 1, 2)``, so BatchNorm runs the NCHW path of the
BatchNorm kernels on the card, then ``autograd.record()`` ->
``loss.backward()`` -> ``trainer.step(batch)`` -> ``metric.update``. The
loss is taken in f32. Options and the printed lines as in
tools/train_mnist.py.
"""
from __future__ import annotations

import argparse
import json

import torch

from .. import _random, amp, gluon
from .. import device as _device
from .train_mnist import (add_loader_options, loader_args, run_epochs,
                          summary)

__all__ = ["build_cifar_train", "cifar_prep"]


def build_cifar_train(batch_size=64, lr=0.05, limit=0, bf16=False,
                      device=None, loader_kw=None, seed=0, model=None):
    """``(net, trainer, loader, lossfn, metric)`` as the example builds
    them (``model`` replaces ResNet-18 by a narrow net for tests)."""
    device = _device.resolve(device)
    _random.seed(seed)
    train = gluon.data.vision.CIFAR10(train=True)
    if limit:
        train = gluon.data.SimpleDataset(
            [train[i] for i in range(min(limit, len(train)))])
    loader = gluon.data.DataLoader(train, batch_size=batch_size,
                                   shuffle=True, last_batch="discard",
                                   **(loader_kw or {}))
    net = model if model is not None else \
        gluon.model_zoo.vision.resnet18_v1(classes=10)
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(seed))
    opt = {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4}
    if bf16:
        amp.convert_hybrid_block(net, target_dtype="bfloat16")
        opt["multi_precision"] = True
    net.hybridize()
    loss = gluon.loss.SoftmaxCrossEntropyLoss()

    def lossfn(out, y):
        # f32 logits; TrainStep's capture hands tensors, the loop NDArrays
        return loss(out.float() if isinstance(out, torch.Tensor)
                    else out.astype("float32"), y)

    trainer = gluon.Trainer(net.collect_params(), "nag", opt)
    return net, trainer, loader, lossfn, gluon.metric.Accuracy()


def cifar_prep(dtype):
    def prep(x):
        return (x.astype(dtype) / 255.0).transpose(0, 3, 1, 2)
    return prep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    add_loader_options(ap)
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)
    net, trainer, loader, lossfn, metric = build_cifar_train(
        args.batch_size, args.lr, args.limit, args.bf16, device,
        loader_args(args))
    try:
        stats = run_epochs(net, trainer, loader, lossfn, metric, args.epochs,
                           cifar_prep("bfloat16" if args.bf16
                                      else "float32"),
                           device, train_step=args.train_step)
    finally:
        loader.close()
    print(json.dumps(summary(stats)))
    return stats


if __name__ == "__main__":
    main()
