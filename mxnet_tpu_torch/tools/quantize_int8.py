"""Post-training INT8 quantization of a trained classifier, the port's copy
of the repository's ``example/quantize_int8.py`` (reference:
example/quantization/imagenet_inference.py: calibrate, quantize, compare
fp32 with int8 accuracy):

    python -m mxnet_tpu_torch.tools.quantize_int8 [--iters 120]
        [--batch-size 64] [--calib-mode naive|entropy] [--cpu]

Trains a small conv net on synthetic digits (Adam, lr 2e-3; the class is
the lit quadrant of a 12x12 image), calibrates with 4 batches,
swaps its Dense/Conv2D children for int8 blocks with ``quantize_net``
(their forward through the Q1 and Q2 kernels on the card), and fails
unless the fp32 net trained (accuracy >= 0.9) and the int8 net keeps its
accuracy within 0.05. Runs on ``cuda:0``, or on the CPU with ``--cpu``.
"""
from __future__ import annotations

import argparse

import numpy as onp
import torch

from .. import _random, autograd, gluon
from .. import device as _device
from ..contrib import quantization as qz
from ..ndarray.ndarray import array

__all__ = ["run"]


def run(iters=120, batch_size=64, calib_mode="naive", device=None, seed=0):
    """Train, calibrate, quantize; ``{"fp32_acc", "int8_acc", "net"}``
    (the quantized net) on ``device`` (default ``cuda:0``)."""
    dev = _device.resolve(device)
    _random.seed(seed)
    rs = onp.random.RandomState(seed)

    def batch(n):
        """Quadrant-brightness task: class = lit quadrant of a 12x12."""
        ys = rs.randint(0, 4, n)
        xs = 0.1 * rs.randn(n, 1, 12, 12).astype("f")
        for i, c in enumerate(ys):
            r0, c0 = (c // 2) * 6, (c % 2) * 6
            xs[i, 0, r0:r0 + 6, c0:c0 + 6] += 1.0
        return array(xs, device=dev), array(ys, device=dev)

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, 3, activation="relu"),
            gluon.nn.MaxPool2D(2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(32, activation="relu"),
            gluon.nn.Dense(4))
    net.initialize(device=dev, generator=torch.Generator().manual_seed(seed))
    net.hybridize()
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 2e-3})
    for _ in range(iters):
        x, y = batch(batch_size)
        with autograd.record():
            loss = lossfn(net(x), y)
        loss.backward()
        trainer.step(batch_size)

    def accuracy(model):
        hit = tot = 0
        for _ in range(8):
            x, y = batch(128)
            pred = model(x).asnumpy().argmax(-1)
            hit += int((pred == y.asnumpy()).sum())
            tot += 128
        return hit / tot

    fp32_acc = accuracy(net)
    calib = [batch(batch_size)[0] for _ in range(4)]
    qnet = qz.quantize_net(net, calib_data=calib, calib_mode=calib_mode)
    return dict(fp32_acc=fp32_acc, int8_acc=accuracy(qnet), net=qnet)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--calib-mode", default="naive",
                    choices=["naive", "entropy"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = _device.cpu() if args.cpu else _device.default_device()
    out = run(args.iters, args.batch_size, args.calib_mode, dev)
    fp32_acc, int8_acc = out["fp32_acc"], out["int8_acc"]
    print(f"fp32 acc {fp32_acc:.3f} | int8 acc {int8_acc:.3f} "
          f"({args.calib_mode} calibration)")
    if fp32_acc < 0.9:
        raise SystemExit("FAIL: fp32 net did not train")
    if int8_acc < fp32_acc - 0.05:
        raise SystemExit("FAIL: int8 lost more than 5% accuracy")
    print("int8 quantization example OK")
    return out


if __name__ == "__main__":
    main()
