"""LeNet on MNIST fed by the port's DataLoader (counterpart of
example/train_mnist.py, BASELINE config #1):

    python -m mxnet_tpu_torch.tools.train_mnist [--epochs 2]
        [--batch-size 64] [--lr 0.05] [--limit N] [--device cuda:0|cpu]
        [--num-workers 0] [--thread-pool] [--device-prefetch N]
        [--pin-memory] [--train-step]

The example's own loop and defaults: ``gluon.data.vision.MNIST`` (the
synthetic 1024 samples when no idx files are under its root) through
``gluon.data.DataLoader(shuffle=True, last_batch="discard")``,
``lenet(classes=10)`` initialized and hybridized, ``sgd`` with lr 0.05
and momentum 0.9 through the Trainer, ``SoftmaxCrossEntropyLoss`` and
``gluon.metric.Accuracy``; each step is ``x.astype("float32") / 255.0``,
the NHWC batch transposed to NCHW, ``autograd.record()`` ->
``loss.backward()`` -> ``trainer.step(batch)`` -> ``metric.update``. The
loader's worker mode, ``device_prefetch`` and ``pin_memory`` are options;
``--train-step`` runs the update through ``gluon.TrainStep`` (the metric
is then not updated: the step returns the loss alone). Runs on ``cuda:0``
unless ``--device cpu``. Prints the example's accuracy lines and one JSON
line of the run's statistics (:func:`run_epochs`).

:func:`run_epochs` is the loop, shared with tools/train_cifar_resnet.py
and chip_smoke.py.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import time

import numpy as np
import torch

from .. import _random, autograd, gluon
from .. import device as _device
from ..gluon.train_step import TrainStep

__all__ = ["build_mnist_train", "run_epochs", "loader_args"]


def device_scope(device):
    """A ``with`` scope for ``device``: none for ``cuda:0`` (the default
    device, and the main path runs without a function mode), the device's
    own scope otherwise (``with mx.cpu():``)."""
    if device.type == "cuda" and device.index in (None, 0):
        return contextlib.nullcontext()
    return device


def loader_args(args):
    """The DataLoader keywords of the tools' loader options."""
    return dict(num_workers=args.num_workers, thread_pool=args.thread_pool,
                device_prefetch=args.device_prefetch,
                pin_memory=args.pin_memory, timeout=args.timeout)


def build_mnist_train(batch_size=64, lr=0.05, limit=0, device=None,
                      loader_kw=None, seed=0):
    """``(net, trainer, loader, lossfn, metric)`` as the example builds
    them: ``mx.seed(seed)`` and the net's weights from a generator seeded
    ``seed``; the loader's shuffle draws from numpy's global RNG (seed it
    with ``np.random.seed`` before each epoch's iteration)."""
    device = _device.resolve(device)
    _random.seed(seed)
    train = gluon.data.vision.MNIST(train=True)
    if limit:
        train = gluon.data.SimpleDataset(
            [train[i] for i in range(min(limit, len(train)))])
    loader = gluon.data.DataLoader(
        train, batch_size=batch_size, shuffle=True, last_batch="discard",
        **(loader_kw or {}))
    net = gluon.model_zoo.vision.get_model("lenet", classes=10)
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(seed))
    net.hybridize()
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0.9})
    return net, trainer, loader, lossfn, gluon.metric.Accuracy()


def mnist_prep(x):
    """The example's conversion: float32 in [0, 1], NCHW."""
    x = x.astype("float32") / 255.0
    if x.ndim == 3:
        return x.reshape(x.shape[0], 1, 28, 28)
    if x.shape[-1] == 1:
        return x.transpose(0, 3, 1, 2)
    return x


def _digest(arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a.asnumpy()).tobytes())
    return h.hexdigest()


def run_epochs(net, trainer, loader, lossfn, metric, epochs, prep,
               device, train_step=False, keep_batches=False, seed=0,
               log=print, max_steps=None):
    """Train ``epochs`` epochs over ``loader`` the example's way and
    return the run's statistics: ``losses`` (the mean loss a step),
    ``wait_ms`` (host ms in ``next(loader)`` a step), ``step_ms`` (the
    step from its batch in hand to ``trainer.step`` issued: device ms from
    CUDA events on a card, host ms on the CPU), ``samples_per_s`` (the
    samples after the warm-up steps over the wall time from their end,
    synchronised, to the run's end; the warm-up is the first step, and
    with ``train_step`` the second too, which captures the graph;
    ``samples_per_s_with_first``: all of them over the whole run),
    ``steps``,
    ``metric``, ``batch_digests`` (sha1 of each batch's arrays, in order,
    with ``keep_batches``) and ``pids`` (the loader's worker processes
    seen during the run). ``np.random.seed(seed + epoch)`` is called
    before each epoch's iteration, so every worker mode draws the same
    order. ``max_steps`` stops early (a test's two steps)."""
    import multiprocessing as mp

    cuda = device.type == "cuda"
    step = TrainStep(net, lossfn, trainer) if train_step else None
    warm = 2 if train_step else 1
    losses, wait_ms, marks, host_ms, kept, pids = [], [], [], [], [], set()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with device_scope(device):
        sync()
        t_start = time.perf_counter()
        for epoch in range(epochs):
            metric.reset()
            np.random.seed(seed + epoch)
            it = iter(loader)
            while max_steps is None or len(losses) < max_steps:
                t0 = time.perf_counter()
                try:
                    x, y = next(it)
                except StopIteration:
                    break
                wait_ms.append(1e3 * (time.perf_counter() - t0))
                pids.update(p.pid for p in mp.active_children())
                if keep_batches:
                    kept.append((x, y))
                t1 = time.perf_counter()
                if cuda:
                    begin = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    begin.record()
                x = prep(x)
                if step is not None:
                    loss = step(x, y)
                else:
                    with autograd.record():
                        out = net(x)
                        loss = lossfn(out, y)
                    loss.backward()
                    trainer.step(x.shape[0])
                if cuda:
                    end.record()
                    marks.append((begin, end))
                host_ms.append(1e3 * (time.perf_counter() - t1))
                losses.append(loss.mean())
                if step is None:
                    metric.update(y, out)
                if len(losses) == warm:
                    sync()
                    t_steady = time.perf_counter()
            else:
                it.close()
            if step is None and metric.num_inst:
                log(f"epoch {epoch}: train {metric.get()[0]} ="
                    f" {metric.get()[1]:.4f}")
        sync()
        t_end = time.perf_counter()
    n = len(losses)
    batch = loader._batch_sampler._batch_size
    return {
        "steps": n,
        "samples_per_s": ((n - warm) * batch / (t_end - t_steady)
                          if n > warm else None),
        "samples_per_s_with_first": n * batch / (t_end - t_start),
        "seconds": t_end - t_start,
        "losses": [float(v) for v in losses],
        "wait_ms": wait_ms,
        "step_ms": ([b.elapsed_time(e) for b, e in marks] if cuda
                    else host_ms),
        "host_ms": host_ms,
        "metric": metric.get() if step is None else None,
        "batch_digests": [_digest(b) for b in kept],
        "pids": sorted(pids),
    }


def p50(values):
    return sorted(values)[len(values) // 2] if values else None


def add_loader_options(ap):
    ap.add_argument("--device", default=None,
                    help="cuda:0 (the default) or cpu")
    ap.add_argument("--num-workers", type=int, default=0)
    ap.add_argument("--thread-pool", action="store_true")
    ap.add_argument("--device-prefetch", type=int, default=None)
    ap.add_argument("--pin-memory", action="store_true")
    ap.add_argument("--timeout", type=float, default=120)
    ap.add_argument("--train-step", action="store_true",
                    help="run the update through gluon.TrainStep")


def summary(stats):
    """The printed line of a run: everything but the per-step lists."""
    return {
        "steps": stats["steps"], "samples_per_s": stats["samples_per_s"],
        "step_ms_p50": p50(stats["step_ms"]),
        "wait_ms_p50": p50(stats["wait_ms"]),
        "wait_ms_mean": (sum(stats["wait_ms"]) / len(stats["wait_ms"])
                         if stats["wait_ms"] else None),
        "first_loss": stats["losses"][0] if stats["losses"] else None,
        "last_loss": stats["losses"][-1] if stats["losses"] else None,
        "metric": stats["metric"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--limit", type=int, default=0,
                    help="cap samples per epoch (0 = all)")
    add_loader_options(ap)
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)
    net, trainer, loader, lossfn, metric = build_mnist_train(
        args.batch_size, args.lr, args.limit, device, loader_args(args))
    try:
        stats = run_epochs(net, trainer, loader, lossfn, metric, args.epochs,
                           mnist_prep, device, train_step=args.train_step)
    finally:
        loader.close()
    if stats["metric"] is not None:
        print(f"final {stats['metric'][0]}: {stats['metric'][1]:.4f}")
    print(json.dumps(summary(stats)))
    return stats


if __name__ == "__main__":
    main()
