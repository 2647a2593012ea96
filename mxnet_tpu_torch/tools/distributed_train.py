"""Data-parallel training across processes (counterpart of
example/distributed_train.py), launched by the port's launcher:

    python -m mxnet_tpu_torch.tools.launch -n 2 \\
        python -m mxnet_tpu_torch.tools.distributed_train [--cpu]

The example: every rank joins the job through ``kvstore.create('tpu_dist')``,
builds ``Dense(64, relu) -> Dense(10)`` from seed 0, takes rank 0's
parameters (``kv.broadcast``), and trains 5 SGD steps (lr 0.1) on 32 rows
of its own data a step (``RandomState(100 + rank)``) through
``Trainer(kvstore=kv)``, dividing by the global batch; rank 0 prints the
losses. It runs on the card unless ``--cpu``.

``--model resnet50_v1`` trains BASELINE config #3 instead: ResNet-50 v1 as
``tools/train_resnet.py:build_resnet_train`` builds it (NHWC,
space-to-depth stem, bf16 weights with f32 masters, SGD momentum 0.9, lr
0.1, wd 1e-4) at ``--batch`` images a rank (rank r's from data seed
``1 + r``) with ``kvstore='tpu_dist'``, ``--steps`` steps; ``--narrow``
puts a narrow ResNet v1 of the same layout (one bottleneck a stage, 10
classes, 64x64 images) in its place, for tests.

``--compress`` pushes two rounds of a (6, 5) gradient per rank
(``RandomState(100 + rank)``, uniform in +-1.2) through ``pushpull`` with
2-bit compression at threshold 0.5 and keeps what each round pulled.

With ``--out DIR`` each rank writes what it ended with there: ``rank<r>.json``
(losses, the example's mean loss over the batches it saw before and after
training, step ms, the gradient list's bucketed sum alone, the wall-clock times at which ``main`` began, the rank
joined the job and it finished, the store's backend, its ``collective_*`` totals, the
kernels' launches over the steps) and ``params_rank<r>.pt`` (the trainable
parameters and the optimizer's state leaves, on the CPU), or
``kv_rank<r>.pt`` in the compressed mode.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as onp
import torch

__all__ = ["main", "trained_state", "resnet_kwargs"]


def _collective_totals():
    """``{op: {"calls", "bytes", "seconds"}}`` of the collective_* series."""
    from ..telemetry import instruments as ti

    out = {}
    for metric, key in ((ti.collective_total, "calls"),
                         (ti.collective_bytes_total, "bytes"),
                         (ti.collective_seconds_total, "seconds")):
        for labels, child in metric.series():
            out.setdefault(labels[0], {})[key] = child.value
    return out


def trained_state(net, trainer):
    """``{name: CPU tensor}``: the net's trainable parameters, and the
    trainer's state leaves as ``state<i>.<j>``."""
    from ..kernels.opt import _leaves

    out = {k: p._tensor().detach().cpu().clone()
           for k, p in net.collect_params().items() if p.grad_req != "null"}
    for i, st in enumerate(trainer._states):
        for j, leaf in enumerate(_leaves(st)):
            out[f"state{i}.{j}"] = leaf.detach().cpu().clone()
    return out


def resnet_kwargs(narrow=False):
    """``build_resnet_train``'s model arguments: ResNet-50 v1 at full
    width, or the narrow net of ``--narrow``."""
    if not narrow:
        return {}
    from ..gluon.model_zoo import vision

    return dict(image=64, classes=10, model=vision.ResNetV1(
        vision.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128], classes=10,
        layout="NHWC", stem_s2d=True))


def _counts():
    from ..kernels import build

    return {k: build.COUNTERS[k].value
            for k in ("bn_train_fwd", "bn_train_bwd", "opt_ladder")}


def example(kv, device, steps, batch):
    """The example's MLP; returns ``(net, trainer, losses)``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    mx.seed(0)
    rank, nworkers = kv.rank, kv.num_workers
    with device:
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(10))
        net.initialize()
        net(mx.np.zeros((1, 20)))  # the deferred shapes
        # every rank starts from rank 0's parameters
        for i, p in enumerate(net.collect_params().values()):
            kv.broadcast(i, p.data(), out=p.data())
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore=kv)
        lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
        rs = onp.random.RandomState(100 + rank)  # this rank's shard
        batches = [(mx.np.array(rs.rand(batch, 20).astype("f")),
                    mx.np.array(rs.randint(0, 10, (batch,))))
                   for _ in range(steps)]

        def seen_loss():
            return float(sum(lossfn(net(x), y).mean() for x, y in batches)
                         / steps)

        before = seen_loss()
        losses = []
        for step, (x, y) in enumerate(batches):
            with autograd.record():
                loss = lossfn(net(x), y)
            loss.backward()
            trainer.step(batch * nworkers)
            losses.append(float(loss.mean()))
            if rank == 0:
                print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
        seen = dict(before=before, after=seen_loss())
    return net, trainer, losses, seen


def resnet(kv, device, steps, batch, narrow=False):
    """Config #3 on this rank; returns ``(net, trainer, losses, step_ms,
    launches, allreduce_ms)``: the last, three times the store's bucketed
    sum of the gradient list alone, each after a barrier (the transfer
    without the wait for the other ranks)."""
    from ..kernels import build
    from . import train_resnet

    net, trainer, step = train_resnet.build_resnet_train(
        batch=batch, device=device, kvstore=kv, data_seed=1 + kv.rank,
        **resnet_kwargs(narrow))
    losses, step_ms = [], []
    build.reset_counters()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step().mean()))   # a host read ends the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _counts()
    grads = [p.grad() for p in trainer._params if p.grad_req != "null"]
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    allreduce_ms = []
    for _ in range(3):
        kv.barrier()
        sync()
        t0 = time.perf_counter()
        kv.allreduce_flat(grads)
        sync()
        allreduce_ms.append((time.perf_counter() - t0) * 1e3)
    return net, trainer, losses, step_ms, launches, allreduce_ms


def compressed(kv, device):
    """Two 2-bit rounds of pushpull; ``(round1, round2)`` pulled."""
    import mxnet_tpu_torch as mx

    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    rs = onp.random.RandomState(100 + kv.rank)
    g1 = rs.uniform(-1.2, 1.2, (6, 5)).astype("f")
    g2 = rs.uniform(-1.2, 1.2, (6, 5)).astype("f")
    pulled = []
    with device:
        out = mx.nd.zeros((6, 5))
        for g in (g1, g2):
            kv.pushpull("w", mx.nd.array(g), out=out)
            pulled.append(out._data.cpu().clone())
    return pulled


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--model", default="mlp", choices=["mlp", "resnet50_v1"])
    p.add_argument("--compress", action="store_true")
    p.add_argument("--narrow", action="store_true",
                   help="resnet50_v1: a narrow ResNet v1 in its place")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="rows a rank a step (32; resnet50_v1: 128)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    main_at = time.time()
    import mxnet_tpu_torch as mx

    # join the job first: the process group decides this rank's card
    kv = mx.kvstore.create("tpu_dist")
    device = mx.cpu() if args.cpu else mx.gpu(torch.cuda.current_device())
    rank, nworkers = kv.rank, kv.num_workers
    print(f"[rank {rank}] joined job of {nworkers}, backend {kv.backend}",
          flush=True)
    record = dict(rank=rank, workers=nworkers, backend=kv.backend,
                  device=str(device),
                  wall=dict(main=main_at, joined=time.time()))
    if args.compress:
        r1, r2 = compressed(kv, device)
        if args.out:
            torch.save({"round1": r1, "round2": r2, "nw": nworkers},
                       os.path.join(args.out, f"kv_rank{rank}.pt"))
    else:
        if args.model == "mlp":
            net, trainer, losses, seen = example(kv, device,
                                                 args.steps or 5,
                                                 args.batch or 32)
            record.update(seen_loss=seen)
        else:
            net, trainer, losses, step_ms, launches, allreduce_ms = resnet(
                kv, device, args.steps or 3, args.batch or 128, args.narrow)
            record.update(step_ms=step_ms, launches=launches,
                          allreduce_ms=allreduce_ms, bn_layers=sum(
                isinstance(b, mx.gluon.nn.BatchNorm) for b in net.modules()))
        record.update(losses=losses, collectives=_collective_totals())
        if args.out:
            torch.save(trained_state(net, trainer),
                       os.path.join(args.out, f"params_rank{rank}.pt"))
    record["wall"]["done"] = time.time()
    if args.out:
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    kv.barrier()
    print(f"[rank {rank}] done", flush=True)


if __name__ == "__main__":
    main()
