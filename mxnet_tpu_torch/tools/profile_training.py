"""Where a training step spends its time on the card.

    python -m mxnet_tpu_torch.tools.profile_training
        [--model bert|resnet50|lenet] [--batch N] [--iters 5]
        [--plain-ladder]

``--model bert`` (the default) builds the fine-tune step of
tools/finetune.py (BERTForQA(bert_12_768_12), bf16 weights with f32
masters, seq 384, dropout 0.1, AdamW through the Trainer, batch 8);
``--model resnet50`` the step of tools/train_resnet.py (resnet50_v1 NHWC
with the space-to-depth stem, bf16 weights with f32 masters, 224x224, SGD
momentum through the Trainer, batch 256); ``--model lenet`` the imperative
LeNet-MNIST loop of tools/train_lenet.py (f32, ``mx.np`` arrays, SGD lr
0.05 through the Trainer, batch 256). All run on cuda:0 with seeded
weights, take a few steps to warm up, then time ``--iters`` steps with the
host clock (each ends in a synchronize) and profile the same number with
``torch.profiler``. Prints one JSON object: host ms per step, device-busy ms
per step (the union of kernel intervals), the device's idle share, launches
per step, the share of the port's kernels, of the library GEMMs and
convolutions and of everything else, and the kernels that take the most
device time. ``--plain-ladder`` measures, for comparison, the same step
with the optimizer's plain versions (``bucket_step_reference`` and
``bucket_sqnorm_reference`` put in ``bucket_step``'s and
``bucket_sqnorm``'s places, ``_fused_param_step`` in ``param_step``'s:
the port itself has no such switch). Needs a CUDA card; exits non-zero
without.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import torch

from ..kernels import build
from ..kernels import opt as kopt
from ..optimizer.optimizer import Optimizer
from .finetune import build_bert_finetune
from .profile_serving import _busy_us
from .train_lenet import build_lenet_train
from .train_resnet import build_resnet_train

#: device-kernel name fragments -> group
GROUPS = (
    ("flash_fwd_mma_kernel", "K4 flash_attention_fwd"),
    ("flash_bwd_dq_mma_kernel", "K5a flash_attention_bwd_dq"),
    ("flash_bwd_dkv_mma_kernel", "K5b flash_attention_bwd_dkv"),
    ("flash_fwd_kernel", "K4 flash_attention_fwd (fp32)"),
    ("flash_bwd_dq_kernel", "K5a flash_attention_bwd_dq (fp32)"),
    ("flash_bwd_dkv_kernel", "K5b flash_attention_bwd_dkv (fp32)"),
    ("opt_ladder_kernel", "K3 opt_ladder"),
    ("opt_sqnorm_", "K3 opt_sqnorm (global norm)"),
    ("bn_fwd_", "K1 bn_train_fwd"), ("bn_bwd_", "K2 bn_train_bwd"),
    ("fprop", "library convolutions"), ("dgrad", "library convolutions"),
    ("wgrad", "library convolutions"), ("conv", "library convolutions"),
    ("gemm", "library GEMMs"), ("nvjet", "library GEMMs"),
    ("cutlass", "library GEMMs"), ("xmma", "library GEMMs"),
    ("cublas", "library GEMMs"),
)


def _group(name):
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other PyTorch kernels"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("bert", "resnet50", "lenet"),
                    default="bert")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 8 (bert), 256 (resnet50, lenet)")
    ap.add_argument("--seq", type=int, default=384, help="bert only")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--plain-ladder", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_training needs a CUDA card")
    # float32 stays float32 in matmuls and convolutions, as chip_smoke.py
    # runs the same steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.plain_ladder:
        kopt.bucket_step = kopt.bucket_step_reference
        kopt.bucket_sqnorm = kopt.bucket_sqnorm_reference
        kopt.param_step = Optimizer._fused_param_step
    dev = torch.device("cuda", 0)
    if args.model == "bert":
        args.batch = args.batch or 8
        net, trainer, step = build_bert_finetune(batch=args.batch,
                                                 seq=args.seq, device=dev)
    elif args.model == "resnet50":
        args.batch = args.batch or 256
        net, trainer, step = build_resnet_train(batch=args.batch, device=dev)
    else:
        args.batch = args.batch or 256
        net, trainer, step, _ = build_lenet_train(batch=args.batch,
                                                  device=dev)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    host = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    build.reset_counters()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device activity")
    by_name = collections.defaultdict(float)
    by_group = collections.defaultdict(float)
    n_by_group = collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_group[_group(e.name)] += us
        n_by_group[_group(e.name)] += 1
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    n = args.iters
    print(json.dumps({
        "card": card, "model": args.model, "batch": args.batch,
        "seq": args.seq if args.model == "bert" else None, "iters": n,
        "ladder": "plain" if args.plain_ladder else "kernel",
        "trainable_parameters": len(net.trainable_param_names()),
        "host_ms_per_step_p50": 1e3 * sorted(host)[len(host) // 2],
        "samples_per_s": args.batch / sorted(host)[len(host) // 2],
        "profiled_window_ms_per_step": window_us / 1e3 / n,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share": 1.0 - busy / window_us,
        "kernel_launches_per_step": len(kernels) / n,
        "port_kernel_launches_per_step": {
            c.name: c.value / n for c in build.COUNTERS.values()},
        "groups": [
            {"group": g, "ms_per_step": t / 1e3 / n, "share": t / total,
             "launches_per_step": n_by_group[g] / n}
            for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])],
        "top_kernels_ms_per_step": [
            {"name": nm[:90], "ms": t / 1e3 / n, "share": t / total}
            for nm, t in top],
    }, indent=1))


if __name__ == "__main__":
    main()
