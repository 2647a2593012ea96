"""Where a training step spends its time on the card.

    python -m mxnet_tpu_torch.tools.profile_training
        [--model bert|resnet50|lenet] [--batch N] [--iters 5]
        [--plain-ladder] [--train-step]

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
``torch.profiler`` (with CUDA events where it records no device activity:
``device_time_from``). Prints one JSON object: host ms per step (and the ms
the host takes to issue it, before it waits for the card), device-busy ms
per step (the union of kernel intervals), the device's idle share, launches
per step, the share of the port's kernels, of the library GEMMs and
convolutions and of everything else, and the kernels that take the most
device time. ``--plain-ladder`` measures, for comparison, the same step
with the optimizer's plain versions (``bucket_step_reference`` and
``bucket_sqnorm_reference`` put in ``bucket_step``'s and
``bucket_sqnorm``'s places, ``_fused_param_step`` in ``param_step``'s:
the port itself has no such switch).

``--train-step`` runs each step through ``gluon.TrainStep`` (BERT without
the global-norm clip, which TrainStep runs phased) and measures its two
paths on the same net in turns, phased, graph, graph, phased (the phased
turns with ``MXTPU_WHOLE_STEP=0``): one JSON object with a ``runs`` list,
each run as above plus the calls the host issued a step (graph launches,
copies, kernel launches: the profiler's CUDA runtime events) beside the
kernels the device ran. Needs a CUDA card; exits non-zero without.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

from ..kernels import build
from ..kernels import opt as kopt
from ..optimizer.optimizer import Optimizer
from .finetune import build_bert_finetune
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


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _group(name):
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other PyTorch kernels"


#: the CUDA runtime calls of the host that put work on the card
_HOST_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
               "cudaMemsetAsync")


#: clock64 ticks a second assumed for the spin kernel of :func:`queued_ms`
#: (the H100 SXM's top SM clock: at a lower clock it only spins longer)
_SPIN_HZ = 1.98e9


def queued_ms(fns, iters):
    """Device ms of each of ``iters`` calls of ``fns`` (called in turn),
    from a CUDA-event pair around each call, for where the profiler records
    no device activity. The calls are queued behind a spin kernel that
    holds the card for twice as long as the host took to issue them
    before, so the host's time between launches is not in a call's time;
    the card's own gaps between one kernel and the next are. A call that
    synchronises inside, or more launches than the card's queue holds,
    brings host time back in: the time is then an upper bound."""
    fns = list(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(min(2 * issue_s + 1e-3, 2.0) * _SPIN_HZ))
    for i, (a, b) in enumerate(events):
        a.record()
        fns[i % len(fns)]()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def measure(step, iters):
    """Host ms, device-busy ms, idle share, launches and kernel groups of
    ``iters`` steps of ``step`` (warmed up by the caller), as a dict.
    ``device_time_from`` says how the device's time was taken: "profiler"
    (the union of the kernels' intervals), or, where the profiler recorded
    no device activity in 3 windows, "cuda_events" (:func:`queued_ms`
    around each step: the span from its first kernel's start to its last
    one's end, gaps included, so an upper bound of busy; kernels and host
    calls are then not counted)."""
    torch.cuda.synchronize()
    host, issue = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        issue.append(time.perf_counter() - t0)   # the host's own work
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    n = iters
    p50 = sorted(host)[len(host) // 2]
    head = {
        "host_ms_per_step": [1e3 * h for h in host],
        "host_ms_per_step_p50": 1e3 * p50,
        "issue_ms_per_step_p50": 1e3 * sorted(issue)[len(issue) // 2],
    }

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler now and then returns a window without its device
    # events: that window is taken again, twice at most
    for _ in range(3):
        build.reset_counters()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    else:
        print("profile_training: the profiler recorded no device activity "
              "in 3 windows; device time from CUDA events", file=sys.stderr,
              flush=True)
        build.reset_counters()
        span = sum(queued_ms([step], iters))
        return dict(
            head, device_time_from="cuda_events",
            device_busy_ms_per_step=span / n,
            device_idle_share=1.0 - span / (1e3 * sum(host)),
            kernel_launches_per_step=None, host_calls_per_step=None,
            # queued_ms takes the steps twice: once to time the issue
            port_kernel_launches_per_step={
                c.name: c.value / (2 * n) for c in build.COUNTERS.values()},
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
            groups=[], top_kernels_ms_per_step=[]), p50
    calls = collections.Counter(
        e.name for e in events
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.name in _HOST_CALLS)
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
    return {
        **head,
        "device_time_from": "profiler",
        "profiled_window_ms_per_step": window_us / 1e3 / n,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share": 1.0 - busy / window_us,
        "kernel_launches_per_step": len(kernels) / n,
        "host_calls_per_step": {k: v / n for k, v in sorted(calls.items())},
        "port_kernel_launches_per_step": {
            c.name: c.value / n for c in build.COUNTERS.values()},
        # allocated: live tensors (a graph's activations live in its
        # private pool, which only the reserved peak shows)
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
        "groups": [
            {"group": g, "ms_per_step": t / 1e3 / n, "share": t / total,
             "launches_per_step": n_by_group[g] / n}
            for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])],
        "top_kernels_ms_per_step": [
            {"name": nm[:90], "ms": t / 1e3 / n, "share": t / total}
            for nm, t in top],
    }, p50


def _build(model, batch, seq, dev, train_step):
    if model == "bert":
        kw = dict(clip_global_norm=None) if train_step else {}
        _, _, step = build_bert_finetune(batch=batch, seq=seq, device=dev,
                                         train_step=train_step, **kw)
    elif model == "resnet50":
        _, _, step = build_resnet_train(batch=batch, device=dev,
                                        train_step=train_step)
    else:
        _, _, step, _ = build_lenet_train(batch=batch, device=dev,
                                          train_step=train_step)
    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("bert", "resnet50", "lenet"),
                    default="bert")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 8 (bert), 256 (resnet50, lenet)")
    ap.add_argument("--seq", type=int, default=384, help="bert only")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--plain-ladder", action="store_true")
    ap.add_argument("--train-step", action="store_true")
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
    args.batch = args.batch or (8 if args.model == "bert" else 256)
    step = _build(args.model, args.batch, args.seq, dev, args.train_step)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    head = {
        "card": card, "model": args.model, "batch": args.batch,
        "seq": args.seq if args.model == "bert" else None,
        "iters": args.iters,
        "ladder": "plain" if args.plain_ladder else "kernel"}
    if not args.train_step:
        for _ in range(3):
            step()
        run, p50 = measure(step, args.iters)
        print(json.dumps(dict(head, samples_per_s=args.batch / p50, **run),
                         indent=1))
        return
    # phased, graph, graph, phased on one net: the phased turns run the
    # same TrainStep with MXTPU_WHOLE_STEP=0
    ts = step.func
    runs = []
    for path in ("phased", "whole_step", "whole_step", "phased"):
        os.environ["MXTPU_WHOLE_STEP"] = "1" if path == "whole_step" else "0"
        try:
            for _ in range(3):       # graph: warm-up, capture, replay
                step()
            torch.cuda.reset_peak_memory_stats()
            run, p50 = measure(step, args.iters)
        finally:
            os.environ.pop("MXTPU_WHOLE_STEP", None)
        if ts.last_path != path:
            sys.exit(f"TrainStep ran {ts.last_path}, not {path}: "
                     f"{ts.ineligible_reason()}")
        runs.append(dict(path=path, captures=ts.jit_trace_count(),
                         samples_per_s=args.batch / p50, **run))
    print(json.dumps(dict(head, train_step=True, runs=runs), indent=1))


if __name__ == "__main__":
    main()
