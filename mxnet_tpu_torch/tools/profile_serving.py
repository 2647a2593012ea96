"""Where a served BERT-base batch spends its time on the card: the captured
bucket rung against the eager forward of the same batch.

    python -m mxnet_tpu_torch.tools.profile_serving [--batch 8] [--iters 10]

Builds BERTForQA(bert_12_768_12, bf16, seq 384) on cuda:0 with seeded
weights, hybridizes it, and lets ``InferenceEngine.warmup`` (rungs up to
``--batch``) capture one CUDA graph per bucket rung. Then it measures one
full batch two ways on the same net, in turns, eager, graph, graph, eager:
the graph side is ``call_cached_graph``, the call the engine dispatches (the
rung's replay, its copies in and out); the eager side is the block's own
forward, called by this tool under ``torch.inference_mode()``. Each run is
``profile_training.measure`` over ``--iters`` batches: host ms per batch
(and the ms the host takes to issue it), device-busy ms (the union of
kernel intervals), the device's idle share, kernels the device ran and the
CUDA calls the host issued per batch (graph launches, copies, kernel
launches), and the kernels that take the most device time. Prints one JSON
object with the runs, whether a replay equals the eager forward bit for
bit, the captures, and each rung's graph pool. Needs a CUDA card; exits
non-zero without.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .. import autograd
from ..gluon.model_zoo import bert
from ..serving import InferenceEngine
from .profile_training import measure

SEQ = 384
#: what each run reports (profile_training.measure's keys; a step there is
#: one served batch here)
RUN_KEYS = ("host_ms_per_step", "host_ms_per_step_p50",
            "issue_ms_per_step_p50", "device_time_from",
            "device_busy_ms_per_step", "device_idle_share",
            "kernel_launches_per_step", "host_calls_per_step",
            "port_kernel_launches_per_step", "top_kernels_ms_per_step")


def bert_qa(dev, seed=0):
    """BERT-base QA in bf16 on ``dev``, its weights drawn from ``seed``,
    hybridized."""
    net = bert.BERTForQA(bert.bert_12_768_12(
        vocab_size=30522, max_length=512, dtype="bfloat16"))
    net.initialize(device=dev,
                   generator=torch.Generator().manual_seed(seed))
    net.hybridize()
    return net


def serving_net(dev, batch, name="bert_qa"):
    """:func:`bert_qa` from seed 0 with its rungs up to ``batch`` captured
    by the warmup of an engine named ``name``; returns the net, the warmed
    engine (not started) and warmup's summary."""
    net = bert_qa(dev)
    eng = InferenceEngine(net, name=name, max_batch_size=batch,
                          timeout_ms=0)
    example = torch.zeros((1, SEQ), dtype=torch.int32)
    return net, eng, eng.warmup(example, example)


def graph_against_eager(net, ids, seg, iters):
    """Runs of one batch through the captured rung and through the eager
    forward, in turns (eager, graph, graph, eager), as
    ``profile_training.measure`` gives them, and whether the replay's
    output equals the eager one bit for bit."""
    def graph():
        return net.call_cached_graph(ids, seg)

    def eager():
        with autograd.pause(), torch.inference_mode():
            return net(ids, seg)

    same = all(torch.equal(a, b) for a, b in zip(graph(), eager()))
    runs = []
    for label, fn in (("eager", eager), ("graph", graph), ("graph", graph),
                      ("eager", eager)):
        for _ in range(3):
            fn()
        run, _ = measure(fn, iters)
        runs.append(dict(path=label, **{k: run.get(k) for k in RUN_KEYS}))
    return runs, same


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_serving needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    net, _, info = serving_net(dev, args.batch)
    ids = torch.randint(0, 30522, (args.batch, SEQ),
                        generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32).to(dev)
    seg = torch.zeros_like(ids)
    captures = net.capture_count()
    runs, same = graph_against_eager(net, ids, seg, args.iters)
    if net.capture_count() != captures:
        sys.exit("the measured batch captured a graph again")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "batch": args.batch, "seq": SEQ, "iters": args.iters,
        "warmup": info, "captures": captures,
        "graph_pools_gib": {g["shapes"][0][0]: g["pool_bytes"] / 2 ** 30
                            for g in net.captured_graphs()},
        "replay_equals_eager_bitwise": same, "runs": runs,
    }, indent=1))


if __name__ == "__main__":
    main()
