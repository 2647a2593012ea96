"""Typed environment-variable registry (a copy of mxnet_tpu/env.py's
mechanism, holding only the entries the port reads).

Every knob the port reads from the environment is declared here with type,
default and documentation; ``doc()`` renders them.
"""
from __future__ import annotations

import os

__all__ = ["EnvVar", "register", "get", "doc"]

_REGISTRY = {}


class EnvVar:
    def __init__(self, name, type_, default, help_, aliases=()):
        self.name = name
        self.type = type_
        self.default = default
        self.help = help_
        self.aliases = tuple(aliases)

    def read(self):
        for n in (self.name, *self.aliases):
            raw = os.environ.get(n)
            if raw is not None:
                if self.type is bool:
                    return raw.lower() not in ("", "0", "false", "off")
                return self.type(raw)
        return self.default


def register(name, type_, default, help_, aliases=()):
    v = EnvVar(name, type_, default, help_, aliases)
    _REGISTRY[name] = v
    return v


def get(name):
    """Read an env var through its registry entry (typed, with default)."""
    return _REGISTRY[name].read()


def doc():
    """Render the env-var documentation."""
    lines = ["# Environment variables", ""]
    for v in sorted(_REGISTRY.values(), key=lambda v: v.name):
        alias = f" (aliases: {', '.join(v.aliases)})" if v.aliases else ""
        lines.append(f"* `{v.name}`{alias} — {v.help} "
                     f"(type: {v.type.__name__}, default: {v.default!r})")
    return "\n".join(lines)


register(
    "MXTPU_FLASH_ATTENTION", bool, True,
    "Use the flash-attention kernel inside MultiHeadAttention when no mask "
    "is passed (the CUDA kernel for CUDA tensors, its plain PyTorch version "
    "for CPU tensors); off takes the einsum path.")
register(
    "MXTPU_SERVE_MAX_BATCH", int, 32,
    "serving.InferenceEngine default max micro-batch size (top of the "
    "bucket ladder).")
register(
    "MXTPU_SERVE_QUEUE", int, 256,
    "serving.InferenceEngine default admission-queue bound; submits "
    "beyond it shed deterministically with serving.Overloaded.")
register(
    "MXTPU_SERVE_MAX_WAIT_MS", float, 2.0,
    "serving.InferenceEngine default batching deadline: a partial batch "
    "launches once its oldest request has waited this long.")
register(
    "MXTPU_SERVE_TIMEOUT_MS", float, 1000.0,
    "serving.InferenceEngine default per-request deadline; requests "
    "not completed in time fail with serving.RequestTimeout.")
register(
    "MXTPU_SERVE_MODE", str, "pipelined",
    "serving.InferenceEngine execution mode: 'pipelined' (assembler + "
    "completer threads, host assembly overlaps device compute) or "
    "'sync' (one thread: collect, dispatch, wait, settle).")
register(
    "MXTPU_SERVE_INFLIGHT", int, 2,
    "serving.InferenceEngine bounded in-flight window: how many "
    "dispatched-but-unsettled micro-batches the assembler may run "
    "ahead (2 = double buffering).")
register(
    "MXTPU_SERVE_DRAIN_MS", float, 10000.0,
    "serving.InferenceEngine.stop(drain=True) default drain bound; the "
    "drain also never outlives the latest queued deadline, and "
    "requests still queued at the bound are force-dropped.")
register(
    "MXTPU_BN_COMPUTE", str, "f32",
    "Element-wise dtype of the O(N*H*W*C) BatchNorm-training tensors "
    "(ops/nn.py:_bn_ew_dtype): 'f32' (default) or 'bf16', which keeps the "
    "elementwise chains in the activation's dtype and only the reductions' "
    "accumulators in f32. The BatchNorm kernels (kernels/norm.py) and "
    "their plain versions read the same setting.")
register(
    "MXTPU_WHOLE_STEP", bool, True,
    "gluon.TrainStep runs an eligible configuration as one step body: on "
    "the card one captured CUDA graph per batch signature, replayed each "
    "step; on the CPU the same body eagerly. Off runs every step phased "
    "(record -> backward -> Trainer.step).")
register(
    "MXTPU_TELEMETRY", bool, True,
    "Telemetry registry master switch (telemetry/registry.py): 0 turns "
    "every counter/gauge/histogram record into a single-branch no-op.")
register(
    "MXTPU_DIAGNOSTICS", bool, True,
    "Diagnostics span recording (diagnostics/spans.py): per-phase "
    "timing records feeding the step table. 0 makes every span a no-op "
    "context manager.")
register(
    "MXTPU_DIAG_RING_CAPACITY", int, 4096,
    "Diagnostics span-ring capacity: the per-process ring keeps the "
    "newest N span records for the step table.")
register(
    "MXTPU_TRACE_SAMPLE", float, 0.0,
    "Head-based request-trace sampling fraction for the serving tier "
    "(observability/reqtrace.py): 0 = off (the serving path does no extra "
    "work), 1 = every request, 0.1 = exactly every 10th (deterministic "
    "counter, no RNG). Sampled requests record telescoping phase spans "
    "(admit/queue/assemble/dispatch/device/slice/settle) into the trace "
    "ring.")
register(
    "MXTPU_TRACE_RING", int, 1024,
    "Bounded per-process ring of finished request traces "
    "(observability/reqtrace.py): the newest N are kept.")
register(
    "MXTPU_SLO_INTERACTIVE_MS", float, 0.0,
    "Latency objective (ms) for the 'interactive' serving class; 0 "
    "disables SLO tracking for the class. Any class gets an objective "
    "via MXTPU_SLO_<CLASS>_MS.")
register(
    "MXTPU_SLO_BATCH_MS", float, 0.0,
    "Latency objective (ms) for the 'batch' serving class; 0 disables "
    "SLO tracking for the class.")
register(
    "MXTPU_SLO_TARGET", float, 0.99,
    "SLO success-fraction target: the error budget is 1 - target, and "
    "the serve_slo_burn_rate gauge is the windowed violation fraction "
    "over that budget.")
register(
    "MXTPU_SLO_WINDOW_S", float, 60.0,
    "Rolling window (seconds) SLO burn rates are evaluated over; "
    "violations roll off after this long.")
register(
    "MXTPU_SLO_BURN_MAX", float, 1.0,
    "Burn-rate threshold: a class burning hotter than this is reported "
    "as burning (reqtrace.slo_burning; 1.0 = spending the error budget "
    "exactly as fast as the target allows).")
register(
    "MXTPU_SLO_MIN_EVENTS", int, 10,
    "Minimum windowed requests before a class's burn rate can count as "
    "burning — keeps one unlucky request from flagging an idle replica.")
register(
    "MXTPU_FUSED_BUCKET_MB", int, 25,
    "Target flat-buffer size (MB) for the bucketed allreduce "
    "(parallel.collectives.psum_tree_flat): leaves are concatenated into "
    "flat buffers of roughly this size, one collective per buffer.")
register(
    "MXTPU_FUSED_UPDATE", bool, True,
    "Trainer.allreduce_grads hands every gradient to the kvstore in ONE "
    "list-form pushpull, which tpu_dist reduces in flat buckets of "
    "MXTPU_FUSED_BUCKET_MB (one all_reduce a bucket across processes); 0 "
    "issues one pushpull a parameter in descending priority. The update's "
    "buckets are not affected: device, rule and dtype decide those.")
register(
    "MXNET_KVSTORE_BIGARRAY_BOUND", int, 1 << 20,
    "Element count above which kvstore='p3' reduces a value of several "
    "copies in chunks of this many, each summed across processes on its "
    "own (P3 slicing, p3store_dist.h).")
register(
    "MXTPU_DEVICE_PREFETCH", int, 0,
    "Default DataLoader device_prefetch depth: keep up to N batches ahead "
    "of the consumer already copied from pinned host memory to the card "
    "on a side CUDA stream, so the next batch's host->device copy "
    "overlaps the current step's compute. 0 disables; the "
    "DataLoader(device_prefetch=...) argument overrides per loader.")
register(
    "MXTPU_MP_START", str, "",
    "DataLoader multiprocessing start method override: fork | spawn | "
    "forkserver. Default: fork from a parent without other Python "
    "threads, else spawn.")
register(
    "MXTPU_CKPT_ASYNC", bool, True,
    "CheckpointManager default: write and commit checkpoints on an IO "
    "thread so saves overlap training (the snapshot's host copies are "
    "still taken inline). 0 makes every save synchronous.")
register(
    "MXTPU_CKPT_KEEP_LAST", int, 5,
    "CheckpointManager retention: keep the newest N committed "
    "checkpoints, deleting older ones at each commit. 0 disables "
    "deletion.")
register(
    "MXTPU_CKPT_KEEP_EVERY_N", int, 0,
    "CheckpointManager retention: checkpoints whose step is a multiple "
    "of N are milestones kept forever, exempt from KEEP_LAST deletion. "
    "0 disables milestones.")
register(
    "MXTPU_CKPT_VERIFY", bool, True,
    "Verify per-array crc32 checksums against the manifest on restore; "
    "mismatches raise CheckpointCorrupt (latest-checkpoint restores "
    "then fall back to the previous committed step).")
register(
    "MXTPU_CKPT_MODE", str, "replicated",
    "Distributed checkpoint layout: 'replicated' (rank 0 writes the "
    "full state, others barrier) or 'sharded' (each rank persists its "
    "share plus a fragment manifest; rank 0 merges).")
register(
    "MXTPU_CKPT_PREEMPT_SIGNALS", str, "SIGTERM,SIGUSR1",
    "Comma-separated signals the PreemptionHandler intercepts for the "
    "emergency synchronous snapshot.")
register(
    "MXTPU_CKPT_PREEMPT_EXIT_CODE", int, 0,
    "Process exit code after a successful preemption snapshot (0 = "
    "clean shutdown so supervisors treat the job as resumable, not "
    "crashed).")
register(
    "MXTPU_CKPT_DIR", str, "",
    "Default checkpoint directory for tools when none is passed "
    "explicitly; empty = require an explicit directory.")
register(
    "MXTPU_MESH", str, "",
    "Mesh axis spec for the sharding subsystem (mxnet_tpu_torch/sharding), "
    "e.g. 'dp=-1' (data parallel over every card) or 'dp=4,tp=2'. -1 "
    "infers that axis from the card count. Consulted only when "
    "MXTPU_SHARDING=auto and the Trainer was given no explicit "
    "mesh=/sharding_plan=; empty (default) names no mesh.")
register(
    "MXTPU_SHARDING", str, "auto",
    "Sharding-subsystem mode: 'off' disables it (mesh= arguments and "
    "MXTPU_MESH are ignored, nothing is placed); 'auto' (default) builds "
    "a plan from explicit Trainer arguments, else from MXTPU_MESH; 'plan' "
    "accepts explicit arguments only.")
register(
    "MXTPU_SPEC_LAYOUT", bool, True,
    "SpecLayout rule library for env-driven plans (sharding/layouts.py): "
    "when MXTPU_MESH names the layout's model axes (fsdp/tp), the plan "
    "places stock-block parameters by structural role. 0 keeps env meshes "
    "placement-free (axes only, parameters replicate).")
register(
    "MXTPU_ZERO", bool, True,
    "ZeRO optimizer-state sharding: when the plan's mesh carries the "
    "layout's fsdp axis, optimizer state (momenta, variances, f32 masters) "
    "shards along it on the first unsharded divisible dim, so each "
    "position holds ~1/N of it. 0 places state exactly like its weight. "
    "The numbers are the same either way.")
register(
    "MXTPU_ELASTIC_MAX_RESTARTS", int, 3,
    "Restart budget of elastic.RestartPolicy: the lifetime cap on restarts "
    "after rank deaths before the supervisor gives up. -1 = unlimited.")
register(
    "MXTPU_ELASTIC_BACKOFF_S", float, 1.0,
    "Restart backoff base (seconds): restart N after a rank death waits "
    "base * 2^N, capped at MXTPU_ELASTIC_BACKOFF_MAX_S.")
register(
    "MXTPU_ELASTIC_BACKOFF_MAX_S", float, 30.0,
    "Cap on the exponential restart backoff (seconds).")
register(
    "MXTPU_ELASTIC_LR_RESCALE", str, "off",
    "LR rescaling rule when the world size changes at elastic re-entry "
    "(elastic.rescale_lr): 'off' (default), 'linear' (lr *= new/old) or "
    "'sqrt' (lr *= sqrt(new/old)). Scheduled LRs are never touched.")
register(
    "MXTPU_ELASTIC_GENERATION", int, 0,
    "World generation a relaunched rank inherits: 0 = first launch, +1 "
    "per restart or in-process reenter(); read by "
    "elastic.current_generation and the world_generation gauge.")
