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
