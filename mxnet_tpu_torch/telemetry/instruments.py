"""The serving, collective, input-pipeline and checkpoint subsets of the
metric catalog and the record_* helpers their hot paths call (a copy of
mxnet_tpu/telemetry/instruments.py: the ``serve_*`` instruments, the
``collective_*`` ones with ``fused_bucket_size``, ``transfer_*``,
``data_prefetch_*``, ``ckpt_*``, the sharding plan's and the elastic
re-entry's, and their helpers; the others wait for the modules that record
them).

Every serving touchpoint goes through ONE helper here, so the catalog below
is the single source of metric names, labels, and buckets, call sites stay
one line, and the disabled path is a single ``REGISTRY.enabled`` check
before any lock, float math, or label resolution. The JAX package's helpers
also mirror failures into its flight recorder, which the port does not
have yet.

Metric names follow Prometheus conventions (`_total` counters, `_seconds`
base units), unprefixed — one process, one framework.
"""
from __future__ import annotations

from .registry import REGISTRY, counter, gauge, histogram

__all__ = [
    "serve_request_total", "serve_request_latency_seconds",
    "serve_queue_depth", "serve_in_flight",
    "serve_batch_total", "serve_batch_size", "serve_padded_rows_total",
    "serve_shed_total", "serve_timeout_total",
    "serve_dispatch_total", "serve_inflight_batches",
    "serve_class_queue_depth", "serve_class_shed_total",
    "serve_drain_dropped_total",
    "serve_trace_total", "serve_slo_burn_rate",
    "serve_slo_violation_total",
    "record_serve_request", "record_serve_batch", "record_serve_trace",
    "set_slo_burn", "record_slo_violation",
    "collective_total", "collective_bytes_total", "collective_seconds_total",
    "fused_bucket_size", "record_collective", "record_fused_bucket",
    "transfer_total", "transfer_bytes_total", "record_transfer",
    "data_prefetch_total", "data_prefetch_depth", "record_device_prefetch",
    "ckpt_save_total", "ckpt_save_ms", "ckpt_bytes_total",
    "ckpt_restore_total", "record_ckpt_save", "record_ckpt_restore",
    "sharding_plan_applied_total", "sharding_mesh_axis_size",
    "record_sharding_apply",
    "elastic_restart_total", "reshard_ms", "world_generation",
    "record_elastic_restart", "record_reshard", "set_world_generation",
]

_SERVE_LATENCY_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1,
                          .25, .5, 1.0, 2.5, 5.0, 10.0)
_SERVE_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
_FUSED_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
_CKPT_MS_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                    1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


# -- serving (serving/engine.py) ---------------------------------------------
serve_request_total = counter(
    "serve_request_total",
    "Serving requests by final outcome (ok / shed / timeout / error)",
    ["model", "outcome"])
serve_request_latency_seconds = histogram(
    "serve_request_latency_seconds",
    "End-to-end request latency: submit -> result ready (queue wait + "
    "batch assembly + compiled forward); p50/p99 derive from the buckets",
    ["model"], buckets=_SERVE_LATENCY_BUCKETS)
serve_queue_depth = gauge(
    "serve_queue_depth",
    "Requests waiting in the admission queue right now", ["model"])
serve_in_flight = gauge(
    "serve_in_flight",
    "Requests inside the batch currently executing", ["model"])
serve_batch_total = counter(
    "serve_batch_total", "Micro-batches executed", ["model"])
serve_batch_size = histogram(
    "serve_batch_size",
    "Real rows per executed micro-batch, BEFORE padding to the bucket "
    "(bucket fill)", ["model"], buckets=_SERVE_BATCH_BUCKETS)
serve_padded_rows_total = counter(
    "serve_padded_rows_total",
    "Padding rows added to round batches up to their compile bucket",
    ["model"])
serve_shed_total = counter(
    "serve_shed_total",
    "Requests rejected at admission — queue bound exceeded -> Overloaded",
    ["model"])
serve_timeout_total = counter(
    "serve_timeout_total",
    "Requests that hit their deadline before a result was ready",
    ["model"])
serve_dispatch_total = counter(
    "serve_dispatch_total",
    "Micro-batches dispatched to the device (the pipelined engine "
    "dispatches ahead of completion, so this leads serve_batch_total "
    "by the in-flight window)", ["model"])
serve_inflight_batches = gauge(
    "serve_inflight_batches",
    "Dispatched-but-unsettled micro-batches right now (pipeline window "
    "fill; >1 means host assembly is overlapping device compute)",
    ["model"])
serve_class_queue_depth = gauge(
    "serve_class_queue_depth",
    "Requests queued per priority class (serving/scheduler.py "
    "strict-priority dequeue)", ["model", "cls"])
serve_class_shed_total = counter(
    "serve_class_shed_total",
    "Requests shed at admission per priority class, by reason: 'queue' "
    "(shared bound hit -> Overloaded) or 'rate' (class token bucket "
    "empty -> RateLimited)", ["model", "cls", "reason"])
serve_drain_dropped_total = counter(
    "serve_drain_dropped_total",
    "Requests force-dropped unserved because stop(drain=True) hit its "
    "bounded drain deadline (or the engine was never started)",
    ["model"])
serve_trace_total = counter(
    "serve_trace_total",
    "Sampled request traces frozen into the reqtrace ring, by terminal "
    "outcome (ok / shed / timeout / error); at MXTPU_TRACE_SAMPLE=0 "
    "this never moves (observability/reqtrace.py)",
    ["model", "outcome"])
serve_slo_burn_rate = gauge(
    "serve_slo_burn_rate",
    "Per-class SLO burn rate over the rolling MXTPU_SLO_WINDOW_S "
    "window: windowed bad fraction / error budget (1 - "
    "MXTPU_SLO_TARGET). 1.0 = burning budget exactly as fast as "
    "allowed; above MXTPU_SLO_BURN_MAX the replica drops from /readyz "
    "rotation", ["model", "cls"])
serve_slo_violation_total = counter(
    "serve_slo_violation_total",
    "Requests that violated their class SLO, by kind: 'latency' "
    "(served but over the objective), 'shed', 'timeout', or 'error'",
    ["model", "cls", "kind"])

# -- collectives (parallel/collectives.py) -----------------------------------
collective_total = counter(
    "collective_total", "Collective dispatches by op (kvstore pushpull/"
    "broadcast, parallel.collectives psum/all_gather/...)", ["op"])
collective_bytes_total = counter(
    "collective_bytes_total", "Input bytes handed to each collective",
    ["op"])
collective_seconds_total = counter(
    "collective_seconds_total",
    "Host wall time in collective dispatch (async: excludes on-device "
    "completion unless the call itself syncs)", ["op"])
fused_bucket_size = histogram(
    "fused_bucket_size",
    "Parameters packed into each fused dispatch bucket, by site "
    "(update = fused optimizer step, allreduce = flat-buffer collective)",
    ["site"], buckets=_FUSED_BUCKETS)

# -- host<->device transfers and the input pipeline (gluon/data) -------------
transfer_total = counter(
    "transfer_total", "Explicit array transfers by direction "
    "(h2d: the DataLoader's device-prefetch copies)", ["direction"])
transfer_bytes_total = counter(
    "transfer_bytes_total", "Bytes moved by explicit array transfers",
    ["direction"])
data_prefetch_total = counter(
    "data_prefetch_total",
    "Batches pushed through the DataLoader device-prefetch stage "
    "(host->device copy issued on a side stream ahead of the consuming "
    "step)")
data_prefetch_depth = gauge(
    "data_prefetch_depth",
    "Batches currently resident in the DataLoader device-prefetch "
    "buffer (transferred or in flight, not yet consumed)")


# -- checkpointing (checkpoint/manager.py) -----------------------------------
ckpt_save_total = counter(
    "ckpt_save_total",
    "Checkpoint saves by mode (replicated / sharded) and outcome "
    "(ok / error)", ["mode", "outcome"])
ckpt_save_ms = histogram(
    "ckpt_save_ms",
    "Checkpoint save wall time in ms: snapshot capture through commit "
    "rename (async saves: measured on the IO thread at commit, so this "
    "is total latency, NOT time the training loop was blocked)",
    buckets=_CKPT_MS_BUCKETS)
ckpt_bytes_total = counter(
    "ckpt_bytes_total",
    "Bytes of training state committed to checkpoints (this rank's "
    "share in sharded mode)")
ckpt_restore_total = counter(
    "ckpt_restore_total",
    "Checkpoint restore attempts by outcome (ok / corrupt / not_found / "
    "error)", ["outcome"])


# -- sharding plans (sharding/plan.py) ---------------------------------------
sharding_plan_applied_total = counter(
    "sharding_plan_applied_total",
    "ShardingPlan.apply placements: every param laid out a block a "
    "position of the plan's mesh (once per trainer, counted again after a "
    "restore or a re-entry places arrays)", ["label"])
sharding_mesh_axis_size = gauge(
    "sharding_mesh_axis_size",
    "Resolved size of each mesh axis of the most recently applied plan "
    "(-1 specs shown after inference)", ["axis"])


# -- elastic training (elastic/) ---------------------------------------------
elastic_restart_total = counter(
    "elastic_restart_total",
    "Elastic topology-change events by origin: 'supervisor' (a relaunch "
    "after a rank death) or 'reenter' (a live trainer swapped plans "
    "in-process via elastic.reenter())", ["reason"])
reshard_ms = histogram(
    "reshard_ms",
    "Wall ms of one plan-crossing state move, by site: 'restore' "
    "(CheckpointManager placing a checkpoint's arrays under another "
    "plan), 'offline' (elastic.reshard_checkpoint rewriting a checkpoint "
    "for a target mesh), 'reenter' (the in-process plan swap)", ["site"],
    buckets=_CKPT_MS_BUCKETS)
world_generation = gauge(
    "world_generation",
    "Which incarnation of the elastic job this process runs: 0 at first "
    "launch, +1 per restart or in-process reenter()")


# -- helpers ----------------------------------------------------------------

def record_serve_request(model, outcome, seconds=None):
    """One finished serving request. `outcome` is ok / shed / timeout /
    error; `seconds` (when the request made it far enough to have a
    latency) lands in the latency histogram. Shed and timeout also bump
    their dedicated counters so overload is visible at a glance."""
    if not REGISTRY.enabled:
        return
    serve_request_total.labels(model, outcome).inc()
    if outcome == "shed":
        serve_shed_total.labels(model).inc()
    elif outcome == "timeout":
        serve_timeout_total.labels(model).inc()
    if seconds is not None:
        serve_request_latency_seconds.labels(model).observe(seconds)


def record_serve_trace(model, outcome):
    """One sampled request trace frozen into the reqtrace ring."""
    if not REGISTRY.enabled:
        return
    serve_trace_total.labels(model, outcome).inc()


def set_slo_burn(model, cls, burn):
    """Publish a class's fresh SLO burn rate (reqtrace.slo_observe and
    every slo_status read keep this live)."""
    if not REGISTRY.enabled:
        return
    serve_slo_burn_rate.labels(model, cls).set(float(burn))


def record_slo_violation(model, cls, kind):
    """One request that blew its class objective, by violation kind."""
    if not REGISTRY.enabled:
        return
    serve_slo_violation_total.labels(model, cls, kind).inc()


def record_serve_batch(model, rows, bucket):
    """One executed micro-batch: `rows` real rows padded up to `bucket`."""
    if not REGISTRY.enabled:
        return
    serve_batch_total.labels(model).inc()
    serve_batch_size.labels(model).observe(rows)
    if bucket > rows:
        serve_padded_rows_total.labels(model).inc(bucket - rows)


def record_collective(op, nbytes, seconds):
    """One collective dispatched: its op, input bytes and host seconds."""
    if not REGISTRY.enabled:
        return
    collective_total.labels(op).inc()
    collective_bytes_total.labels(op).inc(nbytes)
    collective_seconds_total.labels(op).inc(seconds)


def record_fused_bucket(site, params):
    """One fused bucket dispatched at `site` holding `params` parameters."""
    if not REGISTRY.enabled:
        return
    fused_bucket_size.labels(site).observe(params)


def record_transfer(direction, nbytes):
    """One explicit transfer of ``nbytes`` in ``direction`` (h2d, d2h)."""
    if not REGISTRY.enabled:
        return
    transfer_total.labels(direction).inc()
    transfer_bytes_total.labels(direction).inc(nbytes)


def record_device_prefetch(depth):
    """One batch entered the DataLoader device-prefetch buffer, which now
    holds ``depth`` batches ahead of the consumer."""
    if not REGISTRY.enabled:
        return
    data_prefetch_total.inc()
    data_prefetch_depth.set(depth)


def record_ckpt_save(mode, ms, nbytes, outcome="ok"):
    """One finished checkpoint save: `ms` capture->commit wall ms,
    `nbytes` of committed array payload (this rank's share). The JAX
    package also writes it into its flight record, which the port does not
    have yet (ROADMAP.md queue 1 item 11)."""
    if not REGISTRY.enabled:
        return
    ckpt_save_total.labels(mode, outcome).inc()
    if outcome == "ok":
        ckpt_save_ms.observe(ms)
        ckpt_bytes_total.inc(nbytes)


def record_ckpt_restore(outcome):
    """One restore attempt: ok / corrupt / not_found / error."""
    if not REGISTRY.enabled:
        return
    ckpt_restore_total.labels(outcome).inc()


def record_sharding_apply(label, axis_sizes, params=0):
    """One plan application: ``axis_sizes`` the resolved {axis: size},
    ``params`` the number of parameters placed. (The JAX package also
    mirrors it into its flight recorder, which the port does not have.)"""
    if not REGISTRY.enabled:
        return
    sharding_plan_applied_total.labels(label).inc()
    for axis, size in axis_sizes.items():
        sharding_mesh_axis_size.labels(str(axis)).set(int(size))


def record_elastic_restart(reason, generation=None):
    """One topology-change event; also pins the world_generation gauge
    when the new generation is known."""
    if not REGISTRY.enabled:
        return
    elastic_restart_total.labels(str(reason)).inc()
    if generation is not None:
        world_generation.set(int(generation))


def record_reshard(ms, saved_world=None, target_world=None,  # noqa: ARG001
                   site="restore"):
    """One plan-crossing state move of ``ms`` wall milliseconds (the
    worlds go to the JAX package's flight record, which the port lacks)."""
    if not REGISTRY.enabled:
        return
    reshard_ms.labels(str(site)).observe(float(ms))


def set_world_generation(g):
    """Pin the world_generation gauge (elastic.bump_generation)."""
    if not REGISTRY.enabled:
        return
    world_generation.set(int(g))
