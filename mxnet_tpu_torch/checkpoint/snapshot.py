"""Capture / apply complete training state as flat host arrays + meta
(counterpart of mxnet_tpu/checkpoint/snapshot.py).

The snapshot is the serialization-agnostic middle layer: :func:`capture`
walks a Trainer and returns ``(arrays, meta)``, where ``arrays`` is a flat
name -> host array dict and ``meta`` a JSON-able dict that records how to
reassemble it; :func:`apply` is the exact inverse. manager.py owns files,
atomicity and retention; this module owns *what* training state means, with
the JAX package's array names (``param/{i}``, ``opt/{i}...``) and meta keys,
so a checkpoint of either package restores in the other:

  * the parameters, in the trainer's order and by its names;
  * the optimizer's per-parameter state trees (``(master_f32, inner)``
    under multi-precision), flattened leaf by leaf with a structure spec
    in meta;
  * the optimizer's bookkeeping (``num_update`` and each parameter's
    update count ``t``, which drive LR schedules and Adam's bias
    correction);
  * which parameters' gradients are stale, as indices (gradient versions
    are process-local), re-marked against the restoring process's;
  * the loss scale and an opaque JSON user-state blob;
  * the trainer's sharding plan as its manifest
    (``ShardingPlan.to_manifest``, the JAX package's record), for
    provenance and the restore's plan gate. The arrays themselves are
    logical: a placed parameter's value and a placed state leaf's blocks
    gathered (``Placed.full``), so the payload does not depend on the plan,
    and :func:`apply` writes it into the RESTORING trainer's placement
    (its plan, not the saved one), as the JAX package re-places it.

Host copies. A value is an array on the host: numpy, except a bf16 one,
which is a CPU bf16 tensor over the uint16 bits that
``_dtype_codec.to_numpy`` copies off the device (what the manifest names
``bfloat16`` and checksums, as the JAX package does its ``ml_dtypes``
array). Every copy is taken before :func:`capture` returns, after the card's
queued work (each card is synchronized first), so no later step or replay
of a captured ``gluon.TrainStep`` graph, which update weights, masters and
moments in place, can touch them.

Random state. The JAX package saves its one global key (``rng/key``), from
which its Dropout draws. The port has no such key: ``_random`` keeps a seed
and one generator per device, and each net that ``initialize`` set up
keeps its own noise generators (the Dropout layers' and each attention
layer's dropout-seed generator, gluon/block.py:initialize). The snapshot
stores their counterpart under names the JAX package does not read:

  * ``torch_rng/seed`` and ``torch_rng/device/<device>``: ``_random``'s
    seed and each device generator's ``get_state()``;
  * ``torch_rng/net{j}/{k}``: the k-th distinct noise generator
    (``_noise_generators()`` order) of each registered net holding
    trainer parameters, where j is the trainer index of the first of them.

:func:`apply` sets them **in place** (``set_state``): a captured graph
registered those very generators, so its next replay draws the masks an
uninterrupted run draws. A state saved on another device type than the
restoring generator's is not applied (the streams differ); a warning says
so. A JAX checkpoint's ``rng/key`` is read and left unused, and the JAX
package ignores the port's ``torch_rng/*`` arrays: the streams of the two
packages differ anyway (ROADMAP.md north star), so a cross-package resume
is exact in every value but its noise.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import _random
from .._dtype_codec import dtype_name, to_numpy
from ..parallel.mesh import Placed
from .errors import CheckpointError

__all__ = ["capture", "apply"]

# bump when the (arrays, meta) layout changes incompatibly
SNAPSHOT_VERSION = 1

#: array-name prefix of the port's random state (module note)
RNG_PREFIX = "torch_rng/"


def _host(t):
    """A host copy of tensor ``t`` (module note): numpy, or a CPU bf16
    tensor over the copied bits."""
    a, name = to_numpy(t)
    if name is None:
        return a
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _state_spec(state, prefix, out):
    """Flatten one optimizer-state tree: leaves land in ``out`` under
    generated keys; returns a JSON-able spec mirroring the structure:
    None | "key-string" | [child specs]."""
    if state is None:
        return None
    if isinstance(state, Placed):
        out[prefix] = _host(state.full())
        return prefix
    if isinstance(state, torch.Tensor):
        out[prefix] = _host(state)
        return prefix
    if isinstance(state, (tuple, list)):
        return [_state_spec(s, f"{prefix}.{j}", out)
                for j, s in enumerate(state)]
    raise CheckpointError(
        f"unserializable optimizer state at {prefix}: {type(state)}")


def _state_from_spec(spec, arrays):
    if spec is None:
        return None
    if isinstance(spec, str):
        a = arrays[spec]
        return a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.array(a))
    return tuple(_state_from_spec(s, arrays) for s in spec)


def _spec_keys(spec):
    if spec is None:
        return []
    if isinstance(spec, str):
        return [spec]
    return [k for s in spec for k in _spec_keys(s)]


def _noise_generators(trainer):
    """``{name: torch.Generator}`` of the nets holding the trainer's
    parameters (module note), each generator once."""
    index = {id(p): i for i, p in enumerate(trainer._params)}
    found = []
    for net in _random.nets():
        held = [index[id(p)] for p in net.collect_params().values()
                if id(p) in index]
        if held:
            found.append((min(held), -len(held), net))
    out, seen = {}, set()
    for j, _, net in sorted(found, key=lambda f: f[:2]):
        k = 0
        for gen in net._noise_generators():
            if id(gen) in seen:
                continue
            seen.add(id(gen))
            out[f"{RNG_PREFIX}net{j}/{k}"] = gen
            k += 1
    return out


def _sync_cards(trainer):
    """Wait for the work queued on every card holding a parameter or one
    of its positions (a captured step replays on the caller's stream; this
    covers any)."""
    devices = {p._tensor().device for p in trainer._params}
    for p in trainer._params:
        if p._placement is not None:
            devices.update(p._placement.layout.devices)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def capture(trainer, user_state=None):
    """Snapshot ``trainer``'s complete training state.

    Returns ``(arrays, meta)``. The arrays are host copies taken NOW (module
    note): after this returns, training may change every parameter and
    state while the manager writes the copies out asynchronously."""
    for p in trainer._params:
        p._tensor()   # raises for an uninitialized or deferred parameter
    _sync_cards(trainer)
    arrays = {}
    param_names, param_dtypes, param_shapes = [], [], []
    for i, p in enumerate(trainer._params):
        arrays[f"param/{i}"] = _host(p._tensor())
        param_names.append(p.name)
        param_dtypes.append(dtype_name(p.dtype) if p.dtype else None)
        param_shapes.append(list(arrays[f"param/{i}"].shape))
    state_specs = [_state_spec(s, f"opt/{i}", arrays)
                   for i, s in enumerate(trainer._states)]
    meta = {
        "snapshot_version": SNAPSHOT_VERSION,
        "num_params": len(trainer._params),
        "param_names": param_names,
        "param_dtypes": param_dtypes,
        "param_shapes": param_shapes,
        "state_specs": state_specs,
        "states_created": list(trainer._states_created),
        "optimizer": trainer._optimizer.bookkeeping_state(),
        "stale_indices": trainer._stale_indices(),
        # the JAX package's NHWC re-layout has no counterpart in the port:
        # every array is logical and whole
        "layout_perms": [None] * len(trainer._params),
        "sharding_plan": (trainer.sharding_plan.to_manifest()
                          if trainer.sharding_plan is not None else None),
        "scale": trainer._scale,
        "user_state": user_state,
    }
    seed, states = _random.device_states()
    arrays[f"{RNG_PREFIX}seed"] = np.array([seed], dtype=np.int64)
    for name, st in states.items():
        arrays[f"{RNG_PREFIX}device/{name}"] = st.numpy().copy()
    for name, gen in _noise_generators(trainer).items():
        arrays[name] = gen.get_state().numpy().copy()
    return arrays, meta


def _check(trainer, arrays, meta):
    """Every check :func:`apply` makes before it touches anything."""
    n = meta.get("num_params")
    if n != len(trainer._params):
        raise CheckpointError(
            f"checkpoint holds {n} params but trainer has "
            f"{len(trainer._params)}: wrong model or wrong checkpoint")
    names = meta.get("param_names") or []
    dtypes = meta.get("param_dtypes") or []
    for i, p in enumerate(trainer._params):
        if i < len(names) and names[i] != p.name:
            raise CheckpointError(
                f"param {i} name mismatch: checkpoint has {names[i]!r}, "
                f"trainer has {p.name!r}")
        want = dtypes[i] if i < len(dtypes) else None
        have = dtype_name(p.dtype) if p.dtype else None
        if want is not None and have is not None and want != have:
            raise CheckpointError(
                f"param {i} ({p.name}) dtype mismatch: checkpoint has "
                f"{want}, trainer declares {have}")
        a = arrays.get(f"param/{i}")
        if a is None:
            raise CheckpointError(f"missing array param/{i} ({p.name})")
        if tuple(a.shape) != tuple(p._tensor().shape):
            raise CheckpointError(
                f"param {i} ({p.name}) shape mismatch: checkpoint has "
                f"{tuple(a.shape)}, trainer has "
                f"{tuple(p._tensor().shape)}")
    specs = meta.get("state_specs") or [None] * len(trainer._params)
    if len(specs) != len(trainer._params):
        raise CheckpointError(f"checkpoint holds {len(specs)} optimizer "
                              f"states for {len(trainer._params)} params")
    for spec in specs:
        for k in _spec_keys(spec):
            if k not in arrays:
                raise CheckpointError(f"missing optimizer state array {k!r}")
    return specs


def _generator_targets(trainer, arrays):
    """``[(generator, saved state)]`` to set, and the saved states left
    out for another device type (module note)."""
    targets, skipped = [], []
    gens = _noise_generators(trainer)
    for name, a in arrays.items():
        if not name.startswith(f"{RNG_PREFIX}net"):
            continue
        gen = gens.get(name)
        if gen is None:
            skipped.append(name)
            continue
        st = torch.from_numpy(np.array(a, dtype=np.uint8))
        if st.numel() != gen.get_state().numel():
            skipped.append(name)
            continue
        targets.append((gen, st))
    return targets, skipped


def _device_targets(arrays):
    states, skipped = {}, []
    for name, a in arrays.items():
        if not name.startswith(f"{RNG_PREFIX}device/"):
            continue
        dev = torch.device(name[len(f"{RNG_PREFIX}device/"):])
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            skipped.append(name)
            continue
        states[str(dev)] = torch.from_numpy(np.array(a, dtype=np.uint8))
    return states, skipped


def apply(trainer, arrays, meta):
    """Load a snapshot into ``trainer`` (inverse of :func:`capture`), in
    place: weights by ``Parameter.set_data``, optimizer states into the
    state tensors that exist with the same nesting, shapes and dtypes
    (``Trainer._put_state``), generators by ``set_state``, so a captured
    ``gluon.TrainStep`` replays on the restored values with no rebuild.
    Under the trainer's sharding plan the values land in the positions'
    blocks of that plan (module note).

    Validates param count, names, dtypes, shapes and the presence of every
    array against the payload and raises CheckpointError on a mismatch
    BEFORE touching any state, so a failed restore never leaves the
    trainer half-loaded."""
    specs = _check(trainer, arrays, meta)
    generators, skipped = _generator_targets(trainer, arrays)
    devices, skipped_dev = _device_targets(arrays)
    skipped += skipped_dev
    if skipped:
        warnings.warn(
            f"checkpoint random states {sorted(skipped)[:4]} have no "
            f"generator of their kind here (another net or device type): "
            f"those noise streams are not restored", stacklevel=3)

    for i, p in enumerate(trainer._params):
        p.set_data(arrays[f"param/{i}"])
    for i, spec in enumerate(specs):
        trainer._put_state(i, _state_from_spec(spec, arrays))
    trainer._states_created = list(
        meta.get("states_created") or [s is not None for s in specs])
    plan = trainer.sharding_plan
    if plan is not None and not trainer._plan_applied:
        # parameters that were pending placement take it now, and every
        # created state the plan's state layout (trainer.py:_maybe_apply)
        trainer._maybe_apply_plan()
        if trainer._plan_applied:
            from ..optimizer import place_state_like

            for i, p in enumerate(trainer._params):
                if trainer._states_created[i]:
                    trainer._states[i] = place_state_like(
                        trainer._states[i], p, plan=plan,
                        name=trainer._param_names[i])
    opt_meta = meta.get("optimizer")
    if opt_meta:
        trainer._optimizer.load_bookkeeping_state(opt_meta)
    trainer._scale = float(meta.get("scale", 1.0))
    # stale again against THIS process's gradient versions
    trainer._grad_versions = {
        i: trainer._params[i]._grad_version
        for i in meta.get("stale_indices") or []
        if trainer._params[i].grad_req != "null"
        and trainer._params[i]._var is not None}
    seed = arrays.get(f"{RNG_PREFIX}seed")
    if seed is not None:
        _random.set_device_states(int(np.asarray(seed).reshape(-1)[0]),
                                  devices)
    for gen, st in generators:
        gen.set_state(st)
