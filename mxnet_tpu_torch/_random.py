"""The stateful random state behind ``mx.random.seed`` and ``mx.np.random``
(counterpart of mxnet_tpu/_random.py:29-48).

The JAX package keeps one global key and splits it on every draw. Here each
device has its own ``torch.Generator``, made at its first draw and seeded
from the global seed (``seed + 1000 * (device index + 1)`` for a card,
``seed`` for the CPU), so a seed gives one stream per device and a draw on
one device does not move another's. The streams are torch's, not JAX's:
the same seed gives other numbers than the JAX package.

The nets' own noise generators (Dropout masks, attention dropout seeds)
are not drawn from here: ``Block.initialize`` derives them from its
``generator`` and records the net with :func:`register_net`, held weakly,
so that a checkpoint snapshot can find, from a trainer's Parameters, the
generators of the nets they belong to (:func:`nets`).
"""
from __future__ import annotations

import os
import threading
import weakref

import torch

__all__ = ["seed", "generator", "register_net", "nets", "device_states",
           "set_device_states"]

_DEFAULT_SEED = 0
_lock = threading.Lock()
_state = {"seed": _DEFAULT_SEED, "generators": {}}
_nets = []   # weakref.ref of every net that initialize() handed generators


def seed(seed_state=None, ctx="all"):  # noqa: ARG001 - ctx kept for the API
    """Seed every device's generator (``mx.random.seed``); None draws a
    seed from the OS."""
    if seed_state is None:
        seed_state = int.from_bytes(os.urandom(4), "little")
    with _lock:
        _state["seed"] = int(seed_state)
        _state["generators"] = {}


def _device_seed(device):
    base = _state["seed"]
    return base if device.type == "cpu" else base + 1000 * (device.index + 1)


def generator(device):
    """The generator of ``device`` (a ``torch.device``), made on first use."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["generators"].get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(
                _device_seed(device))
            _state["generators"][device] = gen
        return gen


def device_states():
    """``(seed, {device name: generator state})`` of the generators made so
    far: what a checkpoint keeps of this module."""
    with _lock:
        return _state["seed"], {str(d): g.get_state()
                                for d, g in _state["generators"].items()}


def set_device_states(seed_state, states):
    """Inverse of :func:`device_states`, in place: the seed, each saved
    generator's state (made if need be), and every other generator made in
    this process re-seeded as if fresh, so that the next draws on every
    device are the saved run's."""
    with _lock:
        _state["seed"] = int(seed_state)
    for name, st in states.items():
        generator(torch.device(name)).set_state(st)
    with _lock:
        for d, g in _state["generators"].items():
            if str(d) not in states:
                g.manual_seed(_device_seed(d))


def register_net(block):
    """Record ``block`` (weakly) as a net whose noise generators were set
    by ``initialize``."""
    with _lock:
        _nets[:] = [r for r in _nets if r() is not None]
        if not any(r() is block for r in _nets):
            _nets.append(weakref.ref(block))


def nets():
    """The live nets of :func:`register_net`, in the order recorded."""
    with _lock:
        return [n for n in (r() for r in _nets) if n is not None]
