"""The stateful random state behind ``mx.random.seed`` and ``mx.np.random``
(counterpart of mxnet_tpu/_random.py:29-48).

The JAX package keeps one global key and splits it on every draw. Here each
device has its own ``torch.Generator``, made at its first draw and seeded
from the global seed (``seed + 1000 * (device index + 1)`` for a card,
``seed`` for the CPU), so a seed gives one stream per device and a draw on
one device does not move another's. The streams are torch's, not JAX's:
the same seed gives other numbers than the JAX package.
"""
from __future__ import annotations

import os
import threading

import torch

__all__ = ["seed", "generator"]

_DEFAULT_SEED = 0
_lock = threading.Lock()
_state = {"seed": _DEFAULT_SEED, "generators": {}}


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
