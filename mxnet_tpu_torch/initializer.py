"""Weight initializers (counterpart of mxnet_tpu/initializer.py).

Each draws from an explicit ``torch.Generator``. Values are drawn on the
host in f32 (whatever device scope is active) and then cast and moved to
the parameter's device, so one seed gives the same weights on the CPU and
on the card.
"""
from __future__ import annotations

import torch

__all__ = ["Initializer", "Zero", "One", "Uniform", "Normal", "create"]


class Initializer:
    """Base initializer: ``init_tensor(shape, dtype, device, generator)``."""

    def init_tensor(self, shape, dtype, device, generator):
        data = self._init_weight(tuple(shape), generator)
        return data.to(device=device, dtype=dtype)

    def _init_weight(self, shape, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class Zero(Initializer):
    def _init_weight(self, shape, generator):  # noqa: ARG002
        return torch.zeros(shape, device="cpu")


class One(Initializer):
    def _init_weight(self, shape, generator):  # noqa: ARG002
        return torch.ones(shape, device="cpu")


class Uniform(Initializer):
    """U(-scale, scale); 0.07 is the default the Gluon blocks use."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, shape, generator):
        return torch.empty(shape, device="cpu").uniform_(
            -self.scale, self.scale, generator=generator)


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, shape, generator):
        return torch.empty(shape, device="cpu").normal_(
            0.0, self.sigma, generator=generator)


_NAMES = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
          "uniform": Uniform, "normal": Normal}


def create(init):
    """An :class:`Initializer` from an instance or a registered name."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.lower() in _NAMES:
        return _NAMES[init.lower()]()
    raise TypeError(f"cannot create initializer from {init!r}")
