"""``mx.npx.random`` (counterpart of mxnet_tpu/numpy_extension/random.py):
``seed``, ``bernoulli``, ``normal_n`` and ``uniform_n`` under the
reference's namespace."""
from __future__ import annotations

from . import bernoulli, normal_n, seed, uniform_n  # noqa: F401

__all__ = ["seed", "bernoulli", "normal_n", "uniform_n"]
