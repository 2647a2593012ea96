"""KVStoreBase, the store plugin interface, and ``TestStore`` (counterpart
of mxnet_tpu/kvstore/base.py).

External stores register with ``@KVStoreBase.register`` and implement
``broadcast`` and ``pushpull`` (``push``/``pull`` where they have them).
The registry is the port's own class attribute: the JAX package's is
another object, so a store registered there is not found here.
"""
from __future__ import annotations

__all__ = ["KVStoreBase", "TestStore"]


def _aslist(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _copy_sum(datas):
    """The sum of a key's copies (tensors) on the first copy's device."""
    total = datas[0]
    for d in datas[1:]:
        total = total + d.to(total.device)
    return total


class KVStoreBase:
    """A store: broadcast and pushpull over string or int keys."""

    kv_registry = {}

    @staticmethod
    def register(klass):
        KVStoreBase.kv_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def find(name):
        return KVStoreBase.kv_registry.get(name.lower())

    # -- required API ------------------------------------------------------
    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def is_capable(self, capability):  # noqa: ARG002
        return False

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    OPTIMIZER = "optimizer"

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    # -- gradient compression (the local and distributed stores) -----------
    _compression = None

    def set_gradient_compression(self, compression_params):
        """1-bit or 2-bit gradient compression with error feedback
        (``{"type": "2bit", "threshold": 0.5}``)."""
        from .gradient_compression import GradientCompression

        params = dict(compression_params)
        self._compression = GradientCompression(
            type=params.pop("type", "2bit"), **params)

    def _compress_vals(self, key, vals):
        """Each pushed value quantized and dequantized with a residual per
        (key, slot) ``"key:i"``; the values themselves without
        compression."""
        if self._compression is None:
            return vals
        from ..ndarray.ndarray import NDArray

        return [NDArray(self._compression.compress_pipeline(
            f"{key}:{i}", v._data)) for i, v in enumerate(vals)]

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError


@KVStoreBase.register
class TestStore(KVStoreBase):
    """A single-process store in plain Python (base.py:TestStore)."""

    def broadcast(self, key, value, out, priority=0):  # noqa: ARG002
        for o in out if isinstance(out, (list, tuple)) else [out]:
            value.copyto(o)

    def pushpull(self, key, value, out=None, priority=0):  # noqa: ARG002
        values = value if isinstance(value, (list, tuple)) else [value]
        total = values[0]
        for v in values[1:]:
            total = total + v
        if out is None:
            return
        for o in out if isinstance(out, (list, tuple)) else [out]:
            total.copyto(o)

    def is_capable(self, capability):
        return capability in ("optimizer",)
