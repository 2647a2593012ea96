"""KVStore: data-parallel communication of parameters and gradients
(counterpart of mxnet_tpu/kvstore).

``'local'``/``'device'`` aggregate in one process (kvstore.py);
``'tpu_dist'`` and its aliases sum across the processes of a
``torch.distributed`` group (tpu_dist.py); ``'p3'`` adds chunking and
priority order. Stores registered through ``KVStoreBase.register`` are
found by name. ``'horovod'`` and ``'byteps'`` name ``TPUDist``: the
reference's adapters hand MXNet's C-handle arrays to those packages, which
cannot take the port's tensors, and fall back to ``tpu_dist`` without
them; ``TPUDist`` keeps their pushpull contract.
"""
import logging

from .base import KVStoreBase  # noqa: F401
from .kvstore import KVStore, KVStoreLocal  # noqa: F401
from .gradient_compression import GradientCompression  # noqa: F401
from .tpu_dist import P3Store, TPUDist  # noqa: F401

__all__ = ["KVStoreBase", "KVStore", "KVStoreLocal", "TPUDist", "P3Store",
           "GradientCompression", "KVStoreServer", "create"]


class KVStoreServer:
    """The parameter server's role (kvstore_server.py). The store of this
    package has no server: construction succeeds, ``run`` says so."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self):
        raise RuntimeError(
            "KVStoreServer has no role here: kvstore='tpu_dist' is "
            "serverless (all_reduce over torch.distributed). Launch "
            "workers only, with mxnet_tpu_torch/tools/launch.py")


def create(name="local"):
    """A store by type name: 'local', 'device' (one process); 'tpu_dist',
    'dist_sync', 'dist_async', 'dist', 'dist_sync_device',
    'dist_async_device', 'nccl', 'horovod', 'byteps' (TPUDist); 'p3'
    (P3Store); or a registered class's name."""
    name_l = name.lower()
    if name_l in ("local", "device", "local_allreduce_cpu",
                  "local_allreduce_device"):
        return KVStoreLocal(name_l)
    if name_l == "p3":
        return P3Store()
    if name_l in ("horovod", "byteps"):
        logging.getLogger(__name__).info(
            "kvstore='%s' has no adapter in the port (its package drives "
            "MXNet arrays); using tpu_dist, the same pushpull contract",
            name_l)
        return TPUDist()
    if name_l in ("tpu_dist", "dist_sync", "dist_async", "dist",
                  "dist_sync_device", "dist_async_device", "nccl"):
        return TPUDist()
    cls = KVStoreBase.find(name_l)
    if cls is not None:
        return cls()
    raise ValueError(f"unknown kvstore type '{name}'")
