"""Parallelism over device meshes (counterpart of mxnet_tpu/parallel).

One process drives every position of a mesh (mesh.py): a position is a
``torch.device``, and several positions may share one.

Modules:
  mesh           — mesh construction (named axes over positions)
  collectives    — psum / all_gather / reduce_scatter / ring permute
  ring_attention — K/V-streaming sequence parallelism (the flash ring runs
                   the attention kernels on every hop)
  ulysses        — all-to-all head<->sequence parallelism

``moe``, ``pipeline`` and ``data_parallel`` are not ported yet.
"""
from . import collectives, mesh, ring_attention, ulysses  # noqa: F401
from .mesh import (ShardingError, make_mesh, shard_batch,  # noqa: F401
                   shard_params)
from .ring_attention import (  # noqa: F401
    ring_attention_sharded,
    ring_flash_attention_sharded,
)
from .ulysses import ulysses_attention_sharded  # noqa: F401
