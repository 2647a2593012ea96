"""Parallelism over device meshes (counterpart of mxnet_tpu/parallel).

One process drives every position of a mesh (mesh.py): a position is a
``torch.device``, and several positions may share one.

Modules:
  mesh           — mesh construction (named axes over positions), values
                   placed a block a position (``Placed``), parameters
                   and batches laid out by spec
  collectives    — psum / all_gather / reduce_scatter / ring permute
  ring_attention — K/V-streaming sequence parallelism (the flash ring runs
                   the attention kernels on every hop)
  ulysses        — all-to-all head<->sequence parallelism
  data_parallel  — data-parallel step builders (whole batch; per-shard
                   bodies with a mean over the positions)

``moe`` and ``pipeline`` are not ported yet.
"""
from . import (collectives, data_parallel, mesh,  # noqa: F401
               ring_attention, ulysses)
from .data_parallel import (make_data_parallel_step,  # noqa: F401
                            make_shard_map_step)
from .mesh import (Layout, Placed, ShardingError,  # noqa: F401
                   make_mesh, shard_batch, shard_params)
from .ring_attention import (  # noqa: F401
    ring_attention_sharded,
    ring_flash_attention_sharded,
)
from .ulysses import ulysses_attention_sharded  # noqa: F401
