"""Data parallelism across processes under ``torch.distributed`` (port of
``nerf_for_angiography_tpu/parallel/``): the mesh, multi-process
initialization and input sharding; the collectives the sharded paths run
are in ``parallel/collectives.py``."""

from .distributed import (
    initialize_multihost,
    is_coordinator,
    process_local_slice,
    shard_process_local,
)
from .mesh import (
    create_mesh,
    data_sharding,
    pad_to_multiple,
    replicate,
    replicated,
    shard_leading_axis,
)

__all__ = [
    "create_mesh",
    "data_sharding",
    "initialize_multihost",
    "is_coordinator",
    "pad_to_multiple",
    "process_local_slice",
    "replicate",
    "replicated",
    "shard_leading_axis",
    "shard_process_local",
]
