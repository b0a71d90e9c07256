"""Data and spatial parallel training over ``torch.distributed`` (port of
``cadepth_tpu.parallel``)."""

from cadepth_tpu_torch.parallel.distributed import initialize_distributed
from cadepth_tpu_torch.parallel.mesh import (
    DataParallel,
    band_batch,
    batch_sharding,
    batch_shardings,
    image_sharding,
    make_mesh,
    make_mesh_2d,
    replicate_sharding,
    replicate_state,
    shard_batch,
)
from cadepth_tpu_torch.parallel.spatial import SpaceGroup

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "make_mesh_2d",
    "image_sharding",
    "batch_shardings",
    "batch_sharding",
    "band_batch",
    "replicate_sharding",
    "shard_batch",
    "replicate_state",
    "DataParallel",
    "SpaceGroup",
]
