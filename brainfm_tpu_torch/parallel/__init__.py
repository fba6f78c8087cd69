"""The multi-GPU layer (port of brainfm_tpu/parallel): the mesh and the
launch (mesh.py), FSDP sharding (fsdp.py) and spatial sharding with the
halo exchange and the space scope (spatial.py)."""

from .fsdp import fsdp_spec, init_sharded, shard_state, state_shardings
from .mesh import (data_sharding, init_distributed, make_mesh,
                   process_count, process_index, replicate, shard_batch)
from .spatial import (gather_space, halo_exchange, slice_space, space_scope,
                      spatial_shard_conv_apply)

__all__ = ["make_mesh", "shard_batch", "replicate", "data_sharding",
           "init_distributed", "spatial_shard_conv_apply", "halo_exchange",
           "fsdp_spec", "state_shardings", "shard_state", "init_sharded",
           "process_index", "process_count", "space_scope", "gather_space",
           "slice_space"]
