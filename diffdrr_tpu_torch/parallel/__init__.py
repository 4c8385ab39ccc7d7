"""Several devices: meshes, ray- and data-sharded renders, slab-sharded
volumes, the sharded reconstruction step, and several processes.

Counterpart of ``diffdrr_tpu/parallel`` on ``torch.distributed``: one
process per device, NCCL on the card, gloo on the CPU.
"""

from .sharding import (
    make_mesh,
    shard_drr,
    make_sharded_render,
    slab_sharded_raycast,
    slab_sharded_joseph,
    slab_sharded_siddon,
    make_reconstruction_step,
)
from .multihost import (
    initialize_distributed,
    global_mesh,
    local_batch_to_global,
    process_local_slice,
)

__all__ = [
    "make_mesh",
    "shard_drr",
    "make_sharded_render",
    "slab_sharded_raycast",
    "slab_sharded_joseph",
    "slab_sharded_siddon",
    "make_reconstruction_step",
    "initialize_distributed",
    "global_mesh",
    "local_batch_to_global",
    "process_local_slice",
]
