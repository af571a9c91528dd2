"""Data and tensor parallelism over ``torch.distributed`` (the JAX
package's ``parallel/``): the process-group setup (:mod:`.multihost`), the
(data, model) layout with its collectives (:mod:`.mesh`) and the sharding
of the wide conv kernels over ``model`` (:mod:`.tp`)."""

from .mesh import MeshContext, check_mesh, create_mesh
from .multihost import ensure_distributed, sync_any_flag, world_size
from .tp import shard_state, tp_shardings

__all__ = [
    "MeshContext",
    "check_mesh",
    "create_mesh",
    "ensure_distributed",
    "shard_state",
    "sync_any_flag",
    "tp_shardings",
    "world_size",
]
