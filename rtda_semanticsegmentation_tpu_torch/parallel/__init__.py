"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel/``): the process-group setup (:mod:`.multihost`) and the
data-parallel layout with its collectives (:mod:`.mesh`). The JAX package's
tensor-parallel ``tp.py`` is not ported."""

from .mesh import MeshContext, check_mesh, create_mesh
from .multihost import ensure_distributed, sync_any_flag, world_size

__all__ = [
    "MeshContext",
    "check_mesh",
    "create_mesh",
    "ensure_distributed",
    "sync_any_flag",
    "world_size",
]
