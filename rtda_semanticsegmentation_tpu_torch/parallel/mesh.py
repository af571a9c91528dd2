"""The data-parallel layout and its collectives (port of the JAX package's
``parallel/mesh.py``).

The JAX package shards the batch over the ``data`` axis of a device mesh
and lets XLA emit every collective. Here each rank of a
``torch.distributed`` process group holds one device and its rows of the
global batch, and the code that needs a collective asks a
:class:`MeshContext` for it:

- the BatchNorm statistics (``models/layers.py``): one autograd sum of
  ``[Σx, Σx², n]`` per layer;
- the losses (``ops/losses.py``): the global valid-pixel count of the CE
  mean, the Lovász histograms (kernel K1's integer sums), the gathered
  probabilities of the exact-sort Lovász;
- the gradients (``train/steps.py``): one coalesced sum per model;
- the eval confusion matrix, the checkpoint barrier, the SIGTERM flag.

Only ``all_reduce`` and ``barrier`` are used: gloo has them for CUDA
tensors as well, so two ranks can share one card. At world 1 the
BatchNorm and loss helpers run no collective (a sum over one rank is the
identity); the gradient sum runs wherever a process group is up.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from .multihost import local_rank, rank, world_size


class _AllSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients
    (each rank's loss is its share of the global loss)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g)


def check_mesh(cfg: MeshConfig, world: int) -> int:
    """The data axis's size for ``world`` ranks, one device each: ``data``
    must be -1 or ``world``; ``model`` must be 1."""
    if cfg.model != 1:
        raise ValueError(f"mesh.model={cfg.model}: tensor parallelism over a model axis (the JAX package's "
                         "parallel/tp.py) is not ported yet (ROADMAP queue 1, parallel/tp.py)")
    if cfg.data not in (-1, world):
        raise ValueError(f"mesh.data={cfg.data} but the process group has {world} rank(s), one device each: "
                         f"launch {cfg.data} processes (python -m torch.distributed.run --nproc_per_node "
                         f"{cfg.data} ...) or pass -1")
    return world


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """This rank's place in the data-parallel layout: ``rank`` of ``world``
    ranks, on ``device``; ``grouped`` when a process group is up (at
    world 1 too, under a launcher)."""

    rank: int
    world: int
    device: torch.device
    grouped: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def check_batch(self, batch_size: int, what: str = "batch") -> int:
        """Rows of a global ``batch_size`` per rank; raises unless it divides."""
        if batch_size % self.world:
            raise ValueError(f"the global {what} of {batch_size} does not split over {self.world} ranks")
        return batch_size // self.world

    def rows(self, local_batch: int) -> tuple:
        """(first row, global batch) of this rank's ``local_batch`` rows."""
        return self.rank * local_batch, local_batch * self.world

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, with autograd; the identity at world 1."""
        return x if self.world == 1 else _AllSum.apply(x)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks in place, no autograd; the identity at world 1."""
        if self.world > 1:
            dist.all_reduce(x)
        return x

    def reduce_grads(self, module: torch.nn.Module) -> None:
        """Sum ``module``'s gradients over the ranks: one ``all_reduce`` of
        one flat buffer per dtype. Runs wherever a process group is up;
        parameters without a gradient (identical on every rank) are left
        out."""
        if not self.grouped:
            return
        grads = {}
        for p in module.parameters():
            if p.grad is not None:
                grads.setdefault(p.grad.dtype, []).append(p.grad)
        for gs in grads.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            dist.all_reduce(flat)
            offset = 0
            for g in gs:
                g.copy_(flat[offset: offset + g.numel()].view_as(g))
                offset += g.numel()

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def create_mesh(cfg: Optional[MeshConfig] = None, device="cuda") -> MeshContext:
    """The layout of this process: the process group's rank and size (0 of
    1 without one), checked against ``cfg``, on ``device``. A CUDA device
    without an index is this rank's card, ``cuda:LOCAL_RANK``; an explicit
    one is kept (two ranks on one card)."""
    cfg = cfg or MeshConfig()
    world = world_size()
    check_mesh(cfg, world)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    return MeshContext(rank=rank(), world=world, device=device, grouped=dist.is_available() and dist.is_initialized())
