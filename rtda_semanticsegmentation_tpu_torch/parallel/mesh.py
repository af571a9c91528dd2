"""The (data, model) layout and its collectives (port of the JAX package's
``parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh, shards
the batch over ``data`` and the wide conv kernels' output channels over
``model`` (``parallel/tp.py``), and lets XLA emit every collective. Here
each rank of a ``torch.distributed`` process group holds one device; rank
``r`` is data index ``r // model`` and model index ``r % model``, as the
JAX package's ``devices.reshape(data, model)`` orders them. The ranks of
one *model group* (the same data index) hold the same rows of the global
batch and each its slice of every sharded kernel; the ranks of one *data
group* (the same model index) hold the same slices and different rows. The
code that needs a collective asks a :class:`MeshContext` for it:

- over the data group: the BatchNorm statistics (``models/layers.py``),
  one autograd sum of ``[Σx, Σx², n]`` per layer; the losses
  (``ops/losses.py``): the global valid-pixel count of the CE mean, the
  Lovász histograms (kernel K1's integer sums), the gathered probabilities
  of the exact-sort Lovász; the step's metrics, the eval confusion matrix;
- over the model group: the sharded conv's two autograd functions (the
  *gather over channels*: each rank writes its output channels into a
  zero-filled full buffer and the buffer is summed, its backward keeps
  this rank's slice of the gradient; the *input copy*: the identity, its
  backward sums the ranks' partial input gradients) and the squares of
  the sharded slices in the gradient norms;
- over the world: the gradients (``train/steps.py``), one coalesced sum
  per model and kind, the checkpoint barrier, the SIGTERM flag.

Only ``all_reduce`` and ``barrier`` are used: gloo has them for CUDA
tensors as well, so two ranks can share one card. The gather therefore
moves ``model`` times the bytes of an ``all_gather``. A sum over one rank
runs no collective; the gradient sum runs wherever a process group is up.
"""

from __future__ import annotations

import dataclasses
from typing import AbstractSet, Any, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from .multihost import local_rank, rank, world_size


class _AllSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; its gradient is the sum of the
    ranks' gradients (each rank's loss is its share of the global loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g, ctx.group), None


def _sum_at_least_f32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in at least f32, in ``x``'s dtype and (a
    dense ``x``) its memory format: a ``channels_last`` gradient stays one
    for the BatchNorm kernels and convs before it."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32), memory_format=torch.preserve_format, copy=True)
    dist.all_reduce(acc, group=group)
    return acc.to(x.dtype)


class _InputCopy(torch.autograd.Function):
    """The identity; its gradient is the sum over the model group of the
    ranks' gradients (each rank's conv slice contributes a part of the
    input's gradient), in at least f32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_at_least_f32(g, ctx.group), None


def _gather(x: torch.Tensor, dim: int, lo: int, full: int, group) -> torch.Tensor:
    """``x`` as indices ``[lo, lo + x.shape[dim])`` of a ``full``-wide dim
    ``dim``: written into a zero-filled buffer that is summed over
    ``group`` (exact: every other rank's term there is zero). The buffer
    keeps a ``channels_last`` ``x``'s memory format, which the convs and
    BatchNorm kernels after a sharded conv read as it is."""
    shape = list(x.shape)
    shape[dim] = full
    channels_last = x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    buf = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt).zero_()
    buf.narrow(dim, lo, x.shape[dim]).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf


class _GatherChannels(torch.autograd.Function):
    """A rank's channels ``[lo, lo + n)`` of dim 1 gathered into the full
    ``full`` channels over the model group. Its gradient is this rank's
    slice of the output's gradient, the same on every rank of the group:
    not a reduce-scatter, which would count it ``model`` times."""

    @staticmethod
    def forward(ctx, y, lo, full, group):
        ctx.lo, ctx.n = lo, y.shape[1]
        return _gather(y, 1, lo, full, group)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo: ctx.lo + ctx.n], None, None, None


def check_mesh(cfg: MeshConfig, world: int) -> int:
    """The data axis's size for ``world`` ranks, one device each:
    ``data x model`` must be ``world``, ``data = -1`` takes ``world //
    model``."""
    model = cfg.model
    if model < 1:
        raise ValueError(f"mesh.model must be >= 1, got {model}")
    if world % model:
        raise ValueError(f"mesh.model={model} needs a multiple of {model} ranks (data x model = world, one device "
                         f"each) but the process group has {world} rank(s): launch data x {model} processes "
                         f"(python -m torch.distributed.run --nproc_per_node N ...)")
    data = world // model
    if cfg.data not in (-1, data):
        raise ValueError(f"mesh.data={cfg.data} but the process group has {world} rank(s), one device each, "
                         f"and mesh.model={model}: launch {cfg.data * model} processes (python -m "
                         f"torch.distributed.run --nproc_per_node {cfg.data * model} ...) or pass -1")
    return data


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """This rank's place in the (data, model) layout: ``rank`` of ``world``
    ranks, on ``device``; ``grouped`` when a process group is up (at
    world 1 too, under a launcher). ``model_size`` ranks form a model group;
    ``data_group`` / ``model_group`` are this rank's process groups (None:
    the whole world)."""

    rank: int
    world: int
    device: torch.device
    grouped: bool = False
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_size(self) -> int:
        return self.world // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def check_batch(self, batch_size: int, what: str = "batch") -> int:
        """Rows of a global ``batch_size`` per data index; raises unless it divides."""
        if batch_size % self.data_size:
            raise ValueError(f"the global {what} of {batch_size} does not split over {self.data_size} ranks "
                             "of the data axis")
        return batch_size // self.data_size

    def rows(self, local_batch: int) -> tuple:
        """(first row, global batch) of this rank's ``local_batch`` rows: the
        rows of its data index."""
        return self.data_rank * local_batch, local_batch * self.data_size

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data group, with autograd; the identity for one data index."""
        return x if self.data_size == 1 else _AllSum.apply(x, self.data_group)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data group in place, no autograd; the identity for
        one data index."""
        if self.data_size > 1:
            dist.all_reduce(x, group=self.data_group)
        return x

    def model_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the model group in place, no autograd; the identity at model 1."""
        if self.model_size > 1:
            dist.all_reduce(x, group=self.model_group)
        return x

    def input_copy(self, x: torch.Tensor) -> torch.Tensor:
        """A sharded conv's input: the identity, its gradient summed over the model group."""
        return _InputCopy.apply(x, self.model_group)

    def gather_channels(self, y: torch.Tensor, lo: int, full: int) -> torch.Tensor:
        """A sharded conv's output: this rank's channels ``[lo, lo +
        y.shape[1])`` of a ``full``-channel tensor, gathered over the model
        group, with autograd."""
        return _GatherChannels.apply(y, lo, full, self.model_group)

    @torch.no_grad()
    def gather_rows(self, x: torch.Tensor, lo: int, full: int) -> torch.Tensor:
        """Rows ``[lo, lo + x.shape[0])`` of a ``full``-row tensor gathered
        over the model group, no autograd (a sharded weight or moment)."""
        return _gather(x, 0, lo, full, self.model_group)

    def reduce_grads(self, module: torch.nn.Module, sharded: AbstractSet[int] = frozenset()) -> None:
        """Sum ``module``'s gradients over the ranks: one ``all_reduce`` of
        one flat buffer per dtype and kind. A replicated parameter's
        gradient is summed over the world and divided by ``model_size``, so
        the ranks of a model group, whose gradients may differ in the last
        bits, end with the same bits; a parameter whose id is in
        ``sharded`` (this rank's slice of a kernel,
        ``parallel/tp.py::sharded_ids``) is summed over the data group. Runs
        wherever a process group is up; parameters without a gradient
        (identical on every rank) are left out."""
        if not self.grouped:
            return
        grads = {}
        for p in module.parameters():
            if p.grad is not None:
                grads.setdefault((id(p) in sharded, p.grad.dtype), []).append(p.grad)
        for (is_sharded, _), gs in sorted(grads.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
            flat = torch.cat([g.reshape(-1) for g in gs])
            if is_sharded:
                self.sum_(flat)
            else:
                dist.all_reduce(flat)
                if self.model_size > 1:
                    flat /= self.model_size
            offset = 0
            for g in gs:
                g.copy_(flat[offset: offset + g.numel()].view_as(g))
                offset += g.numel()

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def _groups(data: int, model: int):
    """(this rank's data group, its model group): every rank creates every
    group, in the same order (``new_group`` is a collective)."""
    me = rank()
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if me % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if me // model == d:
            model_group = g
    return data_group, model_group


def create_mesh(cfg: Optional[MeshConfig] = None, device="cuda") -> MeshContext:
    """The layout of this process: the process group's rank and size (0 of
    1 without one), checked against ``cfg``, on ``device``; at ``model`` > 1
    the data and model groups. A CUDA device without an index is this
    rank's card, ``cuda:LOCAL_RANK``; an explicit one is kept (two ranks on
    one card)."""
    cfg = cfg or MeshConfig()
    world = world_size()
    data = check_mesh(cfg, world)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    data_group = model_group = None
    if cfg.model > 1:
        data_group, model_group = _groups(data, cfg.model)
    return MeshContext(rank=rank(), world=world, device=device, grouped=dist.is_available() and dist.is_initialized(),
                       model_size=cfg.model, data_group=data_group, model_group=model_group)
