"""Tensor parallelism over the ``model`` axis (port of the JAX package's
``parallel/tp.py``).

The rule is the JAX package's: a rank-4 parameter (a conv kernel; its
optimizer moments follow it) whose output-channel dimension is at least
``min_channels`` wide and divisible by the model axis's size is sharded on
that dimension over ``model``; everything else (BatchNorm vectors, biases,
small convs, scalars) is replicated. ``model == 1`` is full replication.
The port's kernels are ``(CO, CI, kh, kw)``, so the output channels are
dim 0 where the JAX package's HWIO kernels have them last.

Where XLA's partitioner inserts the collectives in JAX, here each sharded
conv (``models/layers.py::Conv``, its ``shard`` set) holds the contiguous
slice ``[lo, hi)`` of its output channels and runs: the input copy ->
the conv on its slice -> the gather over channels -> its bias, and the
BatchNorm of its ConvBN, on the full channels (``parallel/mesh.py``). Only
plain ``Conv`` modules shard; a rule that picks another kernel (the
discriminator's K5 conv at ``min_channels`` <= 64) raises.

A sharded state holds slices: :func:`gather_state` gives the full tensors
(a collective over the model group, every rank calls it) for checkpoints,
and :func:`load_state` loads a full checkpoint into a sharded state, each
rank taking its slices, so the file format is the same at every layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet

import torch

from ..models.layers import Conv
from .mesh import MeshContext


@dataclasses.dataclass(frozen=True)
class ChannelShard:
    """A sharded conv's place: output channels ``[lo, hi)`` of ``full``,
    gathered over ``mesh``'s model group (``models/layers.py::Conv``)."""

    mesh: MeshContext
    lo: int
    hi: int
    full: int


def _model_size(mesh) -> int:
    return mesh if isinstance(mesh, int) else mesh.model_size


def _modules(tree) -> Dict[str, torch.nn.Module]:
    """name -> module of a module (``""``) or a ``TrainState``."""
    if isinstance(tree, torch.nn.Module):
        return {"": tree}
    out = {"model": tree.model}
    if getattr(tree, "discriminator", None) is not None:
        out["discriminator"] = tree.discriminator
    return out


def tp_shardings(tree, mesh, min_channels: int = 256):
    """The rule on ``tree``: for a module, ``{parameter name: True where it
    is sharded over model}``; for a ``TrainState``, that dict for each of
    ``model`` and ``discriminator``. ``mesh``: a ``MeshContext`` or the
    model axis's size."""
    model = _model_size(mesh)

    def rule(p) -> bool:
        return model > 1 and p.dim() == 4 and p.shape[0] >= min_channels and p.shape[0] % model == 0

    marks = {key: {n: rule(p) for n, p in m.named_parameters()} for key, m in _modules(tree).items()}
    return marks[""] if isinstance(tree, torch.nn.Module) else marks


def sharded_convs(module: torch.nn.Module) -> Dict[str, Conv]:
    """name -> conv of ``module``'s sharded convs."""
    return {n: m for n, m in module.named_modules() if isinstance(m, Conv) and m.shard is not None}


def sharded_ids(module: torch.nn.Module) -> FrozenSet[int]:
    """ids of ``module``'s parameters that are this rank's slices (the
    sharded kernels): what ``MeshContext.reduce_grads`` sums over the data
    group and the gradient norms count over the model group."""
    return frozenset(id(conv.weight) for conv in sharded_convs(module).values())


def _index(optimizer: torch.optim.Optimizer) -> Dict[int, int]:
    """id(parameter) -> its key in ``optimizer.state_dict()['state']``."""
    params = (p for g in optimizer.param_groups for p in g["params"])
    return {id(p): i for i, p in enumerate(params)}


def _shard_module(module, optimizer, mesh: MeshContext, min_channels: int) -> None:
    marks = tp_shardings(module, mesh, min_channels)
    owners = dict(module.named_modules())
    model, r = mesh.model_size, mesh.model_rank
    for name, chosen in marks.items():
        if not chosen:
            continue
        owner_name, _, leaf = name.rpartition(".")
        conv = owners[owner_name]
        if type(conv) is not Conv or leaf != "weight":
            raise ValueError(f"tensor parallelism shards plain convs only; {name} ({type(conv).__name__}) "
                             f"matches the rule at min_channels={min_channels}")
        if conv.shard is not None:
            continue  # already sharded: a second call changes nothing
        full = conv.weight.shape[0]
        n = full // model
        lo, hi = r * n, (r + 1) * n
        p = conv.weight
        with torch.no_grad():
            p.data = p.data[lo:hi].clone()
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            for k, v in list(state.items()):
                if torch.is_tensor(v) and v.dim() == 4 and v.shape[0] == full:
                    state[k] = v[lo:hi].clone()
        conv.shard = ChannelShard(mesh, lo, hi, full)


def shard_state(state, mesh: MeshContext, min_channels: int = 256):
    """Shard ``state`` (a ``TrainState``) in place by :func:`tp_shardings`:
    each chosen conv keeps this rank's contiguous slice of its output
    channels, and so does any optimizer state already built for it (an
    optimizer built before the call makes its state on the slices). A no-op
    at model 1 and for a conv already sharded. Returns ``state``."""
    if mesh.model_size == 1:
        return state
    _shard_module(state.model, state.optimizer, mesh, min_channels)
    if state.discriminator is not None:
        _shard_module(state.discriminator, state.d_optimizer, mesh, min_channels)
    return state


def full_state_dict(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` with every sharded kernel gathered whole (a
    collective over the model group when ``module`` has sharded convs)."""
    sd = module.state_dict()
    for name, conv in sharded_convs(module).items():
        s = conv.shard
        sd[f"{name}.weight" if name else "weight"] = s.mesh.gather_rows(conv.weight.detach(), s.lo, s.full)
    return sd


def _optimizer_moments(optimizer, module):
    """(key in the optimizer's state, shard) of each sharded kernel of ``module``."""
    index = _index(optimizer)
    return [(index[id(conv.weight)], conv.shard) for conv in sharded_convs(module).values()
            if id(conv.weight) in index]


def full_optimizer_state(optimizer: torch.optim.Optimizer, module: torch.nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of ``module``'s sharded
    kernels gathered whole (a collective over the model group)."""
    osd = optimizer.state_dict()
    state = dict(osd["state"])
    for key, s in _optimizer_moments(optimizer, module):
        if key in state:
            state[key] = {k: s.mesh.gather_rows(v, s.lo, s.full)
                          if torch.is_tensor(v) and v.dim() == 4 and v.shape[0] == s.hi - s.lo else v
                          for k, v in state[key].items()}
    return {**osd, "state": state}


def gather_state(state) -> dict:
    """The full tensors of a (possibly sharded) ``TrainState``:
    ``generator`` and ``optimizer`` (and ``discriminator`` and
    ``d_optimizer``), as ``state_dict()``s. Every rank calls it."""
    out = {"generator": full_state_dict(state.model),
           "optimizer": full_optimizer_state(state.optimizer, state.model)}
    if state.discriminator is not None:
        out["discriminator"] = full_state_dict(state.discriminator)
        out["d_optimizer"] = full_optimizer_state(state.d_optimizer, state.discriminator)
    return out


def _slice_state_dict(module, sd: dict) -> dict:
    sd = dict(sd)
    for name, conv in sharded_convs(module).items():
        key = f"{name}.weight" if name else "weight"
        s = conv.shard
        sd[key] = sd[key][s.lo: s.hi]
    return sd


def _slice_optimizer_state(optimizer, module, osd: dict) -> dict:
    state = dict(osd["state"])
    for key, s in _optimizer_moments(optimizer, module):
        if key in state:
            state[key] = {k: v[s.lo: s.hi] if torch.is_tensor(v) and v.dim() == 4 and v.shape[0] == s.full else v
                          for k, v in state[key].items()}
    return {**osd, "state": state}


def load_state(state, tree: dict) -> None:
    """Load the full tensors of ``tree`` (``generator`` and ``optimizer``,
    and ``discriminator`` and ``d_optimizer`` when ``state`` has a
    discriminator) into ``state``, each sharded kernel and its moments as
    this rank's slice."""
    state.model.load_state_dict(_slice_state_dict(state.model, tree["generator"]))
    state.optimizer.load_state_dict(_slice_optimizer_state(state.optimizer, state.model, tree["optimizer"]))
    d = state.discriminator
    if d is not None:
        d.load_state_dict(_slice_state_dict(d, tree["discriminator"]))
        state.d_optimizer.load_state_dict(_slice_optimizer_state(state.d_optimizer, d, tree["d_optimizer"]))
