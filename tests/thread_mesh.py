"""Data-parallel ranks as threads of one process: a stand-in for
``parallel.MeshContext``'s sums over the data group (``sum``, with
autograd, and ``sum_``) that needs no process group, so that one test holds
every rank's tensors. Imports no JAX.

Autograd runs a CPU backward on the thread that calls it, so the ranks may
each call ``backward`` on CPU tensors; on the card every backward runs on
the autograd engine's one device thread, where the ranks' sums would wait
on each other forever: there call the backward functions directly.
"""

from __future__ import annotations

import threading

import torch


class _Group:
    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size

    def all_sum(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` added in rank order (the same bits on each)."""
        self.slots[rank] = t.detach().clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for other in self.slots[1:]:
            total += other
        self.barrier.wait()
        return total


class _Sum(torch.autograd.Function):
    """As ``parallel.mesh._AllSum``: the gradient is the ranks' gradients summed."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.group.all_sum(mesh.rank, x)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.mesh), None


class ThreadMesh:
    """Rank ``rank`` of a data group of threads."""

    def __init__(self, group: _Group, rank: int):
        self.group, self.rank = group, rank

    @property
    def data_size(self) -> int:
        return self.group.size

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        return x.copy_(self.group.all_sum(self.rank, x))


def run_ranks(fn, per_rank: list) -> list:
    """``fn(mesh, *args)`` for each rank's ``args`` of ``per_rank``, each on
    a thread of its own; the results in rank order. Raises the first
    rank's error (the others' waits are broken)."""
    group = _Group(len(per_rank))
    results, errors = [None] * len(per_rank), []

    def target(rank):
        try:
            results[rank] = fn(ThreadMesh(group, rank), *per_rank[rank])
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=target, args=(r,)) for r in range(len(per_rank))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
