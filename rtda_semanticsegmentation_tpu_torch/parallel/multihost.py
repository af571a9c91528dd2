"""Process-group setup for data parallelism (port of the JAX package's
``parallel/multihost.py``).

A launcher (``python -m torch.distributed.run --nproc_per_node N ...``)
starts one process per device and gives each its ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. Call
:func:`ensure_distributed` once at program start: it joins the process group
those name, and does nothing in a process started without them (the tests,
a single-card run). A process told it has N ranks that cannot join its
group raises: it never goes on as N independent runs that each see the
whole dataset and write the same checkpoint directory.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def world_size() -> int:
    """Ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_rank() -> int:
    """This process's device index on its host (the launcher's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def ensure_distributed(device="cuda", backend=None, timeout_s: float = 1800.0) -> bool:
    """Join the launcher's process group: NCCL where the run's ``device`` is
    CUDA, gloo on the CPU, or ``backend`` where the caller names one (gloo
    for two ranks on one card). Returns True when this call initialized the
    group (the caller then destroys it), False when a group was already up
    or the process was started without a launcher. Raises when the
    launcher's environment is incomplete or the group cannot form within
    ``timeout_s``."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ and "RANK" not in os.environ:
        return False
    missing = [k for k in _LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a distributed launch needs {', '.join(_LAUNCHER_ENV)} in the environment; "
                           f"{', '.join(missing)} missing")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(device.index if device.index is not None else local_rank())
    world = int(os.environ["WORLD_SIZE"])
    try:
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]), world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # whatever the rendezvous raises, the run must not go on alone
        raise RuntimeError(f"WORLD_SIZE={world} is set but this rank could not join the {backend} process "
                           f"group at {os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}: {e}") from e
    return True


def sync_any_flag(flag: bool, device=None) -> bool:
    """OR of a rank-local flag over the process group (without one: the
    flag). An ``all_reduce(MAX)`` of one int on ``device`` (default: the
    current CUDA device under NCCL, else the CPU). Used to agree on a
    SIGTERM flag, which lands on the ranks at different times; every rank
    must call it at the same loop points (it is a collective)."""
    if world_size() == 1:
        return bool(flag)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
