"""One rank of the port's tensor-parallel checks (``tests/test_torch_tp.py``).

Started by the test with the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); joins a
gloo group on the CPU with a ``(data, model)`` layout of ``model`` ranks a
model group and reads ``<dir>/inputs.pt`` (the configs, the initial
weights, the global batches, all written by the test). For each config of
``inputs["steps"]`` it builds the state from the initial weights, shards it
(``parallel.shard_state`` at ``inputs["min_channels"]``), runs one step on
its data index's rows of the global batch and writes
``<dir>/<name>.<layout>.rank<r>.pt``: the metrics, the names of its
sharded convs, the digests of the whole G and D it gathers
(``tp.full_state_dict``) and of its own replicated tensors (every
parameter and buffer but the sharded kernels), and on rank 0 the whole G
and D. Then, on the last state, to ``<dir>/checks.<layout>.rank<r>.pt``:

- K1's histograms of its data index's rows of ``inputs["hist"]`` through
  the binned Lovász loss's path (``ops/losses.py::lovasz_histograms``:
  the integer sums added over the data group, finalized once);
- with ``<layout>`` in ``inputs["ckpt_layouts"]``, a checkpoint saved by
  rank 0 to ``<dir>/ckpt.<layout>`` and restored into a fresh sharded
  state: whether it equals the state it saved, bit for bit, model and
  optimizer.

Imports no JAX.

    python tests/torch_tp_worker.py <dir> <model>
"""

import dataclasses
import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_dist_worker import batch_rows, build_state, same  # noqa: E402

from rtda_semanticsegmentation_tpu_torch.config import MeshConfig  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.ops.losses import lovasz_histograms  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.parallel import create_mesh, ensure_distributed, shard_state, tp  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402


def sharded_state(cfg, inputs, mesh):
    state, step = build_state(cfg, inputs, mesh)
    return shard_state(state, mesh, inputs["min_channels"]), step


def digests(state_dict) -> dict:
    """name -> SHA-256 of the tensor's bytes."""
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in state_dict.items()}


def local_replicated(module) -> dict:
    """Digests of this rank's parameters and buffers other than the sharded kernels."""
    skip = {f"{n}.weight" for n in tp.sharded_convs(module)}
    return digests({k: v for k, v in module.state_dict().items() if k not in skip})


def main(out_dir: str, model: int) -> None:
    torch.set_num_threads(1)
    joined = ensure_distributed(device="cpu", timeout_s=120.0)
    mesh = create_mesh(MeshConfig(model=model), device="cpu")
    assert joined and mesh.model_size == model
    layout = f"d{mesh.data_size}m{model}"
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    r = mesh.rank
    state = cfg = None
    for name, (cfg, batch) in inputs["steps"].items():
        local = mesh.check_batch(len(batch["image"]))
        state, step = sharded_state(cfg, inputs, mesh)
        gen = torch.Generator().manual_seed(inputs["aug_seed"])
        state, metrics = step(state, batch_rows(batch, mesh.data_rank * local, local), gen)
        d = state.discriminator
        g_full = tp.full_state_dict(state.model)
        d_full = None if d is None else tp.full_state_dict(d)
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                    "sharded": {"g": sorted(tp.sharded_convs(state.model)),
                                "d": None if d is None else sorted(tp.sharded_convs(d))},
                    "g": g_full if mesh.is_main else None,
                    "d": d_full if mesh.is_main else None,
                    "digests": {"g": digests(g_full), "d": None if d is None else digests(d_full),
                                "g_local": local_replicated(state.model),
                                "d_local": None if d is None else local_replicated(d)}},
                   os.path.join(out_dir, f"{name}.{layout}.rank{r}.pt"))

    checks = {}
    # K1's histograms of the data index's rows through the binned loss's
    # path: the integer sums added over the data group
    probas, labels = inputs["hist"]
    local = probas.shape[0] // mesh.data_size
    rows = slice(mesh.data_rank * local, (mesh.data_rank + 1) * local)
    checks["hist"] = lovasz_histograms(probas[rows].contiguous(), labels[rows].contiguous(), 256, 255, mesh)

    if layout in inputs["ckpt_layouts"]:
        checks["ckpt"] = checkpoint_round_trip(cfg, inputs, mesh, state, os.path.join(out_dir, f"ckpt.{layout}"))
    torch.save(checks, os.path.join(out_dir, f"checks.{layout}.rank{r}.pt"))
    torch.distributed.destroy_process_group()


def checkpoint_round_trip(cfg, inputs, mesh, state, directory: str) -> dict:
    """``state`` gathered and written by rank 0 under ``directory``, then
    restored by every rank into a fresh sharded state: its step, and
    whether model and optimizers equal ``state``'s bit for bit."""
    ccfg = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_dir=directory))
    ckpt = CheckpointManager(ccfg, run_name="tp", device="cpu", mesh=mesh)
    ckpt.save_periodic(state, 0, 7)
    fresh, _ = sharded_state(cfg, inputs, mesh)
    restored, _ = ckpt.restore_into(fresh, "latest")
    return {
        "step": restored.step,
        "equal": same(restored.model.state_dict(), state.model.state_dict())
        and same(restored.optimizer.state_dict(), state.optimizer.state_dict())
        and same(restored.discriminator.state_dict(), state.discriminator.state_dict())
        and same(restored.d_optimizer.state_dict(), state.d_optimizer.state_dict()),
    }


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
