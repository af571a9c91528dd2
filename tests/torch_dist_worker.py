"""One rank of the port's data-parallel checks (``tests/test_torch_distributed.py``).

Started by the test with the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); joins a
gloo group on the CPU and reads ``<dir>/inputs.pt`` (the configs, the
initial weights, the global batches, all written by the test). It runs, on
its rows of each global batch:

- one train step per config of ``inputs["steps"]`` from the initial
  weights (BatchNorm statistics synced), writing the metrics, the
  generator's and discriminator's ``state_dict`` to ``<dir>/<name>.rank<r>.pt``;
- the exact-sort Lovász loss plus the per-image CE of its rows of
  ``inputs["losses"]``, summed over the ranks, and their rows' gradient;
- K1's integer histogram of its rows summed over the ranks and finalized;
- the eval engine over its slices of the validation images;
- a checkpoint saved by rank 0 after the last step and restored by every
  rank into fresh models;
- ``sync_any_flag`` with the flag set on rank 1 only, and on none;

and writes those to ``<dir>/checks.rank<r>.pt``. Imports no JAX.

    python tests/torch_dist_worker.py <dir>
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtda_semanticsegmentation_tpu_torch.data.loader import eval_batches  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.models.factory import build_discriminator, build_model  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.models.layers import sync_batch_norm  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.ops.losses import cross_entropy_with_ignore, lovasz_softmax  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.parallel import create_mesh, ensure_distributed, sync_any_flag  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.train.evaluate import evaluate, make_eval_step  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.train.optim import build_discriminator_tx, build_generator_tx  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState  # noqa: E402
from rtda_semanticsegmentation_tpu_torch.train.steps import make_train_step  # noqa: E402


def build_state(cfg, inputs, mesh=None):
    """G (and D in the adversarial modes) in f64 from the initial weights,
    their optimizers and the step; BatchNorm synced over ``mesh``."""
    model = build_model(cfg.model, device="cpu", train=True).double()
    model.load_state_dict(inputs["g"])
    sync_batch_norm(model, mesh)
    sched = poly_lr_schedule(cfg.optimizer.learning_rate, inputs["max_iter"])
    state = TrainState(model, build_generator_tx(cfg.optimizer, model, decay_exempt=inputs["exempt"]), sched)
    if not cfg.adversarial.enabled:
        return state, make_train_step(cfg, sched, mesh=mesh)
    disc = build_discriminator(cfg.model, device="cpu").double()
    disc.load_state_dict(inputs["d"])
    state.discriminator, state.d_optimizer = disc, build_discriminator_tx(cfg.adversarial, disc)
    state.d_schedule = poly_lr_schedule(cfg.adversarial.disc_learning_rate, inputs["max_iter"])
    return state, make_train_step(cfg, sched, state.d_schedule, mesh=mesh)


def same(a, b) -> bool:
    """Equal nested dicts / lists of tensors and numbers, tensors bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def batch_rows(batch: dict, lo: int, n: int) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + n])) for k, v in batch.items()}


class Frames:
    """An in-memory validation set: ``load(i)`` -> (uint8 HWC frame, labels)."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels
        self.size = images.shape[1:3]

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i], self.labels[i]


def main(out_dir: str) -> None:
    torch.set_num_threads(1)
    joined = ensure_distributed(device="cpu", timeout_s=120.0)
    mesh = create_mesh(device="cpu")
    assert joined and mesh.world == 2
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    r = mesh.rank
    checks = {}
    state = cfg = None
    for name, (cfg, batch) in inputs["steps"].items():
        local = mesh.check_batch(len(batch["image"]))
        state, step = build_state(cfg, inputs, mesh)
        gen = torch.Generator().manual_seed(inputs["aug_seed"])
        state, metrics = step(state, batch_rows(batch, r * local, local), gen)
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                    "g": state.model.state_dict(),
                    "d": None if state.discriminator is None else state.discriminator.state_dict()},
                   os.path.join(out_dir, f"{name}.rank{r}.pt"))

    # the exact-sort Lovász (gathered probabilities) and the CE per image:
    # the ranks' shares summed, and the gradient of the rank's rows
    logits, labels = inputs["losses"]
    local = logits.shape[0] // mesh.world
    mine = logits[r * local:(r + 1) * local].clone().requires_grad_(True)
    lab = labels[r * local:(r + 1) * local]
    share = lovasz_softmax(torch.softmax(mine, dim=1), lab, 255, mesh=mesh) + \
        cross_entropy_with_ignore(mine, lab, 255, "mean_per_image", mesh=mesh)
    share.backward()
    checks["losses"] = {"loss": mesh.sum_(share.detach().clone()), "grad": mine.grad}

    # K1's integer histograms of the ranks' rows, summed
    probas, labels = inputs["hist"]
    local = probas.shape[0] // mesh.world
    raw = klov.lovasz_hist_raw(probas[r * local:(r + 1) * local].contiguous(),
                               labels[r * local:(r + 1) * local].contiguous(), 256, 255)
    checks["hist"] = klov.finalize_hist(mesh.sum_(raw))

    # the eval engine over this rank's slices of the validation images
    val = Frames(*inputs["val"])
    ecfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float64"))
    batches = ((torch.from_numpy(i), torch.from_numpy(lab), torch.from_numpy(v))
               for i, lab, v in eval_batches(val, inputs["eval_batch"], 1, r, mesh.world))
    out = evaluate(make_eval_step(ecfg), state.model, batches, cfg.model.num_classes, mesh=mesh)
    checks["eval"] = {k: out[k] for k in ("hist", "loss", "num_images", "batches")}

    # a checkpoint of the last step's state: rank 0 writes, every rank restores
    ccfg = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_dir=os.path.join(out_dir, "ckpt")))
    ckpt = CheckpointManager(ccfg, run_name="dist", device="cpu", mesh=mesh)
    ckpt.save_periodic(state, 0, 7)
    fresh, _ = build_state(cfg, inputs, mesh)
    restored, meta = ckpt.restore_into(fresh, "latest")
    checks["ckpt"] = {
        "step": restored.step, "meta_epoch": meta["epoch"],
        "g_equal": same(restored.model.state_dict(), state.model.state_dict()),
        "d_equal": same(restored.discriminator.state_dict(), state.discriminator.state_dict()),
        "opt_equal": same(restored.optimizer.state_dict(), state.optimizer.state_dict())
        and same(restored.d_optimizer.state_dict(), state.d_optimizer.state_dict()),
    }

    checks["flag_one"] = sync_any_flag(r == 1)
    checks["flag_none"] = sync_any_flag(False)
    torch.save(checks, os.path.join(out_dir, f"checks.rank{r}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
