"""Checkpoints on ``torch.save`` (port of the JAX package's
``train/checkpoint.py``, which writes Orbax pytrees), with the same policy:

- two streams, ``best`` (saved when the validation mIoU improves, with the
  per-class IoUs) and ``latest`` (every N epochs), each keeping one file;
- a checkpoint holds G's (and D's) ``state_dict`` and optimizer state, the
  step, the best mIoU, the epoch, the per-class IoUs and the saving run's
  target-stream rate (``host_batches_per_epoch``);
- a run resumes at ``epoch + 1``; a vanilla run restores G from an
  adversarial checkpoint; an adversarial run refuses a vanilla one.

Layout: ``<checkpoint_dir>/<run_name or model[_adversarial_GTA2City]>/
<stream name>/checkpoint.pt``. A write goes to a temporary file that
``os.replace`` then puts in place, so a reader never sees half a file.
Saves are synchronous: :meth:`CheckpointManager.wait` has nothing to wait
for. A restore maps the tensors onto the run's device. Data parallel (a
``mesh``): the ranks hold the same state, so rank 0 writes and every rank
waits at a barrier until the file is in place; each rank restores onto its
own device. Tensor parallel (``parallel/tp.py``): every rank first gathers
the sharded kernels and their moments whole (``tp.gather_state``), so rank
0 writes the full tensors and the file is the one a single process
writes; a restore gives each rank its slices (``tp.load_state``). A
checkpoint moves between layouts, and serves, unchanged. The BatchNorm
running statistics are rank 0's.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..models.factory import eval_variables
from ..parallel import tp
from .state import TrainState

FILENAME = "checkpoint.pt"


def _state_tree(state: TrainState, epoch: int, per_class_ious=None, host_batches_per_epoch: int = 0) -> dict:
    return {
        "epoch": int(epoch),
        "step": int(state.step),
        "best_miou": float(state.best_miou),
        "host_batches_per_epoch": int(host_batches_per_epoch),
        "per_class_ious": None if per_class_ious is None else torch.as_tensor(
            np.asarray(per_class_ious, np.float64)),
        **tp.gather_state(state),
    }


class CheckpointManager:
    """The best and latest checkpoint streams of one run, and resume."""

    def __init__(self, cfg: ExperimentConfig, run_name: str = "", device="cpu", mesh=None):
        suffix = "_adversarial_GTA2City" if cfg.adversarial.enabled else ""
        name = run_name or f"{cfg.model.name}{suffix}"
        self.root = os.path.abspath(os.path.join(cfg.train.checkpoint_dir, name))
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self._streams = {"best": cfg.train.best_checkpoint_name, "latest": cfg.train.periodic_checkpoint_name}
        for d in (self.best_dir, self.latest_dir):  # both streams exist from the start, as Orbax's
            os.makedirs(d, exist_ok=True)

    @property
    def best_dir(self) -> str:
        return os.path.join(self.root, self._streams["best"])

    @property
    def latest_dir(self) -> str:
        return os.path.join(self.root, self._streams["latest"])

    def _stream_dir(self, which: str) -> str:
        if which not in ("latest", "best"):
            raise ValueError(f"checkpoint stream must be 'latest' or 'best', got {which!r} "
                             f"(streams live under {self.root})")
        return self.best_dir if which == "best" else self.latest_dir

    # -- save ---------------------------------------------------------------

    def _write(self, directory: str, tree: dict) -> None:
        if self.mesh is None or self.mesh.is_main:
            path = os.path.join(directory, FILENAME)
            tmp = f"{path}.tmp-{os.getpid()}"
            try:
                torch.save(tree, tmp)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        if self.mesh is not None:
            self.mesh.barrier()

    def save_best(self, state: TrainState, epoch: int, per_class_ious, host_batches_per_epoch: int = 0) -> None:
        self._write(self.best_dir, _state_tree(state, epoch, per_class_ious, host_batches_per_epoch))

    def save_periodic(self, state: TrainState, epoch: int, host_batches_per_epoch: int = 0) -> None:
        """Overwrite the rolling 'latest' checkpoint."""
        self._write(self.latest_dir, _state_tree(state, epoch, None, host_batches_per_epoch))

    def wait(self) -> None:
        """Saves are synchronous; nothing is in flight."""

    def close(self) -> None:
        self.wait()

    # -- restore ------------------------------------------------------------

    def _load(self, path: str) -> Optional[Dict[str, Any]]:
        if not os.path.isfile(path):
            return None
        return torch.load(path, map_location=self.device, weights_only=True)

    def restore_into(self, state: TrainState, which: str = "latest") -> Optional[tuple]:
        """Load a stream's checkpoint into ``state`` (in place); returns
        ``(state, meta)``, or None when the stream has no checkpoint.
        ``meta``: ``epoch`` (resume at ``epoch + 1``), ``best_miou``,
        ``host_batches_per_epoch`` and ``per_class_ious`` (None unless a
        best checkpoint carried them)."""
        tree = self._load(os.path.join(self._stream_dir(which), FILENAME))
        return None if tree is None else self._apply(state, tree)

    def restore_from_path(self, state: TrainState, path: str) -> Optional[tuple]:
        """Resume from any location: a run root holding stream directories
        (``latest`` preferred), one stream's directory, or a checkpoint
        file. Returns ``(state, meta)`` or None if nothing is there."""
        candidates = [os.path.join(path, s, FILENAME) for s in (self._streams["latest"], self._streams["best"])]
        candidates += [os.path.join(path, FILENAME), path]
        for p in candidates:
            tree = self._load(p)
            if tree is not None:
                return self._apply(state, tree)
        return None

    def _apply(self, state: TrainState, tree: dict) -> tuple:
        if state.discriminator is not None and "discriminator" not in tree:
            raise ValueError("adversarial resume needs an adversarial checkpoint; the restored "
                             "checkpoint has no discriminator state")
        tp.load_state(state, tree)
        state.step = int(tree["step"])
        state.best_miou = float(tree["best_miou"])
        ious = tree.get("per_class_ious")
        meta = {
            "epoch": int(tree["epoch"]),
            "best_miou": float(tree["best_miou"]),
            "host_batches_per_epoch": int(tree.get("host_batches_per_epoch", 0) or 0),
            "per_class_ious": None if ious is None else ious.cpu().numpy(),
        }
        return state, meta

    def restore_variables(self, which: str = "best") -> Optional[tuple]:
        """G's eval variables (its ``state_dict`` without the train-only aux
        heads) for serving, and ``meta`` (``epoch``, ``best_miou``,
        ``step``); None when the stream is empty. Works for checkpoints of
        every train mode and optimizer."""
        tree = self._load(os.path.join(self._stream_dir(which), FILENAME))
        if tree is None:
            return None
        meta = {"epoch": int(tree["epoch"]), "best_miou": float(tree["best_miou"]), "step": int(tree["step"])}
        return eval_variables(tree["generator"]), meta
