"""Metric logging with the reference's W&B key surface (the port's copy of
the JAX package's ``obs/logging.py``).

Backends:

- ``wandb``  — same project/run-config/metric-key layout as the reference
  (``utils.py:120-207`` init, batch scalars every PRINT_FREQ steps keyed to
  global_step, ``val/*`` epoch scalars, ``val_iou_per_class/iou_<name>``,
  summary dict). Degrades to a warning if the SDK or network is absent —
  parity with the reference's try/except-disable (``utils.py:206-207``).
- ``jsonl``  — offline structured logging: one JSON object per ``log`` call
  appended to ``<log_dir>/<run_name>.jsonl``. The zero-egress default.
- ``null``   — drop everything (benchmarks).
- ``auto``   — wandb if importable and WANDB_API_KEY/mode allows, else jsonl.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from ..config import ExperimentConfig
from ..data.labels import CITYSCAPES_ID_TO_NAME


class MetricLogger:
    """Facade over the chosen backend; every method is a safe no-op on
    backend failure."""

    def __init__(self, cfg: ExperimentConfig, backend: str, run_name: str):
        self.cfg = cfg
        self.backend = backend
        self.run_name = run_name
        self._wandb = None
        self._file = None
        if backend == "wandb":
            self._init_wandb()
        elif backend == "jsonl":
            self._init_jsonl()

    # -- init ---------------------------------------------------------------

    def _run_config(self) -> Dict[str, Any]:
        """Run-config dict, same content the reference assembles
        (``utils.py:127-172``): model/optimizer/aug/adversarial knobs."""
        c = self.cfg
        out = {
            "model_name": c.model.name,
            "context_path": c.model.context_path,
            "num_classes": c.model.num_classes,
            "epochs": c.train.epochs,
            "batch_size": c.train.batch_size,
            "optimizer": c.optimizer.name,
            "learning_rate": c.optimizer.learning_rate,
            "weight_decay": c.optimizer.weight_decay,
            "augmentation_pipeline": c.augment.pipeline,
            "use_lovasz": c.loss.use_lovasz,
            "lovasz_weight": c.loss.lovasz_weight,
            "seed": c.train.seed,
            "compute_dtype": c.model.compute_dtype,
            "train_mode": c.train_mode,
        }
        if c.adversarial.enabled:
            out.update(
                {
                    "adversarial": True,
                    "lambda_adv": c.adversarial.lambda_adv,
                    "disc_learning_rate": c.adversarial.disc_learning_rate,
                }
            )
        return out

    def _init_wandb(self) -> None:
        try:
            import wandb

            self._wandb = wandb.init(
                project=self.cfg.obs.project,
                entity=self.cfg.obs.entity or None,
                name=self.run_name,
                config=self._run_config(),
            )
        except Exception as e:  # same degrade-to-disabled as the reference
            print(f"W&B unavailable ({e}); falling back to jsonl logging")
            self._wandb = None
            self._init_jsonl()

    def _init_jsonl(self) -> None:
        os.makedirs(self.cfg.obs.log_dir, exist_ok=True)
        path = os.path.join(self.cfg.obs.log_dir, f"{self.run_name}.jsonl")
        self._file = open(path, "a", buffering=1)
        self._emit({"event": "run_config", **self._run_config()})

    # -- logging ------------------------------------------------------------

    def _emit(self, obj: Dict[str, Any]) -> None:
        if self._file is not None:
            obj.setdefault("ts", round(time.time(), 3))
            self._file.write(json.dumps(obj, default=float) + "\n")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        """Scalar metrics keyed to the global step (reference
        ``train.py:144-154`` batch logging / ``validation.py:145-154``)."""
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._wandb is not None:
            try:
                self._wandb.log(metrics, step=step)
                return
            except Exception:
                pass
        self._emit({"event": "metrics", "step": int(step), **metrics})

    def log_validation(
        self,
        miou: float,
        loss: float,
        per_class_ious: np.ndarray,
        step: int,
        prefix: str = "val",
    ) -> None:
        """``val/mIoU``, ``val/epoch_loss`` and per-class IoUs by class name
        (reference ``validation.py:145-154``)."""
        metrics = {f"{prefix}/mIoU": miou, f"{prefix}/epoch_loss": loss}
        for cid, iou in enumerate(np.asarray(per_class_ious)):
            name = CITYSCAPES_ID_TO_NAME.get(cid, str(cid)).replace(" ", "_")
            metrics[f"{prefix}_iou_per_class/iou_{name}"] = float(iou)
        self.log(metrics, step)

    def log_segmentation_images(
        self,
        image_u8: np.ndarray,
        label: np.ndarray,
        pred: np.ndarray,
        step: int,
        tag: str = "val/predictions",
    ) -> None:
        """GT/pred mask overlays (reference ``utils.py:210-288``). W&B gets
        wandb.Image masks; jsonl gets PNGs written next to the log."""
        if self._wandb is not None:
            try:
                import wandb

                class_labels = {
                    int(k): v for k, v in CITYSCAPES_ID_TO_NAME.items()
                }
                self._wandb.log(
                    {
                        tag: wandb.Image(
                            image_u8,
                            masks={
                                "ground_truth": {
                                    "mask_data": label,
                                    "class_labels": class_labels,
                                },
                                "prediction": {
                                    "mask_data": pred,
                                    "class_labels": class_labels,
                                },
                            },
                        )
                    },
                    step=step,
                )
                return
            except Exception:
                pass
        if self._file is not None:
            from PIL import Image

            from ..data.labels import train_ids_to_rgb

            img_dir = os.path.join(
                self.cfg.obs.log_dir, f"{self.run_name}_images"
            )
            os.makedirs(img_dir, exist_ok=True)
            panel = np.concatenate(
                [image_u8, train_ids_to_rgb(label), train_ids_to_rgb(pred)],
                axis=1,
            )
            path = os.path.join(img_dir, f"step{step}_{tag.replace('/', '_')}.png")
            Image.fromarray(panel.astype(np.uint8)).save(path)
            self._emit({"event": "image", "step": int(step), "path": path})

    def save_dir(self, path: str) -> None:
        """Mirror a checkpoint directory to the W&B run (reference
        ``utils.py:404-410`` ``wandb.save(..., policy="live")``).

        A checkpoint stream is a directory, so every file under ``path`` is
        registered with its relative structure preserved. No-op on the
        jsonl/null backends (a jsonl 'artifact' event records the path so
        offline runs still have the audit trail)."""
        if self._wandb is not None:
            try:
                import wandb

                base = os.path.dirname(os.path.abspath(path))
                wandb.save(
                    os.path.join(os.path.abspath(path), "**"),
                    base_path=base,
                    policy="live",
                )
                return
            except Exception:
                pass
        self._emit({"event": "artifact", "path": os.path.abspath(path)})

    def summary(self, data: Dict[str, Any]) -> None:
        """End-of-run summary (reference ``main.py:570-592``)."""
        if self._wandb is not None:
            try:
                for k, v in data.items():
                    self._wandb.summary[k] = v
                return
            except Exception:
                pass
        self._emit({"event": "summary", **{k: v for k, v in data.items()}})

    def finish(self) -> None:
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception:
                pass
        if self._file is not None:
            self._file.close()
            self._file = None


def make_logger(cfg: ExperimentConfig, run_name: Optional[str] = None) -> MetricLogger:
    backend = cfg.obs.backend
    run_name = run_name or cfg.obs.run_name or f"{cfg.model.name}_{cfg.train_mode}"
    if backend == "auto":
        try:
            import wandb  # noqa: F401

            backend = "wandb" if os.environ.get("WANDB_API_KEY") else "jsonl"
        except ImportError:
            backend = "jsonl"
    if backend == "null":
        logger = MetricLogger.__new__(MetricLogger)
        logger.cfg, logger.backend, logger.run_name = cfg, "null", run_name
        logger._wandb = logger._file = None
        return logger
    return MetricLogger(cfg, backend, run_name)
