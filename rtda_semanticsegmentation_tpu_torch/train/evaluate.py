"""The validation engine (port of the JAX package's ``train/evaluate.py``).

An eval step normalizes a uint8 batch, runs the eval forward, and returns
the batch's int64 confusion matrix, the sum over its valid images of each
image's CE mean (the reference's batch-1 loss, kept under batching) and the
number of valid images, all on the device. :func:`evaluate` adds them up on
the device, brings them to the host once, and computes the IoUs there in
f64. The histogram is int64 from the start (``ops/metrics.py``), so no
flush to the host is needed before a cell could overflow. Data parallel
(a ``mesh``): each data index evaluates its slice of every batch
(``data/loader.py::eval_batches``) and the data group's histograms, loss
sums and image counts are summed before the IoUs; the ranks of a model
group (tensor parallel) evaluate the same slice together.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from ..config import ExperimentConfig
from ..ops.augment import normalize_u8
from ..ops.losses import cross_entropy_with_ignore
from ..ops.metrics import confusion_matrix, per_class_iou_np


def apply_model(model: torch.nn.Module, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """The eval forward of a port model on NCHW ``x``: NCHW logits, the
    BatchNorms on their running statistics."""
    model.train(train)
    return model(x)


def make_eval_step(cfg: ExperimentConfig, apply_fn: Callable = apply_model):
    """``eval_step(variables, images_u8, labels, img_valid) -> (hist,
    loss_sum, count)``.

    ``apply_fn(variables, x, train)`` maps NCHW images in the compute dtype
    to NCHW logits; ``variables`` is what it takes (the model, for
    :func:`apply_model`). ``images_u8`` is (B, H, W, 3) uint8, ``labels``
    (B, H, W) and ``img_valid`` a (B,) bool mask, False for the padding
    images of the last batch: their pixels are left out of the histogram and
    of the loss. Returns the int64 (C, C) histogram, the f32 sum over valid
    images of each image's CE mean and the f32 number of valid images."""
    num_classes = cfg.model.num_classes
    ignore = cfg.loss.ignore_index
    compute_dtype = getattr(torch, cfg.model.compute_dtype)

    @torch.no_grad()
    def eval_step(variables, images_u8, labels, img_valid):
        x = normalize_u8(images_u8, cfg.augment).to(compute_dtype).permute(0, 3, 1, 2)
        logits = apply_fn(variables, x, False)
        labels = torch.where(img_valid[:, None, None], labels.long(), ignore)
        b = labels.shape[0]
        pixel = cross_entropy_with_ignore(logits, labels, ignore, reduction="none").float()
        valid_px = (labels != ignore).reshape(b, -1).sum(1)
        per_img = pixel.reshape(b, -1).sum(1) / valid_px.clamp_min(1)
        loss_sum = torch.where(img_valid, per_img, 0.0).sum()
        preds = torch.argmax(logits, dim=1)
        hist = confusion_matrix(labels, preds, num_classes)
        return hist, loss_sum, img_valid.sum().float()

    return eval_step


def evaluate(eval_step: Callable, variables, batches: Iterable, num_classes: int = 19, mesh=None) -> Dict[str, object]:
    """Run ``eval_step`` over ``(images_u8, labels, img_valid)`` batches
    (with a ``mesh``: this rank's slices, every rank the same number).

    Returns ``miou``, ``loss`` (the mean over valid images), ``per_class_iou``
    (f64 numpy), ``hist`` (int64 numpy), ``num_images`` and ``batches``, of
    all ranks together."""
    hist = loss_sum = count = None
    n = 0
    for images_u8, labels, img_valid in batches:
        h, ls, c = eval_step(variables, images_u8, labels, img_valid)
        if hist is None:
            hist, loss_sum, count = h, ls, c
        else:
            hist, loss_sum, count = hist + h, loss_sum + ls, count + c
        n += 1
    if hist is not None and mesh is not None and mesh.data_size > 1:
        hist = mesh.sum_(hist)
        loss_sum, count = mesh.sum_(torch.stack([loss_sum, count]).to(torch.float64))
    if hist is None:
        hist_np = np.zeros((num_classes, num_classes), np.int64)
        loss, images = 0.0, 0.0
    else:
        hist_np = hist.cpu().numpy()
        loss_sum, count = float(loss_sum), float(count)
        loss, images = loss_sum / max(count, 1.0), count
    ious = per_class_iou_np(hist_np)
    return {
        "miou": float(ious.mean()),
        "loss": loss,
        "per_class_iou": ious,
        "hist": hist_np,
        "num_images": images,
        "batches": n,
    }
