"""Segmentation metrics (port of the JAX package's ``ops/metrics.py``).

The confusion matrix is an int64 ``torch.bincount`` on the tensors' device,
exact to 2^63 per cell. The JAX package counts in int32 on the device and
flushes into an int64 host histogram before a cell could reach 2^31
(``train/evaluate.py``); with int64 counts on the device the port needs no
flush and brings the histogram to the host once per evaluation.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``hist[i, j]`` = the number of pixels of true label ``i`` predicted
    ``j``, an int64 (num_classes, num_classes) tensor. Pixels whose label or
    prediction lies outside [0, num_classes) are dropped (the ignore label
    255 among them). Any shape, integer dtypes."""
    labels = labels.reshape(-1).long()
    preds = preds.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_classes) & (preds >= 0) & (preds < num_classes)
    # invalid pixels go to an overflow bin past the C*C cells, sliced away:
    # a boolean mask would make the length data-dependent (a host sync)
    index = torch.where(valid, labels * num_classes + preds, num_classes * num_classes)
    counts = torch.bincount(index, minlength=num_classes * num_classes + 1)
    return counts[: num_classes * num_classes].reshape(num_classes, num_classes)


def per_class_iou(hist: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Per-class IoU = TP / (TP + FP + FN + epsilon), NaN -> 0; in f64 for an
    int64 or f64 histogram, else f32 (as the JAX function)."""
    wide = hist.dtype in (torch.int64, torch.float64)
    hist = hist.to(torch.float64 if wide else torch.float32)
    tp = torch.diagonal(hist)
    ious = tp / (hist.sum(dim=1) + hist.sum(dim=0) - tp + epsilon)
    return torch.nan_to_num(ious, nan=0.0)


def per_class_iou_np(hist, epsilon: float = 1e-5) -> np.ndarray:
    """Host float64 per-class IoU, exact for int64 histograms; the same
    epsilon and NaN -> 0 as :func:`per_class_iou`."""
    hist = np.asarray(hist, np.float64)
    tp = np.diag(hist)
    denom = hist.sum(axis=1) + hist.sum(axis=0) - tp + epsilon
    with np.errstate(invalid="ignore"):
        ious = tp / denom
    return np.nan_to_num(ious, nan=0.0)


def mean_iou(hist: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """The mean over classes of :func:`per_class_iou` (an absent class
    scores 0, which equals the reference's ``nanmean``)."""
    return per_class_iou(hist, epsilon).mean()
