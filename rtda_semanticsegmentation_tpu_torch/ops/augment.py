"""Input normalization of the serving path (port of the JAX
``ops/augment.py::normalize`` / ``normalize_u8``; the train-time
augmentation pipeline is not ported yet)."""

from __future__ import annotations

import torch

from ..config import AugmentConfig


def normalize(images: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """ImageNet normalization of [0, 1] float images, channels last, in the
    images' own float dtype floored at f32."""
    dt = torch.promote_types(images.dtype, torch.float32)
    mean = torch.tensor(cfg.norm_mean, dtype=dt, device=images.device)
    std = torch.tensor(cfg.norm_std, dtype=dt, device=images.device)
    return (images.to(dt) - mean) / std


def normalize_u8(images_u8: torch.Tensor, cfg: AugmentConfig, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalized float NHWC (the eval / no-aug path)."""
    return normalize(images_u8.to(dtype) / 255.0, cfg)
