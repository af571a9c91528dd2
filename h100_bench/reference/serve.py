"""The reference serving forward: uint8 frames -> ImageNet normalization ->
the eval forward (running statistics) -> logits at the input size, in
float32 with TF32 off; and the BatchNorm statistics of a batch, which the
benchmark's serving weights take as their running statistics."""

from __future__ import annotations

import torch

from .augment import normalize
from .nets import generator
from .ops import no_tf32


@torch.no_grad()
def logits(cfg: dict, weights: dict, frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, classes, H, W) float32 logits of (B, H, W, 3) uint8 frames."""
    with no_tf32():
        x = normalize(frames_u8.float() / 255.0, cfg["augment"]).permute(0, 3, 1, 2).contiguous()
        P = {k: v.float() for k, v in weights.items()}
        return generator(cfg["model"], P, x, False, P)


@torch.no_grad()
def batch_statistics(cfg: dict, weights: dict, frames_u8: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics in ``weights`` to those of
    a train-mode forward over ``frames_u8``, so that the eval forward
    normalizes its activations as a trained model's would."""
    with no_tf32():
        x = normalize(frames_u8.float() / 255.0, cfg["augment"]).permute(0, 3, 1, 2).contiguous()
        generator(cfg["model"], weights, x, True, weights, momentum=0.0)
