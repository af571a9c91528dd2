"""Seeded driving-scene stand-ins, made on the device.

A label map is a grid of ``CELL`` x ``CELL`` regions (smaller on frames
too small to hold four regions a class). Every map of one
size holds the same multiset of region classes: each of the 19 Cityscapes
trainIds in proportion to ``SHARES`` (Cityscapes-like: road and building
large, traffic lights and trains rare), at least one region each, and
``IGNORE_SHARE`` of the regions ignore (255). The seed only permutes the
regions, so every seed trains on the same class areas, in another layout.
A frame is 0.6 x its class's palette colour + 0.4 x uniform noise, uint8.
"""

from __future__ import annotations

import math

import torch

# trainId area shares, in trainId order (road, sidewalk, building, wall,
# fence, pole, light, sign, vegetation, terrain, sky, person, rider, car,
# truck, bus, train, motorcycle, bicycle); normalized below
SHARES = (0.33, 0.05, 0.20, 0.006, 0.008, 0.012, 0.002, 0.005, 0.14, 0.01,
          0.035, 0.011, 0.002, 0.06, 0.003, 0.003, 0.001, 0.001, 0.004)
IGNORE_SHARE = 0.10
IGNORE = 255
CELL = 32


def region_classes(n: int, classes: int = 19) -> torch.Tensor:
    """The multiset of ``n`` region classes (ignore included)."""
    shares = torch.tensor(SHARES[:classes], dtype=torch.float64)
    shares = shares / shares.sum() * (1.0 - IGNORE_SHARE) * n
    counts = shares.floor().clamp_min(1).long()
    spare = n - int(round(IGNORE_SHARE * n)) - int(counts.sum())
    # the remainder by largest fraction, so the shares hold as near as regions allow
    order = torch.argsort(shares - shares.floor(), descending=True)
    for i in range(max(spare, 0)):
        counts[order[i % classes]] += 1
    labels = torch.repeat_interleave(torch.arange(classes), counts)
    return torch.cat([labels, torch.full((n - labels.numel(),), IGNORE, dtype=torch.long)])


def make(b: int, h: int, w: int, gen: torch.Generator, classes: int = 19, with_labels: bool = True):
    """``b`` uint8 (H, W, 3) frames and int32 (H, W) label maps."""
    dev = gen.device
    cell = CELL
    while math.ceil(h / cell) * math.ceil(w / cell) < 4 * classes and cell > 1:  # small test frames
        cell //= 2
    gh, gw = math.ceil(h / cell), math.ceil(w / cell)
    pool = region_classes(gh * gw, classes).to(dev)
    keys = torch.rand((b, gh * gw), generator=gen, device=dev)
    grid = pool[keys.argsort(dim=1)].view(b, gh, gw)
    labels = grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)[:, :h, :w]
    palette = torch.randint(0, 256, (classes + 1, 3), generator=gen, device=dev).float()
    colour = palette[torch.where(labels == IGNORE, classes, labels)]
    noise = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev).float()
    frames = (0.6 * colour + 0.4 * noise).round().clamp(0, 255).to(torch.uint8)
    return frames, labels.to(torch.int32) if with_labels else None
