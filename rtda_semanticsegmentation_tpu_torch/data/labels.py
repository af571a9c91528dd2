"""The 19 Cityscapes trainId classes and their colours (the part of the JAX
package's ``data/labels.py`` the predict CLI needs)."""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 19
IGNORE_INDEX = 255

# trainId order: road, sidewalk, building, wall, fence, pole, traffic light,
# traffic sign, vegetation, terrain, sky, person, rider, car, truck, bus,
# train, motorcycle, bicycle
TRAINID_COLORS = (
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156), (190, 153, 153),
    (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35), (152, 251, 152),
    (70, 130, 180), (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
    (0, 60, 100), (0, 80, 100), (0, 0, 230), (119, 11, 32),
)


def train_ids_to_rgb(train_ids: np.ndarray) -> np.ndarray:
    """Colorize an (H, W) trainId map to (H, W, 3) uint8 RGB; ignore and
    unknown ids render black."""
    palette = np.zeros((256, 3), dtype=np.uint8)
    palette[:NUM_CLASSES] = TRAINID_COLORS
    return palette[train_ids.astype(np.int64)]
