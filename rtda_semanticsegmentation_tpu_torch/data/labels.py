"""The 19 Cityscapes trainId classes, their names and colours, and the
RGB -> trainId lookup table of GTA5's colour labels (the port's copy of the
JAX package's ``data/labels.py``)."""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 19
IGNORE_INDEX = 255

# (name, trainId, RGB colour); the order defines trainIds 0..18
_DEFS = (
    ("road", 0, (128, 64, 128)),
    ("sidewalk", 1, (244, 35, 232)),
    ("building", 2, (70, 70, 70)),
    ("wall", 3, (102, 102, 156)),
    ("fence", 4, (190, 153, 153)),
    ("pole", 5, (153, 153, 153)),
    ("traffic light", 6, (250, 170, 30)),
    ("traffic sign", 7, (220, 220, 0)),
    ("vegetation", 8, (107, 142, 35)),
    ("terrain", 9, (152, 251, 152)),
    ("sky", 10, (70, 130, 180)),
    ("person", 11, (220, 20, 60)),
    ("rider", 12, (255, 0, 0)),
    ("car", 13, (0, 0, 142)),
    ("truck", 14, (0, 0, 70)),
    ("bus", 15, (0, 60, 100)),
    ("train", 16, (0, 80, 100)),
    ("motorcycle", 17, (0, 0, 230)),
    ("bicycle", 18, (119, 11, 32)),
)

TRAINID_COLORS = tuple(d[2] for d in _DEFS)

# trainId -> readable name, the ignore id included
CITYSCAPES_ID_TO_NAME = {d[1]: d[0] for d in _DEFS}
CITYSCAPES_ID_TO_NAME[IGNORE_INDEX] = "ignore"

_LUT_CACHE: np.ndarray | None = None


def build_color_to_id_lut() -> np.ndarray:
    """The 256x256x256 uint8 RGB -> trainId table (built once): the 19
    class colours map to their trainIds, every other colour to
    IGNORE_INDEX."""
    global _LUT_CACHE
    if _LUT_CACHE is None:
        lut = np.full((256, 256, 256), IGNORE_INDEX, dtype=np.uint8)
        for _, cid, (r, g, b) in _DEFS:
            lut[r, g, b] = cid
        _LUT_CACHE = lut
    return _LUT_CACHE


def rgb_label_to_train_ids(label_rgb: np.ndarray) -> np.ndarray:
    """An (H, W, 3) uint8 RGB label image -> (H, W) uint8 trainIds; unknown
    colours map to IGNORE_INDEX."""
    if label_rgb.ndim != 3 or label_rgb.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB label, got {label_rgb.shape}")
    lut = build_color_to_id_lut()
    return lut[label_rgb[..., 0], label_rgb[..., 1], label_rgb[..., 2]]


def train_ids_to_rgb(train_ids: np.ndarray) -> np.ndarray:
    """Colorize an (H, W) trainId map to (H, W, 3) uint8 RGB; ignore and
    unknown ids render black."""
    palette = np.zeros((256, 3), dtype=np.uint8)
    palette[:NUM_CLASSES] = TRAINID_COLORS
    return palette[train_ids.astype(np.int64)]
