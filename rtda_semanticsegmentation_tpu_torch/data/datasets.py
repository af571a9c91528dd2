"""Dataset sources: path pairing, PNG decode, host-side resize (the port's
copy of the JAX package's ``data/datasets.py``).

The host decodes and resizes to the static train size and emits uint8 HWC
images and int32 trainId labels; normalization and augmentation run on the
device inside the train step.

- Cityscapes: ``images/<split>/**/*.png`` paired with
  ``gtFine/<split>/**/*_gtFine_labelTrainIds.png``, sorted.
- GTA5: ``images/*.png`` paired with the same name in a labels subdir,
  pre-converted grayscale trainIds or RGB colours converted on the fly.
- Synthetic: label-correlated frames generated from a seed, the same bits
  as the JAX package's for the same seed and index.

Two host decodes with identical results (``tests/test_torch_native_data.py``):
the native C++ one (``data/native.py``, one GIL-released decode + resize
call per file, bit-exact with PIL's BILINEAR / NEAREST) and PIL.
``native_decode`` is ``'auto'`` (native when the library builds, else PIL
with a warning), ``'on'`` (native or raise) or ``'off'`` (PIL).
``decoded_cache_dir`` wraps a file dataset in the decoded-sample disk cache
(``data/cache.py``).
"""

from __future__ import annotations

import os
import warnings
from typing import List, Tuple

import numpy as np

from .labels import IGNORE_INDEX, NUM_CLASSES, rgb_label_to_train_ids


def _resize_pair(img: np.ndarray, label: np.ndarray, size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Resize to (H, W): the image bilinear, the label nearest."""
    from PIL import Image

    h, w = size
    if img.shape[:2] != (h, w):
        img = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    if label.shape[:2] != (h, w):
        label = np.asarray(Image.fromarray(label).resize((w, h), Image.NEAREST))
    return img, label


def _decode_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class SegmentationDataset:
    """A list of (image_path, label_path) pairs and their decode: native
    or PIL, by ``native_decode``."""

    pairs: List[Tuple[str, str]]
    size: Tuple[int, int]  # (H, W)
    native_decode: str = "auto"

    def __len__(self) -> int:
        return len(self.pairs)

    def _native(self):
        """The native module if enabled and available, else None; raises
        under ``'on'`` with the build's reason."""
        mode = self.native_decode
        if mode == "off":
            return None
        from . import native

        if native.available():
            return native
        if mode == "on":
            raise RuntimeError(f"native_decode='on' but the fast path is unavailable: {native.unavailable_reason()}")
        return None

    def _decode_label(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            if im.mode not in ("L", "P", "I", "I;16"):
                warnings.warn(f"label {path} has mode {im.mode}; converting to L")
                im = im.convert("L")
            arr = np.asarray(im)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr

    def load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 HWC image, int32 HW trainId label) at ``size``."""
        img_path, label_path = self.pairs[index]
        nat = self._native()
        if nat is not None:
            try:
                return nat.load_image(img_path, self.size), nat.load_label(label_path, self.size)
            except OSError:
                pass  # odd format (e.g. an RGB-mode or 16-bit label): PIL below
        img, label = _resize_pair(_decode_image(img_path), self._decode_label(label_path), self.size)
        if label.ndim != 2:
            raise ValueError(f"label for {img_path} is not 2D after load: {label.shape}")
        return img, label.astype(np.int32)


class CityscapesDataset(SegmentationDataset):
    """Cityscapes with pre-generated ``*_gtFine_labelTrainIds.png`` labels."""

    def __init__(self, root: str, split: str, size: Tuple[int, int], native_decode: str = "auto"):
        self.root, self.split, self.size = root, split, tuple(size)
        self.native_decode = native_decode
        image_root = os.path.join(root, "images", split)
        if not os.path.isdir(image_root):
            raise FileNotFoundError(f"Cityscapes image directory not found: {image_root}")
        paths = []
        for dirpath, _, files in sorted(os.walk(image_root)):
            paths.extend(os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".png"))
        # the label path is the image's path relative to the image root, under
        # the label root, with the file name's suffix substituted
        label_root = os.path.join(root, "gtFine", split)
        self.pairs = []
        missing = 0
        for p in paths:
            rel = os.path.relpath(p, image_root)
            lp = os.path.join(label_root, rel.replace("_leftImg8bit", "_gtFine_labelTrainIds"))
            if os.path.exists(lp):
                self.pairs.append((p, lp))
            else:
                missing += 1
        if missing:
            warnings.warn(f"{missing} Cityscapes images under {image_root} have no matching "
                          f"label under {label_root}; skipping them")
        if not self.pairs:
            raise FileNotFoundError(f"no image/label pairs under {image_root} / {label_root}")


class GTA5Dataset(SegmentationDataset):
    """GTA5 with same-name labels in ``labels_subdir``."""

    def __init__(self, root: str, labels_subdir: str = "labels_trainids", convert_on_the_fly: bool = False,
                 size: Tuple[int, int] = (720, 1280), native_decode: str = "auto"):
        self.root, self.size = root, tuple(size)
        self.native_decode = native_decode
        self.convert_on_the_fly = convert_on_the_fly
        image_root = os.path.join(root, "images")
        label_root = os.path.join(root, labels_subdir)
        for d in (image_root, label_root):
            if not os.path.isdir(d):
                raise FileNotFoundError(f"GTA5 directory not found: {d}")
        self.pairs = []
        for dirpath, _, files in sorted(os.walk(image_root)):
            for f in sorted(files):
                if not f.endswith(".png"):
                    continue
                lp = os.path.join(label_root, f)
                if os.path.exists(lp):
                    self.pairs.append((os.path.join(dirpath, f), lp))
                else:
                    warnings.warn(f"label not found for {f}, expected {lp}")
        if not self.pairs:
            raise FileNotFoundError(f"no image-label pairs under {root}")

    def load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self.convert_on_the_fly:
            return super().load(index)
        img_path, label_path = self.pairs[index]
        nat = self._native()
        if nat is not None:
            from .labels import build_color_to_id_lut

            try:
                return (nat.load_image(img_path, self.size),
                        nat.load_label(label_path, self.size, rgb_lut=build_color_to_id_lut()))
            except OSError:
                pass
        label = rgb_label_to_train_ids(_decode_image(label_path))
        img, label = _resize_pair(_decode_image(img_path), label, self.size)
        return img, label.astype(np.int32)


class SyntheticDataset(SegmentationDataset):
    """In-memory synthetic data: class-coded colours plus noise, so a run on
    it learns. Sample ``index`` draws from ``RandomState(seed * 100003 +
    index)``, as the JAX package's does."""

    def __init__(self, length: int = 64, size: Tuple[int, int] = (64, 64), num_classes: int = NUM_CLASSES,
                 seed: int = 0):
        self.length, self.size, self.num_classes = length, tuple(size), num_classes
        self.seed = seed
        self.pairs = [("<synthetic>", "<synthetic>")] * length

    def __len__(self) -> int:
        return self.length

    def load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        h, w = self.size
        rng = np.random.RandomState(self.seed * 100003 + index)
        k = min(4, self.num_classes)
        label = np.zeros((h, w), np.int32)
        label[h // 2:, :] = 1 % k
        label[:, w // 2:] += 2 % (k + 1)
        label = label % self.num_classes
        base = (label * (200 // max(k, 1))).astype(np.uint8)
        img = np.stack([base] * 3, -1) + rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
        label[0, :] = IGNORE_INDEX  # ignore pixels, as real labels have
        return img, label


def build_dataset(name: str, split: str, size: Tuple[int, int], data_cfg) -> SegmentationDataset:
    """The dataset ``name`` (cityscapes | gta5 | synthetic) at ``size``.

    ``data_cfg.decoded_cache_dir`` wraps the file datasets in the
    decoded-sample disk cache (``data/cache.py``); synthetic data is
    generated, never cached."""
    native_mode = getattr(data_cfg, "native_decode", "auto")
    if name == "cityscapes":
        ds = CityscapesDataset(data_cfg.cityscapes_path, split, size, native_decode=native_mode)
    elif name == "gta5":
        ds = GTA5Dataset(data_cfg.gta5_path, data_cfg.gta5_labels_subdir, data_cfg.gta5_convert_on_the_fly, size,
                         native_decode=native_mode)
    elif name == "synthetic":
        return SyntheticDataset(length=getattr(data_cfg, "synthetic_length", 64), size=size)
    else:
        raise ValueError(f"unknown dataset {name!r}; options: cityscapes, gta5, synthetic")
    cache_dir = getattr(data_cfg, "decoded_cache_dir", None)
    if cache_dir:
        from .cache import DecodedCacheDataset

        ds = DecodedCacheDataset(ds, cache_dir)
    return ds
