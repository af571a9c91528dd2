"""Offline GTA5 label preprocessing: RGB color labels -> trainId PNGs (the
port's copy of the JAX package's ``data/preprocess.py``).

Counterpart of reference ``datasets/preprocess_gta5_labels.py:28-77``: builds
the 256^3 LUT once, converts every ``<gta5_root>/<original_subdir>/*.png``
RGB label to a single-channel mode-"L" trainId PNG in
``<gta5_root>/<output_subdir>/``, skipping files already converted. Run once
before training with pre-converted labels (the default, fast path).

CLI::

    python -m rtda_semanticsegmentation_tpu_torch.data.preprocess \
        --gta5_root ./data/GTA5 [--original_subdir labels] \
        [--output_subdir labels_trainids] [--workers 8] [--overwrite]
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .labels import rgb_label_to_train_ids


def convert_one(src: str, dst: str, overwrite: bool = False) -> bool:
    """Convert a single RGB label PNG; returns True if written."""
    from PIL import Image

    if not overwrite and os.path.exists(dst):
        return False
    with Image.open(src) as im:
        rgb = np.asarray(im.convert("RGB"))
    ids = rgb_label_to_train_ids(rgb)
    Image.fromarray(ids, mode="L").save(dst)
    return True


def preprocess_labels(
    gta5_root: str,
    original_subdir: str = "labels",
    output_subdir: str = "labels_trainids",
    workers: int = 8,
    overwrite: bool = False,
) -> int:
    src_dir = os.path.join(gta5_root, original_subdir)
    dst_dir = os.path.join(gta5_root, output_subdir)
    if not os.path.isdir(src_dir):
        raise FileNotFoundError(f"label directory not found: {src_dir}")
    os.makedirs(dst_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(src_dir) if f.endswith(".png"))
    if not files:
        raise FileNotFoundError(f"no .png labels in {src_dir}")

    def job(f: str) -> bool:
        return convert_one(
            os.path.join(src_dir, f), os.path.join(dst_dir, f), overwrite
        )

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        written = sum(pool.map(job, files))
    print(f"converted {written}/{len(files)} labels -> {dst_dir}")
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gta5_root", required=True)
    p.add_argument("--original_subdir", default="labels")
    p.add_argument("--output_subdir", default="labels_trainids")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)
    try:
        preprocess_labels(
            args.gta5_root,
            args.original_subdir,
            args.output_subdir,
            args.workers,
            args.overwrite,
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
