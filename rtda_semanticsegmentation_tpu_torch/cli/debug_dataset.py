"""Visual dataset sanity check (reference ``scripts/debug_{gta,cityscapes}.py``;
the port's copy of the JAX package's ``cli/debug_dataset.py``).

Loads one sample, colorizes the label, and writes (or shows) an
image|label|overlay panel — a human-in-the-loop check of path pairing, label
decoding, and resize sync.

Usage::

    python -m rtda_semanticsegmentation_tpu_torch.cli.debug_dataset \
        --dataset gta5 --gta5_path ./data/GTA5 --index 0 --output sample.png
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..config import DataConfig
from ..data.datasets import build_dataset
from ..data.labels import train_ids_to_rgb


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=("gta5", "cityscapes", "synthetic"),
                   required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--gta5_path", default="./data/GTA5")
    p.add_argument("--cityscapes_path", default="./data/Cityscapes")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--output", default=None,
                   help="PNG path; if omitted, tries to show with matplotlib.")
    args = p.parse_args(argv)

    dcfg = dataclasses.replace(
        DataConfig(), gta5_path=args.gta5_path,
        cityscapes_path=args.cityscapes_path,
    )
    ds = build_dataset(args.dataset, args.split, (args.height, args.width), dcfg)
    img, label = ds.load(args.index)
    colored = train_ids_to_rgb(label)
    overlay = (0.6 * img + 0.4 * colored).astype(np.uint8)
    panel = np.concatenate([img, colored, overlay], axis=1)

    print(f"sample {args.index}/{len(ds)}: image {img.shape} "
          f"label {label.shape} classes {sorted(np.unique(label).tolist())}")
    if args.output:
        from PIL import Image

        Image.fromarray(panel).save(args.output)
        print(f"wrote {args.output}")
    else:
        try:
            import matplotlib.pyplot as plt

            plt.figure(figsize=(15, 5))
            plt.imshow(panel)
            plt.axis("off")
            plt.show()
        except ImportError:
            print("matplotlib not available; use --output")


if __name__ == "__main__":
    main()
