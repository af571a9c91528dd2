"""Source-only training CLI of the port (the JAX package's ``cli/train.py``,
plus ``--device``).

Examples::

    # a CPU run on synthetic data
    python -m rtda_semanticsegmentation_tpu_torch.cli.train \
        --preset bisenet_source_small --train_dataset synthetic \
        --val_dataset synthetic --epochs 2 --steps_per_epoch 5 --device cpu

    # GTA5 source-only with full augmentation, on the GPU
    python -m rtda_semanticsegmentation_tpu_torch.cli.train \
        --model_name bisenet --optimizer adam --epochs 50 \
        --gta5_dataset_path ./data/GTA5 \
        --cityscapes_dataset_path ./data/Cityscapes \
        --augmentation all_four_combined
"""

from __future__ import annotations

import argparse

from ..train.loop import run_experiment
from .common import add_common_flags, args_to_config, process_group


def main(argv=None):
    p = argparse.ArgumentParser(description="Source-only segmentation training")
    add_common_flags(p, adversarial=False)
    args = p.parse_args(argv)
    with process_group(args.device):
        cfg = args_to_config(args, adversarial=False)
        return run_experiment(cfg, run_name=args.run_name, measure_performance=not args.no_perf, device=args.device)


def entry() -> int:
    """The console script: run, exit 0 (``main`` returns the report)."""
    main()
    return 0


if __name__ == "__main__":
    main()
