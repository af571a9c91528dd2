"""Adversarial UDA training CLI of the port (the JAX package's
``cli/train_adversarial.py``, plus ``--device``): BiSeNet generator +
FC-Discriminator, GTA5 source with labels, Cityscapes train split as the
unlabeled target stream.

Examples::

    # the flagship preset on synthetic data, on the CPU at a small size
    python -m rtda_semanticsegmentation_tpu_torch.cli.train_adversarial \
        --preset bisenet_adversarial_lovasz --train_dataset synthetic \
        --val_dataset synthetic --target_dataset synthetic \
        --train_size 64 96 --eval_size 64 96 --batch_size 2 --epochs 2 \
        --steps_per_epoch 2 --device cpu --log_backend jsonl

    # on the GPU
    python -m rtda_semanticsegmentation_tpu_torch.cli.train_adversarial \
        --generator_model bisenet --generator_optimizer sgd --epochs 50 \
        --gta5_path ./data/GTA5 --cityscapes_path ./data/Cityscapes \
        --use_lovasz

    # data parallel on 8 GPUs of one host (the global --batch_size split
    # over them; two ranks on the CPU: --nproc_per_node 2 ... --device cpu)
    python -m torch.distributed.run --nproc_per_node 8 \
        -m rtda_semanticsegmentation_tpu_torch.cli.train_adversarial \
        --preset bisenet_adversarial_lovasz --batch_size 64
"""

from __future__ import annotations

import argparse
import dataclasses

from ..train.loop import run_experiment
from .common import add_common_flags, args_to_config, process_group


def main(argv=None):
    p = argparse.ArgumentParser(description="Adversarial UDA training")
    add_common_flags(p, adversarial=True)
    p.add_argument("--lambda_adv", type=float, default=None,
                   help="Generator adversarial loss weight (default 0.002).")
    p.add_argument("--disc_lr", type=float, default=None,
                   help="Discriminator Adam LR (default 2.5e-5).")
    p.add_argument("--target_dataset", default=None, choices=("cityscapes", "synthetic"),
                   help="Unlabeled target stream (default cityscapes, its train split).")
    args = p.parse_args(argv)
    with process_group(args.device):
        cfg = args_to_config(args, adversarial=True)
        if args.target_dataset:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, adversarial_target_dataset=args.target_dataset))
        adv_over = {k: v for k, v in {"lambda_adv": args.lambda_adv, "disc_learning_rate": args.disc_lr}.items()
                    if v is not None}
        if adv_over:
            cfg = cfg.replace(adversarial=dataclasses.replace(cfg.adversarial, **adv_over))
        return run_experiment(cfg, run_name=args.run_name, measure_performance=not args.no_perf, device=args.device)


def entry() -> int:
    """The console script: run, exit 0 (``main`` returns the report)."""
    main()
    return 0


if __name__ == "__main__":
    main()
