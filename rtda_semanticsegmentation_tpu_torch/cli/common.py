"""Shared CLI plumbing of the port's train CLIs: flags -> immutable
ExperimentConfig (the JAX package's ``cli/common.py`` flag surface, plus
``--device``).

Every override produces a new frozen config via ``dataclasses.replace``.
The port runs on one device: ``--mesh_data`` and ``--mesh_model`` accept a
one-device mesh only (1, or -1 for "all devices" = the one), and anything
larger raises (multi-GPU is ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import PRESETS, ExperimentConfig, OptimizerConfig, get_preset


def add_common_flags(p: argparse.ArgumentParser, adversarial: bool) -> None:
    g = "generator_" if adversarial else ""
    p.add_argument("--preset", choices=PRESETS, default=None,
                   help="Start from a named benchmark preset.")
    p.add_argument(f"--{g}model" if adversarial else "--model_name",
                   dest="model_name", choices=("bisenet", "deeplabv2"))
    p.add_argument(f"--{g}optimizer" if adversarial else "--optimizer",
                   dest="optimizer", choices=("sgd", "adam"))
    p.add_argument(f"--{g}lr" if adversarial else "--lr",
                   dest="lr", type=float)
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--resume_checkpoint", type=str,
                   help="'latest' or 'best' restores from this run's "
                        "checkpoint dir; any other value is a PATH to a run "
                        "root, one stream's directory or a checkpoint file "
                        "to warm-start from — reference "
                        "--resume_checkpoint semantics.")
    p.add_argument("--cityscapes_dataset_path", "--cityscapes_path",
                   dest="cityscapes_path", type=str)
    p.add_argument("--gta5_dataset_path", "--gta5_path",
                   dest="gta5_path", type=str)
    p.add_argument("--train_dataset",
                   choices=("gta5", "cityscapes", "synthetic"))
    p.add_argument("--val_dataset", choices=("cityscapes", "synthetic"))
    p.add_argument("--bisenet_context_path", dest="context_path",
                   choices=("resnet18", "resnet101"))
    p.add_argument("--augmentation", dest="augmentation",
                   choices=("no_new_aug", "hflip_only", "colorjitter_only",
                            "isonoise_only", "coarsedropout_only",
                            "all_four_combined", "all_four_plus_hflip"))
    p.add_argument("--use_lovasz", action="store_true", default=None)
    p.add_argument("--lovasz_impl", choices=("binned", "sort"), default=None,
                   help="Lovasz formulation: 'binned' counting-sort "
                        "(kernels K1 and K2, the default) or 'sort' (exact "
                        "reference descending-sort parity).")
    p.add_argument("--lovasz_bins", type=int, default=None,
                   help="Bucket count for the binned Lovasz (power of two; "
                        "default 256).")
    p.add_argument("--lovasz_interp", type=int, choices=(0, 1), default=None,
                   help="FG/BG-split within-bucket backward for the binned "
                        "Lovasz (default 1; grad cosine ~1.0000 vs the "
                        "exact sort). 0 = r4 bucket-average backward.")
    p.add_argument("--aux_weight", type=float, default=None,
                   help="BiSeNet aux-head CE weight (0 = reference parity; "
                        "the BiSeNet paper uses 1.0).")
    p.add_argument("--pretrained_backbone", type=str,
                   help="Path to converted .npz backbone weights.")
    p.add_argument("--checkpoint_dir", type=str)
    p.add_argument("--steps_per_epoch", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--run_name", type=str)
    p.add_argument("--log_backend", choices=("auto", "wandb", "jsonl", "null"))
    p.add_argument("--log_dir", type=str,
                   help="Directory for jsonl logs / image panels (default ./logs).")
    p.add_argument("--watch_freq_steps", type=int, default=None,
                   help="Log per-module gradient/parameter norms every N "
                        "steps (reference wandb.watch; 0 = off, default).")
    p.add_argument("--upload_checkpoints", action="store_true", default=None,
                   help="Mirror saved checkpoints to the W&B run "
                        "(reference wandb.save policy='live').")
    p.add_argument("--mesh_data", type=int,
                   help="Data-parallel axis size: 1 or -1 (the port runs on "
                        "one device).")
    p.add_argument("--mesh_model", type=int,
                   help="Model-parallel axis size: 1 (the port runs on one "
                        "device).")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where to run: cuda needs a CUDA device and raises "
                        "without one.")
    p.add_argument("--compute_dtype", choices=("bfloat16", "float32"))
    p.add_argument("--eval_batch_size", type=int)
    p.add_argument("--data_echo", type=int,
                   help="Run each host-loaded batch through N optimizer "
                        "steps, each with a fresh on-device augmentation "
                        "draw (data echoing; 1 = off). Use when host "
                        "decode can't feed the chip.")
    p.add_argument("--num_workers", type=int,
                   help="Host decode threads (reference "
                        "DATALOADER_NUM_WORKERS; -1 = auto-size to "
                        "min(32, cpu_count), the default).")
    p.add_argument("--decoded_cache_dir", type=str,
                   help="Directory for the decoded-sample disk cache: "
                        "decode each PNG once (epoch 1), then serve raw "
                        "post-resize tensors. For decode-bound hosts; "
                        "budget 6.5 MB/sample at 1280x720.")
    p.add_argument("--train_size", type=int, nargs=2, metavar=("H", "W"),
                   help="Training resize override for ANY train dataset "
                        "(defaults: GTA5 720 1280 / Cityscapes 512 1024, "
                        "reference config.py:16-21).")
    p.add_argument("--eval_size", type=int, nargs=2, metavar=("H", "W"),
                   help="Validation resize override (default 512 1024).")
    p.add_argument("--no_perf", action="store_true",
                   help="Skip the end-of-run latency/FLOPs measurement.")
    p.add_argument("--final_int8_eval", action="store_true", default=None,
                   help="After training, evaluate the best model through "
                        "the int8 PTQ serving path and report the mIoU "
                        "delta vs bf16.")
    p.add_argument("--profile_steps", type=int,
                   help="Capture a torch.profiler trace (chrome JSON) of N "
                        "warm train steps (written under the log dir).")
    if adversarial:
        p.add_argument("--pretrained_discriminator", type=str, default=None,
                       help="Warm-start D from a converted reference "
                            "adversarial checkpoint (.npz from "
                            "convert_torch_weights --model discriminator).")
        p.add_argument("--disc_downsample", type=int, default=None,
                       help="Block-average the generator logits by this "
                            "factor before the softmax feeding the "
                            "discriminator (1 = reference parity: "
                            "full-resolution output-space maps).")
    p.add_argument("--no_halt_on_nonfinite", action="store_true",
                   default=None,
                   help="Keep training through NaN/Inf losses instead of "
                        "halting with a diagnostic at the next log point "
                        "(failure detection is ON by default; the "
                        "reference has none — SURVEY.md section 5).")
    p.add_argument("--validate_freq_epoch", type=int,
                   help="Validate every N epochs (reference "
                        "VALIDATE_FREQ_EPOCH, config.py:107; default 1).")
    p.add_argument("--save_checkpoint_freq_epoch", type=int,
                   help="Overwrite the periodic checkpoint every N epochs "
                        "(reference SAVE_CHECKPOINT_FREQ_EPOCH, "
                        "config.py:58; default 5).")
    p.add_argument("--log_images_freq_epoch", type=int,
                   help="Log a validation mask overlay every N epochs "
                        "(reference WANDB_LOG_IMAGES_FREQ_EPOCH, "
                        "config.py:108; default 10). Images come from "
                        "validation predictions, so they are emitted only "
                        "on validation epochs — keep this a multiple of "
                        "--validate_freq_epoch.")
    p.add_argument("--print_freq_batch", type=int,
                   help="Log train scalars every N batches (reference "
                        "PRINT_FREQ_BATCH, config.py:106; default 100).")


def args_to_config(args: argparse.Namespace, adversarial: bool) -> ExperimentConfig:
    cfg = get_preset(args.preset) if args.preset else ExperimentConfig()
    if adversarial and not cfg.adversarial.enabled:
        cfg = cfg.replace(
            adversarial=dataclasses.replace(cfg.adversarial, enabled=True)
        )

    def rep(section: str, **kw):
        nonlocal cfg
        kw = {k: v for k, v in kw.items() if v is not None}
        if kw:
            cfg = cfg.replace(
                **{section: dataclasses.replace(getattr(cfg, section), **kw)}
            )

    # Reference default-LR coupling: picking an optimizer without an explicit
    # --lr uses that optimizer's default LR (config.py:86-95).
    lr = args.lr
    if lr is None and args.optimizer is not None:
        lr = OptimizerConfig.default_lr(args.optimizer)

    rep("model", name=args.model_name, context_path=args.context_path,
        pretrained_backbone=args.pretrained_backbone,
        compute_dtype=args.compute_dtype)
    rep("optimizer", name=args.optimizer, learning_rate=lr)
    rep("data", cityscapes_path=args.cityscapes_path,
        gta5_path=args.gta5_path, train_dataset=args.train_dataset,
        val_dataset=args.val_dataset, eval_batch_size=args.eval_batch_size,
        num_workers=args.num_workers,
        decoded_cache_dir=args.decoded_cache_dir,
        train_size_override=tuple(args.train_size) if args.train_size else None,
        eval_size_override=tuple(args.eval_size) if args.eval_size else None)
    rep("train", epochs=args.epochs, batch_size=args.batch_size,
        data_echo=args.data_echo,
        resume_checkpoint=args.resume_checkpoint, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        steps_per_epoch=args.steps_per_epoch,
        final_int8_eval=args.final_int8_eval,
        profile_steps=args.profile_steps,
        halt_on_nonfinite=(False if args.no_halt_on_nonfinite else None),
        validate_freq_epoch=args.validate_freq_epoch,
        save_checkpoint_freq_epoch=args.save_checkpoint_freq_epoch,
        log_images_freq_epoch=args.log_images_freq_epoch,
        print_freq_batch=args.print_freq_batch)
    rep("augment", pipeline=args.augmentation)
    rep("loss", use_lovasz=args.use_lovasz, aux_weight=args.aux_weight,
        lovasz_impl=args.lovasz_impl, lovasz_bins=args.lovasz_bins,
        lovasz_interp=(
            None if args.lovasz_interp is None else bool(args.lovasz_interp)
        ))
    rep("obs", backend=args.log_backend, run_name=args.run_name,
        log_dir=args.log_dir, watch_freq_steps=args.watch_freq_steps,
        upload_checkpoints=args.upload_checkpoints)
    for flag, value, ok in (("--mesh_data", args.mesh_data, (1, -1)), ("--mesh_model", args.mesh_model, (1,))):
        if value is not None and value not in ok:
            raise ValueError(
                f"{flag} {value}: the PyTorch port runs on one device; a mesh of more than one device "
                "is not ported yet (ROADMAP queue 1 item 8, multi-GPU)"
            )
    if adversarial:
        rep("adversarial",
            disc_downsample=getattr(args, "disc_downsample", None),
            pretrained_discriminator=getattr(
                args, "pretrained_discriminator", None
            ))
    return cfg
