"""Export a trained model as a serving artifact (``torch.export``).

The port's counterpart of the JAX package's ``cli/export.py``: the same
flags, with ``--device {cuda,cpu}`` (the device the graph is traced on; a
card by default, which raises without one) in place of ``--platforms``, and
``--fused_conv3``. The artifact holds the weights, the preprocessing and
the argmax, optionally with a symbolic batch; ``serving.load_artifact``
loads it, ``cli/predict.py --artifact`` serves it. Its int8 convs run K3
and its ``--fused_conv3`` convs K4 on a card.

Usage::

    python -m rtda_semanticsegmentation_tpu_torch.cli.export \
        --checkpoint_dir ./checkpoints --run_name bisenet --restore best \
        --size 512 1024 --precision int8 --calib_images ./frames \
        --output ./artifacts/bisenet_int8
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..config import AugmentConfig, ModelConfig
from .predict import _check_device, _load_variables, collect_images, decode_resize


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", required=True, help="Artifact output directory.")
    p.add_argument("--model_name", choices=("bisenet", "deeplabv2"), default="bisenet")
    p.add_argument("--bisenet_context_path", dest="context_path",
                   choices=("resnet18", "resnet101"), default="resnet18")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Checkpoint root written by the port's train CLIs. Omit to export random "
                        "weights (debug only).")
    p.add_argument("--run_name", default="", help="Run subdirectory under --checkpoint_dir.")
    p.add_argument("--adversarial", action="store_true",
                   help="Checkpoint came from adversarial training (affects the default run "
                        "directory name).")
    p.add_argument("--restore", choices=("best", "latest"), default="best")
    p.add_argument("--pretrained_backbone", default=None,
                   help="Converted .npz weights (convert_torch_weights) grafted into the model.")
    p.add_argument("--size", type=int, nargs=2, default=(512, 1024), metavar=("H", "W"),
                   help="Serving input size.")
    p.add_argument("--batch", type=int, default=0,
                   help="Pin the artifact batch size; 0 (default) exports a symbolic batch "
                        "dimension (any batch at run time).")
    p.add_argument("--precision", choices=("bf16", "f32", "int8"), default="bf16",
                   help="int8 = calibrated PTQ serving path on K3 (needs --calib_images).")
    p.add_argument("--calib_images", default=None,
                   help="Image file/dir/glob used for int8 max-abs calibration.")
    p.add_argument("--calib_batches", type=int, default=2)
    p.add_argument("--calib_batch_size", type=int, default=8)
    p.add_argument("--quant_clip", type=float, default=None,
                   help="int8 activation clip quantile; 1.0 = exact max|x| (default "
                        "ModelConfig.quant_clip). Recorded in the artifact metadata.")
    p.add_argument("--quant_min_ch", type=int, default=None,
                   help="Only convs with at least this many input channels run on the s8 path "
                        "(default ModelConfig.quant_min_ch).")
    p.add_argument("--quant_skip", type=str, nargs="*", default=None,
                   help="Module-path substrings kept on the bf16 path in int8 mode.")
    p.add_argument("--fused_conv3", action="store_true",
                   help="bf16 only: run the 3x3 / stride-1 ConvBNs on K4, their BatchNorm folded.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="The device the graph is traced on: cuda needs a CUDA device and raises "
                        "without one. load_artifact can move the artifact to another device.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..models.quantize import calibrate
    from ..ops.augment import normalize_u8
    from ..serving import ARTIFACT_GRAPH, export_serving, save_artifact

    h, w = args.size
    dtype = {"bf16": "bfloat16", "f32": "float32", "int8": "bfloat16"}[args.precision]
    mcfg = ModelConfig(
        name=args.model_name,
        context_path=args.context_path,
        compute_dtype=dtype,
        **({"quant_clip": args.quant_clip} if args.quant_clip is not None else {}),
        **({"quant_min_ch": args.quant_min_ch} if args.quant_min_ch is not None else {}),
        **({"quant_skip": tuple(args.quant_skip)} if args.quant_skip is not None else {}),
    )
    aug = AugmentConfig()
    device = _check_device(args.device)
    if args.precision == "int8" and not args.calib_images:
        print("--precision int8 requires --calib_images", file=sys.stderr)
        return 2
    variables = _load_variables(args, mcfg, device)

    if args.precision == "int8":
        paths = collect_images(args.calib_images)
        if not paths:
            raise FileNotFoundError(f"no calibration images at {args.calib_images!r}")
        bs = max(1, args.calib_batch_size)
        paths = paths[: max(1, args.calib_batches) * bs]
        calib = []
        for i in range(0, len(paths), bs):
            imgs = np.stack([decode_resize(p, w, h)[0] for p in paths[i : i + bs]])
            calib.append(normalize_u8(torch.from_numpy(imgs), aug))
        variables = calibrate(mcfg, variables, calib, device=device)
        print(f"int8 calibration done ({len(calib)} batch(es))", file=sys.stderr)

    exported, meta = export_serving(mcfg, aug, variables, height=h, width=w, batch=args.batch or None,
                                    precision=args.precision, fused_conv3=args.fused_conv3, device=device)
    save_artifact(args.output, exported, meta)
    size = os.path.getsize(os.path.join(args.output, ARTIFACT_GRAPH))
    print(f"exported {args.model_name}/{args.context_path} {args.precision}"
          f"{' fused_conv3' if args.fused_conv3 else ''} @ {w}x{h} batch={args.batch or 'symbolic'} "
          f"device={device.type} -> {args.output} ({size / 1e6:.1f} MB)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
