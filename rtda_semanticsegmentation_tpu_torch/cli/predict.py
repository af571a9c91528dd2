"""Batch inference CLI of the port: segment a folder of images.

Same flags and outputs as ``rtda_semanticsegmentation_tpu.cli.predict``
(whose jax-free parser, image collection, decode and PNG writers it
reuses): decode -> resize -> normalize -> forward (bf16, f32, or int8 PTQ
calibrated on the first ``--calib_batches`` batches) -> argmax -> trainId
PNG + colorized PNG (+ overlay). Runs on the first CUDA device when there
is one, as the JAX CLI runs on jax's default backend; with none it warns
and runs on the CPU, where the int8 convs take the kernel's plain version.

Usage::

    python -m rtda_semanticsegmentation_tpu_torch.cli.predict \
        --images ./frames --output ./masks --precision int8 --overlay
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from rtda_semanticsegmentation_tpu.cli.predict import (
    _unique_stems,
    _write_outputs,
    build_parser,
    collect_images,
    decode_resize,
)

from ..config import AugmentConfig, ModelConfig


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..models.convert import load_npz_into_state
    from ..models.factory import build_model, init_model
    from ..models.quantize import calibrate, freeze
    from ..ops.augment import normalize_u8
    from ..serving import make_serving_fn

    if args.artifact:
        raise _not_ported("--artifact (serving artifacts)")
    if args.checkpoint_dir is not None:
        raise _not_ported("--checkpoint_dir (checkpoint restore)")
    if args.model_name != "bisenet" or args.context_path != "resnet18":
        raise _not_ported(f"{args.model_name}/{args.context_path}")

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
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cpu":
        print("WARNING: no CUDA device; running on the CPU, where the int8 "
              "convs take the kernel's plain version", file=sys.stderr)

    paths = collect_images(args.images)
    if not paths:
        raise FileNotFoundError(f"no images found at {args.images!r}")
    os.makedirs(args.output, exist_ok=True)
    print(f"{len(paths)} image(s) -> {args.output} "
          f"({args.precision}, {h}x{w}, batch {args.batch_size}, {device})",
          file=sys.stderr)

    variables = init_model(build_model(mcfg), torch.Generator().manual_seed(0))
    if args.pretrained_backbone:
        variables = load_npz_into_state(variables, args.pretrained_backbone, mcfg.name)
    else:
        print("WARNING: no checkpoint; predicting with random weights", file=sys.stderr)

    def decode(path):
        return decode_resize(path, w, h)

    b = args.batch_size
    batches = [paths[i : i + b] for i in range(0, len(paths), b)]
    decoded_cache: dict = {}  # batch index -> [(img_u8, orig_size), ...]
    stems = _unique_stems(paths)

    if args.precision == "int8":
        n_cal = max(1, min(args.calib_batches, len(batches)))
        calib = []
        for bi, chunk in enumerate(batches[:n_cal]):
            decoded_cache[bi] = [decode(p) for p in chunk]
            imgs = torch.from_numpy(np.stack([d[0] for d in decoded_cache[bi]]))
            calib.append(normalize_u8(imgs, aug))
        variables = freeze(mcfg, calibrate(mcfg, variables, calib, device=device))
        print(f"int8 calibration done ({n_cal} batch(es))", file=sys.stderr)
    serve = make_serving_fn(mcfg, aug, variables, args.precision, device=device)

    written = 0
    for bi, chunk in enumerate(batches):
        decoded = decoded_cache.pop(bi, None) or [decode(p) for p in chunk]
        imgs = np.stack([d[0] for d in decoded])
        if imgs.shape[0] < b:  # pad the tail batch: every request has one shape
            pad = np.zeros((b - imgs.shape[0], h, w, 3), np.uint8)
            imgs = np.concatenate([imgs, pad])
        preds = serve(torch.from_numpy(imgs)).cpu().numpy()
        written += _write_outputs(args, decoded, chunk, preds, stems, h, w)
    print(f"wrote {written} prediction(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
