"""Batch inference CLI of the port: segment a folder of images.

Same flags and outputs as the JAX package's ``cli/predict.py``: decode ->
resize -> normalize -> forward (bf16, f32, or int8 PTQ calibrated on the
first ``--calib_batches`` batches, on kernel K3) -> argmax ->
trainId PNG + colorized PNG (+ overlay), for BiSeNet (``resnet18`` or
``resnet101``) and DeepLabV2, or through an artifact that ``cli/export.py``
wrote (``--artifact``). ``--device`` picks the device, the counterpart of
the JAX package's ``JAX_PLATFORMS``: ``cuda`` (the default) needs a CUDA
device and raises without one; ``cpu`` runs there, where the int8 convs
take the kernel's plain version.

Usage::

    python -m rtda_semanticsegmentation_tpu_torch.cli.predict \
        --images ./frames --output ./masks --precision int8 --overlay
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from ..config import AugmentConfig, ModelConfig
from ..data.labels import train_ids_to_rgb

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def collect_images(path: str) -> list:
    """A sorted list of image paths from a file, directory, or glob."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path) if f.lower().endswith(IMAGE_EXTS))
    matches = sorted(glob.glob(path))
    if not matches:
        raise FileNotFoundError(f"no images found at {path!r}")
    return matches


def decode_resize(path: str, w: int, h: int):
    """PIL decode -> RGB -> bilinear resize to (w, h). Returns
    ``(uint8 HWC array, original (W, H))``."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    orig = im.size
    return np.asarray(im.resize((w, h), Image.BILINEAR), np.uint8), orig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True, help="Image file, directory, or glob.")
    p.add_argument("--output", required=True, help="Output directory.")
    p.add_argument("--artifact", default=None,
                   help="Serve from an artifact exported by cli/export instead of a checkpoint; "
                        "model/size/precision flags are then read from the artifact's metadata.")
    p.add_argument("--model_name", choices=("bisenet", "deeplabv2"), default="bisenet")
    p.add_argument("--bisenet_context_path", dest="context_path",
                   choices=("resnet18", "resnet101"), default="resnet18")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Checkpoint root written by the port's train CLIs. Omit to run with random weights.")
    p.add_argument("--run_name", default="", help="Run subdirectory under --checkpoint_dir.")
    p.add_argument("--adversarial", action="store_true",
                   help="Checkpoint came from adversarial training.")
    p.add_argument("--restore", choices=("best", "latest"), default="best")
    p.add_argument("--pretrained_backbone", default=None,
                   help="Converted .npz weights (convert_torch_weights) grafted into the model.")
    p.add_argument("--size", type=int, nargs=2, default=(512, 1024), metavar=("H", "W"),
                   help="Model input size.")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--precision", choices=("bf16", "f32", "int8"), default="bf16",
                   help="int8 = post-training-quantized serving path, calibrated on the "
                        "first --calib_batches batches of the inputs themselves.")
    p.add_argument("--calib_batches", type=int, default=2)
    p.add_argument("--quant_clip", type=float, default=None,
                   help="int8 activation-scale clip quantile (default ModelConfig.quant_clip).")
    p.add_argument("--quant_min_ch", type=int, default=None,
                   help="Only convs with at least this many input channels run on the s8 "
                        "path (default ModelConfig.quant_min_ch).")
    p.add_argument("--quant_skip", type=str, nargs="*", default=None,
                   help="Module-path substrings kept on the bf16 path in int8 mode.")
    p.add_argument("--overlay", action="store_true",
                   help="Also write a 60/40 image/mask blend per input.")
    p.add_argument("--no_resize_back", action="store_true",
                   help="Keep masks at the model size instead of each input's own.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where to run: cuda needs a CUDA device and raises without one.")
    return p


def _unique_stems(paths) -> dict:
    """Unique output stems: inputs differing only by extension (a.png,
    a.jpg) must not clobber each other's masks."""
    stems, seen = {}, {}
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        if stem in seen:
            seen[stem] += 1
            stem = f"{stem}_{seen[stem]}"
        else:
            seen[stem] = 0
        stems[path] = stem
    return stems


def _write_outputs(args, decoded, chunk, preds, stems, h, w) -> int:
    """Write trainId/color (+ optional overlay) PNGs for one batch."""
    from PIL import Image

    written = 0
    for (_, orig), path, pred in zip(decoded, chunk, preds):
        stem = stems[path]
        mask = Image.fromarray(pred, mode="L")
        color = Image.fromarray(train_ids_to_rgb(pred))
        if not args.no_resize_back and orig != (w, h):
            mask = mask.resize(orig, Image.NEAREST)
            color = color.resize(orig, Image.NEAREST)
        mask.save(os.path.join(args.output, f"{stem}_trainids.png"))
        color.save(os.path.join(args.output, f"{stem}_color.png"))
        if args.overlay:
            base = Image.open(path).convert("RGB")
            if args.no_resize_back:
                base = base.resize((w, h), Image.BILINEAR)
            blend = (0.6 * np.asarray(base, np.float32) + 0.4 * np.asarray(color, np.float32)).astype(np.uint8)
            Image.fromarray(blend).save(os.path.join(args.output, f"{stem}_overlay.png"))
        written += 1
    return written


def _restore_variables(args, mcfg: ModelConfig, device) -> dict:
    """G's eval variables from the ``--restore`` stream of the run under
    ``--checkpoint_dir`` (``--run_name``, else the model's directory, with
    the adversarial suffix when ``--adversarial``), on ``device``."""
    from ..config import AdversarialConfig, ExperimentConfig, TrainConfig
    from ..train.checkpoint import CheckpointManager

    cfg = ExperimentConfig(model=mcfg, train=TrainConfig(checkpoint_dir=args.checkpoint_dir),
                           adversarial=AdversarialConfig(enabled=args.adversarial))
    mgr = CheckpointManager(cfg, run_name=args.run_name, device=device)
    restored = mgr.restore_variables(which=args.restore)
    if restored is None:
        raise FileNotFoundError(f"no '{args.restore}' checkpoint under {mgr.root}")
    variables, meta = restored
    print(f"restored {args.restore} checkpoint from {mgr.root} "
          f"(epoch {meta['epoch']}, best mIoU {meta['best_miou']:.4f})", file=sys.stderr)
    return variables


def _load_variables(args, mcfg: ModelConfig, device) -> dict:
    """The model's variables on ``device``: restored from ``--checkpoint_dir``,
    else the seeded init (seed 0) with ``--pretrained_backbone`` grafted in."""
    from ..models.convert import load_npz_into_state
    from ..models.factory import build_model, init_model

    if args.checkpoint_dir is not None:
        return _restore_variables(args, mcfg, device)
    variables = init_model(build_model(mcfg, device), torch.Generator().manual_seed(0))
    if args.pretrained_backbone:
        return load_npz_into_state(variables, args.pretrained_backbone, mcfg.name)
    print("WARNING: no --checkpoint_dir; predicting with random weights", file=sys.stderr)
    return variables


def _check_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..models.quantize import calibrate, freeze
    from ..ops.augment import normalize_u8
    from ..serving import make_serving_fn

    if args.artifact:
        return _predict_with_artifact(args)

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

    paths = collect_images(args.images)
    if not paths:
        raise FileNotFoundError(f"no images found at {args.images!r}")
    os.makedirs(args.output, exist_ok=True)
    print(f"{len(paths)} image(s) -> {args.output} "
          f"({args.precision}, {h}x{w}, batch {args.batch_size}, {device})",
          file=sys.stderr)

    variables = _load_variables(args, mcfg, device)

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


def _predict_with_artifact(args) -> int:
    """Serve a folder through an artifact (cli/export.py output) on
    ``--device``."""
    from ..serving import load_artifact

    fn, meta = load_artifact(args.artifact, device=_check_device(args.device))
    h = int(meta.get("height", args.size[0]))
    w = int(meta.get("width", args.size[1]))
    # a pinned-batch artifact dictates the batch size (tail batches are
    # padded); a symbolic-batch artifact serves --batch_size directly
    pinned = meta.get("batch")
    b = int(pinned) if pinned else args.batch_size
    paths = collect_images(args.images)
    if not paths:
        raise FileNotFoundError(f"no images found at {args.images!r}")
    os.makedirs(args.output, exist_ok=True)
    print(f"{len(paths)} image(s) -> {args.output} (artifact {meta.get('model', '?')}/"
          f"{meta.get('precision', '?')}, {h}x{w}, batch {b}{' pinned' if pinned else ''}, {args.device})",
          file=sys.stderr)
    stems = _unique_stems(paths)
    written = 0
    for i in range(0, len(paths), b):
        chunk = paths[i : i + b]
        decoded = [decode_resize(p, w, h) for p in chunk]
        imgs = np.stack([d[0] for d in decoded])
        if pinned and imgs.shape[0] < b:
            pad = np.zeros((b - imgs.shape[0], h, w, 3), np.uint8)
            imgs = np.concatenate([imgs, pad])
        preds = fn(imgs).cpu().numpy()
        written += _write_outputs(args, decoded, chunk, preds, stems, h, w)
    print(f"wrote {written} prediction(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
