"""Offline torch -> flax-path weight converter (the port's copy of the JAX
package's ``cli/convert_torch_weights.py``, the same flags and the same
``.npz``; it needs no JAX).

Three modes, each writing a flax-path-keyed ``.npz``:

- default: backbone only — torchvision ResNet-18/101 ImageNet weights, or
  the caffe-style DeepLab ResNet-101 ``.pth`` the reference requires at
  ``models/deeplabv2/DeepLab_resnet_pretrained_imagenet.pth``
  (reference ``config.py:41-43``). Loads via ``--pretrained_backbone``.
- ``--full``: a complete reference TRAINING checkpoint
  (``best_miou_checkpoint.pth`` / ``checkpoint.pth``, vanilla or
  adversarial container) — every generator module converts (spatial path,
  ARMs, FFM, heads, trunk; or DeepLabV2 trunk + ASPP). Also loads via
  ``--pretrained_backbone``.
- ``--model discriminator``: extracts ``model_D_state_dict`` from an
  adversarial checkpoint (implies ``--full``). Loads via
  ``--pretrained_discriminator``.

Usage::

    python -m rtda_semanticsegmentation_tpu_torch.cli.convert_torch_weights \
        --torch_checkpoint resnet18-f37072fd.pth --model bisenet \
        --depth 18 --output resnet18_imagenet.npz

    python -m rtda_semanticsegmentation_tpu_torch.cli.convert_torch_weights \
        --torch_checkpoint best_miou_checkpoint.pth --model bisenet \
        --full --output bisenet_trained.npz

    python -m rtda_semanticsegmentation_tpu_torch.cli.convert_torch_weights \
        --torch_checkpoint best_miou_checkpoint.pth --model discriminator \
        --output disc_trained.npz
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--model", choices=("bisenet", "deeplabv2", "discriminator"), required=True,
                   help="'discriminator' extracts model_D_state_dict from an adversarial checkpoint "
                        "(implies --full); loads via --pretrained_discriminator.")
    p.add_argument("--depth", type=int, choices=(18, 101), default=None,
                   help="ResNet depth (default: 18 for bisenet, 101 for deeplabv2)")
    p.add_argument("--output", required=True, help="Output .npz path")
    p.add_argument("--full", action="store_true",
                   help="Convert a complete reference TRAINING checkpoint (every generator module), "
                        "not just the backbone.")
    args = p.parse_args(argv)

    if args.model == "discriminator" and args.depth is not None:
        p.error("--depth is meaningless for --model discriminator")
    depth = args.depth or (18 if args.model == "bisenet" else 101)

    import numpy as np

    from ..models.convert import (
        convert_full_torch_checkpoint,
        convert_torch_checkpoint,
        read_torch_checkpoint,
        unwrap_reference_checkpoint,
    )

    disc = args.model == "discriminator"
    state = unwrap_reference_checkpoint(read_torch_checkpoint(args.torch_checkpoint), which="D" if disc else "G")
    state = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in state.items()}

    if args.full or disc:
        arrays = convert_full_torch_checkpoint(state, args.model, depth)
    else:
        arrays = convert_torch_checkpoint(state, args.model, depth)
    if not arrays:
        print("error: no convertible keys found in checkpoint", file=sys.stderr)
        sys.exit(1)
    np.savez(args.output, **arrays)
    print(f"wrote {len(arrays)} arrays -> {args.output}")


if __name__ == "__main__":
    main()
