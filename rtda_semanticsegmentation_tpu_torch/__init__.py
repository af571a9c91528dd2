"""rtda_semanticsegmentation_tpu_torch: the PyTorch + CUDA port of
``rtda_semanticsegmentation_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its module
layout and flax module names, imports no JAX, and replaces each Pallas TPU
kernel on a ported path with a kernel written by hand for Hopper. Ported
so far: serving (BiSeNet-R18 in bf16 / f32 / int8 on kernel K3,
BiSeNet-R101 and DeepLabV2 in bf16 / f32, their 3x3 convs optionally on
K4), the train step in all four modes (the binned Lovász loss on K1 and
K2, the discriminator's first conv optionally on K5a-c) and the training
job around it::

    models/      BiSeNet, DeepLabV2, FC-Discriminator; seeded init, JAX weight bridge, int8 PTQ
    ops/         losses, on-device augmentation, colour spaces, int8 quantization, metrics
    kernels/     hand-written CUDA kernels (csrc/*.cu) and their plain versions
    train/       schedule, optimizers, state, train step, eval engine, checkpoints, the loop
    data/        labels, datasets, loaders (host decode, pinned copies to the device)
    obs/         jsonl / W&B logging, latency and FLOPs, the per-module FLOP table
    serving.py   uint8 frames -> trainId masks
    cli/         predict, train, train_adversarial
"""

__version__ = "0.1.0"
