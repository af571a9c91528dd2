"""rtda_semanticsegmentation_tpu_torch: the PyTorch + CUDA port of
``rtda_semanticsegmentation_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its module
layout and flax module names, imports no JAX, and replaces each Pallas TPU
kernel on a ported path with a kernel written by hand for Hopper. Ported so
far: BiSeNet-R18 eval serving in bf16 / f32 / int8 (kernel K3), and the
source-only train step, CE and CE + binned Lovász (kernels K1 and K2)::

    models/      BiSeNet-R18 eval and train forward, seeded init, JAX weight bridge, int8 PTQ
    ops/         losses, on-device augmentation, colour spaces, int8 quantization primitives
    kernels/     hand-written CUDA kernels (csrc/*.cu) and their plain versions
    train/       poly schedule, optimizer, train state, train step
    serving.py   uint8 frames -> trainId masks
    cli/         predict
    data/        the trainId palette
"""

__version__ = "0.1.0"
