#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda);
without a device it raises and prints no result. Phases, each raising on
failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``csrc/int8_conv.cu``, ``csrc/lovasz.cu``,
   ``csrc/conv4x4s2.cu``, ``csrc/conv3x3.cu``, ``csrc/upsample.cu``,
   ``csrc/batchnorm.cu`` and ``csrc/layernorm.cu`` for
   sm_90a into build/kernels/, one nvcc each, started together; prints the ptxas
   reports and, per source, the registers and spill bytes;
3. kernels: each hand-written kernel alone at the main path's shapes, on
   seeded operands: the s8 conv (K3) at every quantized conv shape of
   BiSeNet-R18 at 512x1024, batch 8 (``SHAPES``); the Lovász histogram
   (K1) and backward (K2) at the source-only step's (8, 19, 512*1024)
   softmax probabilities with ~10% ignore labels, K1 on three
   distributions (``LOVASZ_DISTRIBUTIONS``) and at 1024 and 2048 bins,
   both also at the flagship's source map (8, 19, 720*1280); K5a-c on the
   flagship's softmax maps; the 3x3 conv (K4) at every distinct shape of
   the three serve paths below (``CONV3_SHAPES``); the resize's backward
   (``kernels/upsample.py``) at its seven sites on the train paths
   (``UPSAMPLE_SITES``), in the main path's layouts; train-mode BatchNorm
   + ReLU (``kernels/batchnorm.py``) at ``BN_SHAPES``, each pass timed
   inside a forward and backward (a torch.profiler trace, by kernel name,
   in a process of its own) beside its HBM bound, the forward and
   backward warm and with a cold L2, and DeepLabV2's 104 a step by shape;
   LayerNorm (``kernels/layernorm.py``) at SegFormer-B5's seven shapes
   (``LN_SHAPES``), forward and backward, summed over a step's 161, and
   the calls of an eager B5 encoder forward and backward, which must be
   those 161 each way.
   Each kernel is replayed from a CUDA graph (the device time without the
   host's) and launched back to back, per shape and summed per forward or
   step, beside its plain version, its bound (the card's published peaks,
   ``h100_bench/costs/peaks.py``) and, for K4 and K5a-c, cuDNN's bf16
   conv, for the resize's backward PyTorch's own; prints the TOP/s,
   TFLOP/s or GB/s, the share of the bound and the host microseconds per
   launch per shape. Before it is timed, each is held to its plain
   version on the same operands at the tolerance
   ``tests/test_torch_cuda.py`` holds it to (``against_plain``), the
   BatchNorm kernels to f64 as there; those tests check every case and
   edge, and read their main-path shapes from this module's tables;
4. serve: BiSeNet-R18 with seeded random weights, calibrated on 2 batches
   of 8 synthetic frames and frozen, serves 4 requests of 8 frames through
   ``make_serving_fn`` in bf16 and int8. Masks must be uint8 (8, 512, 1024)
   below 19, logits finite, each int8 request must launch K3 exactly 15
   times with no operand copy (``int8_conv.copies``), and the int8 masks
   must match those of the same model with the kernel swapped for its
   plain version (>= 0.999 of pixels); the f32 forward on the card must
   match the CPU's on a small input. Then bf16 with ``fused_conv3``: 14 K4
   launches per request, checked as in phase 5;
5. R101: BiSeNet-R101 and DeepLabV2, seeded random weights, each checked
   first in f32 on the card against the CPU (2x64x128; DeepLabV2 1x65x129,
   within 1e-3 * max |logit|, argmax agreement >= 0.999), then serving 4
   requests of 8 frames at 512x1024 in bf16 with ``fused_conv3`` off and
   on: valid masks, finite logits, exactly 31 and 33 K4 launches per
   request and no operand copy (``conv3x3.copies``), every K4 launch of a
   request within one bf16 ulp of its plain version on the same operands,
   masks >= 0.995 equal to those with K4 swapped for its plain version
   where the logits do not nearly tie (``_k4_serving`` says why not 0.999
   of all pixels).
   Prints the agreement of K4's masks with cuDNN's;
6. train: the ``bisenet_source_aug`` preset with the binned Lovász loss
   (BiSeNet-R18, bf16, Adam, ``all_four_combined`` augmentation, batch 8 at
   512x1024) from a seeded init on synthetic frames and structured labels.
   From one saved state, a step with the kernels and a step with their plain
   versions agree (loss within 1e-4, grad norm within 1e-2 relative); an f32
   step at 2x64x96 on the card matches the same step on the CPU, TF32 off
   (losses within 1e-4 relative, grad norm within 1e-2: the convs, the
   BatchNorm statistics and K1's error sums add in other orders). Then 8
   steps on one repeated batch: every loss finite, the mean of the last 3
   below the first, K1 and K2 launched exactly once per step and the
   resize's backward 3 times (cx1, cx2, the logits) with no copy. Prints
   the peak device memory;
7. adversarial: the flagship preset ``bisenet_adversarial_lovasz``
   (BiSeNet-R18 + FC-Discriminator, bf16, binned Lovász, ``all_four_combined``
   augmentation, batch 8, source 720x1280, target 512x1024) with the
   discriminator's first conv on K5a-c. An f32 step at 2x64x96 on the card
   matches the CPU's with the default discriminator (cuDNN conv1), TF32 off
   (losses within 1e-4, grad norms within 1e-2 relative); from one saved
   G+D state, a step with the kernels and a step with their plain versions
   agree (loss within 1e-4, loss_d and loss_adv_g within 1e-3, grad norms
   within 1e-2 relative: the bf16 discriminator rounds after sums taken in
   another order). Then 8 steps on one repeated batch: every loss finite,
   the mean of the last 3 below the first, loss_d first within 0.1 of ln 2,
   and per step K5a launched 3 times, K5b 2, K5c 1, K1 1, K2 1 and the
   resize's backward 6 (both domains' cx1, cx2 and logits), with no K5
   operand copy and no copy of a resize's gradient (the calls' shapes and
   layouts are printed). Prints the peak memory;
8. loop: a whole training job through the CLI entry point
   ``cli/train_adversarial.main``: the flagship preset on synthetic train,
   target and validation sets at its sizes (source 720x1280, target and
   validation 512x1024), batch 8, 2 epochs of 3 steps, a checkpoint each
   epoch, validation each epoch, the final int8 evaluation, jsonl logs
   under build/chip_smoke_loop/; then the same run resumed from its
   'latest' checkpoint to 3 epochs. Gates: every logged loss finite and
   ``loss_d`` at step 1 within 0.1 of ln 2; K1 and K2 launched exactly once
   per optimizer step of each run; K3 exactly 15 times per int8 forward of
   the final evaluation (its calibration forwards run in float and launch
   none); the int64 histogram of a validation pass totals the validation
   set's non-ignored pixels; mIoU in [0, 1]; ``int8_miou`` and
   ``int8_miou_delta`` in the report; both checkpoint streams written; the
   resumed run starts at step 3 with G and D bit-equal to the file's and
   ends at step 9.
9. r101_int8 (run after phase 5): BiSeNet-R101 and DeepLabV2 with seeded
   random weights, calibrated on 2 batches of 8 frames and frozen, serve 4
   requests of 8 frames at 512x1024 in int8. Gates: exactly 97 and 95 K3
   launches per request (one per quantized conv; DeepLabV2's include 23 at
   dilation 2 and 3 at dilation 4) and no operand copy; valid masks, finite
   logits; masks >= 0.999 equal to those with K3 swapped for its plain
   version (2 requests); DeepLabV2's first K3 launch at d = 2 and at d = 4
   of a request bit-identical to the plain version on the same operands;
   the non-frozen ``int8`` model's masks equal to the frozen one's; the
   shapes and counts of K3's launches in a request those of
   ``R101_K3_SHAPES``. Prints the peak memory, then checks and times K3 at
   every shape of a request as in phase 3 and sums it per forward;
10. deeplab_train (run after phase 7): the ``deeplabv2_cityscapes`` step
   (DeepLabV2, bf16, SGD, batch 8 at 512x1024, BatchNorm affines frozen).
   An f32 step at 2x64x96 on the card matches the CPU's (TF32 off, losses
   within 1e-4, grad norm within 1e-2 relative); from one state, a step
   with ``train.remat`` and one without give the same loss and running
   statistics, bit for bit (each with its peak memory); then 8 steps on
   one repeated batch: losses finite and falling, every BatchNorm affine
   bit-identical to its init, every running statistic moved, the resize's
   backward launched once a step with no copy. Prints the peak memory.
   BiSeNet-R101's vanilla step (``bisenet_source_aug`` on a ResNet-101
   context path, b8 512x1024) runs from its init twice, to the same loss;
11. deeplab loop (run after phase 8): ``cli/train.main`` with
   ``--preset deeplabv2_cityscapes`` on synthetic train and validation
   sets at 512x1024, batch 8, 1 epoch of 2 steps, validation in 2 batches
   of 32, the 'best' checkpoint, the final int8 evaluation. Gates: finite
   losses, the checkpoint, the BatchNorm affines at their init,
   ``int8_miou`` in [0, 1], K3 exactly 95 times per int8 batch with no
   operand copy. K3's count in the kernels line adds these launches and
   phase 8's to phases 4 and 9's; its times are the sums per forward of
   R18, BiSeNet-R101 and DeepLabV2.
12. artifact (run after phase 4): serving artifacts at 512x1024, seeded
   random weights. BiSeNet-R18 in bf16, int8 (calibrated on 2 batches) and
   bf16 with ``fused_conv3``, each exported on the card with a symbolic
   batch (``serving.export_serving``), saved into build/ and loaded
   (``load_artifact``); then DeepLabV2 int8, calibrated and frozen on the
   card, exported on the CPU and loaded onto the card. Each serves 4
   requests of 8 frames and one of 1. Gates: masks bit-equal to
   ``make_serving_fn``'s on the same frames; exactly 15 K3 launches per
   R18 int8 request, 14 K4 per ``fused_conv3`` request, 95 K3 per
   DeepLabV2 request and none of the other kernel, no operand copy.
   Prints export and load seconds and MB on disk. Phase 4 also shows that
   K3 launches nothing while ``k3_plain`` swaps it.
   K3's and K4's counts in the kernels line add these launches.
13. distributed (run after phase 8): data parallelism on
   ``torch.distributed``. (a) The flagship's training job (as phase 8,
   1 epoch of 3 steps, ``--no_perf``) launched by ``python -m
   torch.distributed.run --nproc_per_node 1`` through this script's
   ``--worker cli``, which calls ``cli/train_adversarial.main``: its start
   line must name NCCL and world 1, K1 and K2 must launch once per step,
   and its logged losses must equal the same run's without the launcher:
   step 1 bit for bit; later steps within 1e-2 relative, beside the
   difference of two runs without the launcher (printed): a kernel that
   adds with atomics in no fixed order rounds its bf16 sums (an ulp is
   3.9e-3) differently from run to run.
   K1's and K2's counts in the kernels line add these launches.
   (b) Two ranks on the one card over gloo (``--worker dp``, each on cuda:0
   through ``parallel.ensure_distributed(backend="gloo")`` and
   ``create_mesh(device="cuda:0")``): one flagship step at full shapes,
   global batch 8, 4 rows a rank, against the same step in this process
   (losses within 1e-4, grad norms within 1e-2 relative, as phase 6's card
   against CPU). (c) K1 on the flagship's (8, 19, 720*1280) probabilities:
   split over the 2 ranks and summed as integer histograms, cut into 3
   launches (``MAX_PIXELS`` patched), and in one launch: the same bits,
   and the same bits as its plain version. (d) A source-only binned-Lovász
   step at b32 512x1024 (2**24 pixels): 2 K1 launches and 1 K2 per step,
   finite loss; prints its peak memory.

14. tp (run after phase 13): tensor parallelism (``parallel/tp.py``) with
   gloo ranks sharing cuda:0 (``--worker tp``): (a) 2 ranks at (data=1,
   model=2), (b) 4 ranks at (data=2, model=2), each running the flagship
   step at full shapes (b8, source 720x1280, target 512x1024) with the
   train loop's rule (convs of >= 256 output channels sharded: 13 of G, 2
   of D). The gate: one step in f32 (TF32 off) against the single-process
   step with whole convs, within phase 13b's tolerances. Then the bf16
   steps: their first step's difference to the single-process bf16 step is
   printed, not gated, beside the single-process step's own difference
   under another choice of cuDNN algorithms (``cudnn.benchmark``): a
   sharded conv runs cuDNN kernels of other shapes, which round other
   bf16 sums; K1 and K2 launch once per step and rank; the replicated
   parameters are the same bits in every model group (the BatchNorm
   running statistics' spread is printed). Prints the weights + optimizer
   state a rank holds against one process's. K1's and K2's counts in the
   kernels line add rank 0's launches.

The last two lines are a JSON summary of the kernels and the result line.
Each kernel's ``launches`` there counts its launches on the main path; the
BatchNorm's entry counts ``calls`` instead: forward calls of the train
steps, each with its backward, each of them 3 launches; the LayerNorm's
``calls`` are those of one eager forward and backward of SegFormer-B5's
encoder at b8 512x1024 (counted from 0, and held to ``LN_SHAPES``), 1
launch forward and 2 backward each, and its times the sums of
``LN_SHAPES``' timings over a step's norms. ``max_abs_err`` is
the largest |diff| phase 3 found against the plain version (for U1 against
its f64 sums, for the BatchNorm dx's against f64 autograd, for the
LayerNorm dx's against its expressions in f64).
``python3 chip_smoke.py --only distributed`` runs phases 1, 2, 13 and 14
alone (a quicker check of the distributed path), ``--only tp`` phases 1, 2
and 14, ``--only upsample`` phases 1, 2 and the resize backward's part of
phase 3, ``--only batchnorm`` phases 1, 2 and the BatchNorm part of phase
3, ``--only layernorm`` phases 1, 2 and the LayerNorm part of phase 3;
``--worker`` is the form phases 13 and 14 start their ranks with (and
phase 3 its BatchNorm passes' trace).

How fast a whole path runs is the benchmark's to say (``h100_bench/``,
``BENCHMARK.json``): this script times no step or request.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from h100_bench.costs.lovasz import k1_bytes, k2_bytes
from h100_bench.costs.peaks import BF16_FLOPS, HBM_BYTES_S, INT8_OPS
from rtda_semanticsegmentation_tpu_torch.config import AugmentConfig, ModelConfig, get_preset
from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn
from rtda_semanticsegmentation_tpu_torch.kernels import build as kbuild
from rtda_semanticsegmentation_tpu_torch.kernels import conv3x3 as k4
from rtda_semanticsegmentation_tpu_torch.kernels import conv4x4 as kc
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.kernels import layernorm as kln
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov
from rtda_semanticsegmentation_tpu_torch.kernels import upsample as kup
from rtda_semanticsegmentation_tpu_torch.models.factory import (
    build_discriminator,
    build_model,
    init_discriminator,
    init_model,
    load_variables,
)
from rtda_semanticsegmentation_tpu_torch.models.layers import sync_batch_norm
from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate, freeze, quantized_model
from rtda_semanticsegmentation_tpu_torch.obs import spans
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
from rtda_semanticsegmentation_tpu_torch.ops.losses import _binned_lovasz_forward
from rtda_semanticsegmentation_tpu_torch.serving import (
    ARTIFACT_GRAPH,
    export_serving,
    load_artifact,
    make_serving_fn,
    save_artifact,
)
from rtda_semanticsegmentation_tpu_torch.train.optim import build_discriminator_tx, build_generator_tx, is_bn_affine
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState
from rtda_semanticsegmentation_tpu_torch.train.steps import make_train_step

BATCH, H, W = 8, 512, 1024
REQUESTS = 4
QUANT_CONVS = 15
# BiSeNet-R18's quantized convs at 512x1024 (quant_min_ch=128):
# (where, cin, cout, input h, input w, kernel, stride, pad, convs per forward)
SHAPES = (
    ("layer2 3x3/s1", 128, 128, 64, 128, 3, 1, 1, 3),
    ("layer3 3x3/s1", 256, 256, 32, 64, 3, 1, 1, 3),
    ("layer4 3x3/s1", 512, 512, 16, 32, 3, 1, 1, 3),
    ("ffm 3x3/s1", 1024, 19, 64, 128, 3, 1, 1, 1),
    ("spatial_path/convblock3 3x3/s2", 128, 256, 128, 256, 3, 2, 1, 1),
    ("layer3_0/conv1 3x3/s2", 128, 256, 64, 128, 3, 2, 1, 1),
    ("layer4_0/conv1 3x3/s2", 256, 512, 32, 64, 3, 2, 1, 1),
    ("layer3_0/downsample 1x1/s2", 128, 256, 64, 128, 1, 2, 0, 1),
    ("layer4_0/downsample 1x1/s2", 256, 512, 32, 64, 1, 2, 0, 1),
)
DEV = torch.device("cuda", 0)
# the train phase: classes, Lovász bins, steps on the card
CLASSES, BINS = 19, 256
TRAIN_STEPS = 8
MAX_ITER = 1000
EXEMPT = ("supervision1", "supervision2")
# the adversarial phase: the discriminator's input maps (source, target)
NDF = 64
SOURCE_HW, TARGET_HW = (720, 1280), (512, 1024)
# the resize's backward at its sites on the train paths, batch 8: (where, C,
# input size, output size, the gradient's layout there, launches per
# flagship step, per DeepLabV2 step). The logits' gradients come from the
# loss in contiguous NCHW; the ARM features' are channel slices of the FFM
# concatenation's channels_last gradient (1024 channels: cx1 at 256, cx2 at
# 512).
UPSAMPLE_SITES = (
    ("flagship source logits", 19, (90, 160), SOURCE_HW, "nchw", 1, 0),
    ("flagship target logits", 19, (64, 128), TARGET_HW, "nchw", 1, 0),
    ("flagship source cx1", 256, (45, 80), (90, 160), "slice", 1, 0),
    ("flagship source cx2", 512, (23, 40), (90, 160), "slice", 1, 0),
    ("flagship target cx1", 256, (32, 64), (64, 128), "slice", 1, 0),
    ("flagship target cx2", 512, (16, 32), (64, 128), "slice", 1, 0),
    ("DeepLabV2 logits", 19, (65, 129), (H, W), "nchw", 0, 1),
)
# train-mode BatchNorm + ReLU (kernels/batchnorm.py), batch 8, bf16
# channels_last unless said: (where, C, H, W, dtype, relu) checked against
# the plain version and timed; DeepLabV2's 104 a step by (C, H, W): how many
BN_SHAPES = (
    ("DeepLabV2 layer3 256", 256, 65, 129, torch.bfloat16, True),
    ("DeepLabV2 layer3 1024", 1024, 65, 129, torch.bfloat16, False),
    ("flagship stem", 64, 360, 640, torch.bfloat16, True),
    ("SegFormer linear_fuse", 768, 128, 256, torch.bfloat16, True),
    ("ARM gate f32", 512, 1, 1, torch.float32, False),
)
BN_DEEPLAB_STEP = ((64, 256, 512, 1), (64, 129, 257, 6), (256, 129, 257, 4), (128, 65, 129, 8), (512, 65, 129, 11),
                   (256, 65, 129, 46), (1024, 65, 129, 24), (2048, 65, 129, 4))
BN_EPS, BN_MOMENTUM = 1e-5, 0.9
# SegFormer-B5's LayerNorms (kernels/layernorm.py) in a b8 512x1024 train
# step, bf16, as tests/test_torch_layernorm.py's census of the model finds
# them: (where, rows, C, norms a step, each a forward and a backward); the
# key reductions' norms hold the keys of stages 1-3
LN_SHAPES = (
    ("stage 1", 262144, 64, 8),
    ("stage 1 keys", 4096, 64, 3),
    ("stage 2", 65536, 128, 14),
    ("stage 2 keys", 4096, 128, 6),
    ("stage 3", 16384, 320, 82),
    ("stage 3 keys", 4096, 320, 40),
    ("stage 4", 4096, 512, 8),
)
LN_EPS = 1e-6
# plain versions swapped in for each kernel of a path: (module, wrapper)
LOVASZ_KERNELS = ((klov, "lovasz_hist"), (klov, "lovasz_bwd"))
CONV4_KERNELS = ((kc, "conv4x4s2p1"), (kc, "conv4x4s2p1_dw"), (kc, "conv4x4s2p1_dx"))
CONV3_KERNELS = ((k4, "conv3x3"),)
# K4's convs per forward with fused_conv3 at b8 512x1024: (where, C, CO,
# H, W, dilation, convs per forward of each model)
CONV3_SHAPES = (
    ("layer1 3x3", 64, 64, 128, 256, 1, {"r18": 4, "r101": 3}),
    ("layer2 3x3", 128, 128, 64, 128, 1, {"r18": 3, "r101": 3}),
    ("layer3 3x3", 256, 256, 32, 64, 1, {"r18": 3, "r101": 22}),
    ("layer4 3x3", 512, 512, 16, 32, 1, {"r18": 3, "r101": 2}),
    ("ffm convblock (R18)", 1024, 19, 64, 128, 1, {"r18": 1}),
    ("ffm convblock (R101)", 3328, 19, 64, 128, 1, {"r101": 1}),
    ("deeplab layer1 3x3", 64, 64, 129, 257, 1, {"deeplabv2": 3}),
    ("deeplab layer2 3x3", 128, 128, 65, 129, 1, {"deeplabv2": 4}),
    ("deeplab layer3 3x3 d2", 256, 256, 65, 129, 2, {"deeplabv2": 23}),
    ("deeplab layer4 3x3 d4", 512, 512, 65, 129, 4, {"deeplabv2": 3}),
)
K4_CONVS = {"r18": 14, "r101": 31, "deeplabv2": 33}
# the int8 serve phase of the R101 models: (name, key, ModelConfig fields),
# and K3's launches per request, one per QuantConv (a ConvBN whose input has
# at least quant_min_ch = 128 channels): BiSeNet-R101's trunk 95 plus its
# spatial path's convblock3 and FFM, DeepLabV2's trunk 95 (23 at d = 2 and
# 3 at d = 4)
R101_MODELS = (("BiSeNet-R101", "r101", dict(context_path="resnet101")),
               ("DeepLabV2", "deeplabv2", dict(name="deeplabv2")))
R101_QUANT_CONVS = {"r101": 97, "deeplabv2": 95}
# K3's launches in one of those requests at b8 512x1024, as phase 9's census
# finds them: (cin, cout, input h, input w, kernel, stride, padding,
# dilation, launches a request)
R101_K3_SHAPES = {
    "r101": (
        (128, 128, 64, 128, 3, 1, 1, 1, 3), (128, 128, 128, 256, 3, 2, 1, 1, 1),
        (128, 256, 128, 256, 3, 2, 1, 1, 1), (128, 512, 64, 128, 1, 1, 0, 1, 4),
        (256, 64, 128, 256, 1, 1, 0, 1, 2), (256, 128, 128, 256, 1, 1, 0, 1, 1),
        (256, 256, 32, 64, 3, 1, 1, 1, 22), (256, 256, 64, 128, 3, 2, 1, 1, 1),
        (256, 512, 128, 256, 1, 2, 0, 1, 1), (256, 1024, 32, 64, 1, 1, 0, 1, 23),
        (512, 128, 64, 128, 1, 1, 0, 1, 3), (512, 256, 64, 128, 1, 1, 0, 1, 1),
        (512, 512, 16, 32, 3, 1, 1, 1, 2), (512, 512, 32, 64, 3, 2, 1, 1, 1),
        (512, 1024, 64, 128, 1, 2, 0, 1, 1), (512, 2048, 16, 32, 1, 1, 0, 1, 3),
        (1024, 256, 32, 64, 1, 1, 0, 1, 22), (1024, 512, 32, 64, 1, 1, 0, 1, 1),
        (1024, 2048, 32, 64, 1, 2, 0, 1, 1), (2048, 512, 16, 32, 1, 1, 0, 1, 2),
        (3328, 19, 64, 128, 3, 1, 1, 1, 1),
    ),
    "deeplabv2": (
        (128, 128, 65, 129, 3, 1, 1, 1, 4), (128, 512, 65, 129, 1, 1, 0, 1, 4),
        (256, 64, 129, 257, 1, 1, 0, 1, 2), (256, 128, 129, 257, 1, 2, 0, 1, 1),
        (256, 256, 65, 129, 3, 1, 2, 2, 23), (256, 512, 129, 257, 1, 2, 0, 1, 1),
        (256, 1024, 65, 129, 1, 1, 0, 1, 23), (512, 128, 65, 129, 1, 1, 0, 1, 3),
        (512, 256, 65, 129, 1, 1, 0, 1, 1), (512, 512, 65, 129, 3, 1, 4, 4, 3),
        (512, 1024, 65, 129, 1, 1, 0, 1, 1), (512, 2048, 65, 129, 1, 1, 0, 1, 3),
        (1024, 256, 65, 129, 1, 1, 0, 1, 22), (1024, 512, 65, 129, 1, 1, 0, 1, 1),
        (1024, 2048, 65, 129, 1, 1, 0, 1, 1), (2048, 512, 65, 129, 1, 1, 0, 1, 2),
    ),
}


def _zero_counters(*names: str) -> None:
    """Set the kernel wrappers' counters (``obs/spans.py``) to 0."""
    for name in names:
        spans.set_counter(name, 0)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the device, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``, replayed from a CUDA
    graph of ``iters`` calls: the kernel's time without the host's cost of
    each launch, which exceeds it for the smaller convs (``host_us``)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    libraries = (k3._library, klov._library, kc._library, k4._library, kup._library, kbn._library, kln._library)
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, started together
        for f in [pool.submit(lib) for lib in libraries]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kbuild.nvcc_path()})")
    for source, info in kbuild.build_log.items():
        print(f"build log {source} ({info['seconds']:.2f} s):\n{info['log']}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", info["log"])})
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", info["log"])]
        print(f"ptxas {source}: registers per thread {regs}, spill bytes max {max(spills, default=0)}")


def host_us(fn, n: int = 20) -> float:
    """Host microseconds per call of ``fn``: the wrapper's checks, its
    tensor-map encoding and the launch, with the card left to run behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound_ms(nbytes: float, ops: float = 0.0, peak: float = INT8_OPS):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their peak rate (int8 unless ``peak``
    says otherwise). Returns (ms, bound_by)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def against_plain(what: str, got, want, tol=None) -> float:
    """``got``, a kernel's output, against ``want``, its plain version's on
    the same operands, at ``tests/test_torch_cuda.py``'s tolerance for it:
    bit-identical (``tol`` None); a bf16 ``got`` within one bf16 ulp of
    ``want`` plus ``tol`` * max |want|; any other within ``tol`` * max
    |want|. Raises on a mismatch; returns the largest |diff|."""
    torch.cuda.synchronize()
    diff = (got.double() - want.double()).abs()
    err = diff.max().item()
    if tol is None:
        ok = torch.equal(got, want)
    else:
        allowed = tol * want.double().abs().max()
        if got.dtype == torch.bfloat16:
            allowed = torch.ldexp(torch.ones_like(diff), torch.frexp(want.double())[1] - 8) + allowed
        ok = bool((diff <= allowed).all())
    if not ok or got.shape != want.shape:
        raise AssertionError(f"{what}: the kernel differs from its plain version (max |diff| {err:.3e}, "
                             f"tolerance {'none' if tol is None else tol})")
    return err


def _conv_case(i, cin, cout, h, w, k):
    g = torch.Generator(device=DEV).manual_seed(1000 + i)
    xq = torch.randint(-127, 128, (BATCH, h, w, cin), generator=g, device=DEV, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=DEV, dtype=torch.int8)
    # scale so z = acc * a + b spans a few units: std(acc) ~ 73.3^2 * sqrt(k*k*cin)
    a = torch.rand(cout, generator=g, device=DEV) * 2.0 / (73.3 ** 2 * (k * k * cin) ** 0.5)
    b = torch.randn(cout, generator=g, device=DEV, dtype=torch.float32) * 0.5
    return xq, wq, a, b


def _k3_shape(i, where, cin, cout, h, w, k, s, p, d=1, count=1) -> dict:
    """K3 at one conv shape (batch 8) on seeded operands: its output
    bit-identical to the plain version's; its time (graph replay, back to
    back, host per launch), the plain version's and the bound."""
    xq, wq, a, b = _conv_case(i, cin, cout, h, w, k)
    # the model's operands: the K-major weights made once (QuantConv.fold)
    kw = dict(stride=s, padding=p, dilation=d, relu=False, out_dtype=torch.bfloat16)
    fn = functools.partial(k3.int8_conv, xq, wq, a, b, kmajor=k3.kmajor_weights(wq), **kw)
    plain = functools.partial(k3.int8_conv_plain, xq, wq, a, b, **kw)
    out = fn()
    err = against_plain(f"K3 {where} {cin}->{cout} @{h}x{w} d{d}", out, plain())
    ms = graph_ms(fn)
    stream_ms = cuda_ms(fn, 20)
    us = host_us(fn)
    plain_ms = cuda_ms(plain, 5, 1)
    ho, wo = out.shape[1:3]
    ops = 2.0 * BATCH * ho * wo * cout * k * k * cin
    # s8 input and weights, f32 a and b read once; bf16 output written once
    nbytes = BATCH * h * w * cin + k * k * cin * cout + 8 * cout + 2 * BATCH * ho * wo * cout
    bound, by = bound_ms(nbytes, ops)
    tops = ops / (ms * 1e-3) / 1e12
    print(f"kernel {where} {cin}->{cout} @{h}x{w} d{d} b{BATCH}: bit-identical; "
          f"kernel {ms:.4f} ms ({tops:.1f} TOP/s, {bound / ms:.3f} of the bound; {stream_ms:.4f} ms launched "
          f"back to back), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), host {us:.1f} us per launch, "
          f"x{count} per forward")
    return {"ms": ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "bound_ms": bound, "by": by, "err": err,
            "count": count, "ops": ops, "bytes": nbytes, "in_elems": BATCH * h * w * cin}


def _k3_forward(what: str, shapes) -> dict:
    """K3 at every (where, cin, cout, h, w, k, s, p, d, count) of one
    forward, summed per forward (``count`` convs of each shape)."""
    rows = [_k3_shape(i, *shape) for i, shape in enumerate(shapes)]
    total = {key: sum(r["count"] * r[key] for r in rows)
             for key in ("ms", "stream_ms", "plain_ms", "bound_ms", "ops", "bytes", "in_elems")}
    by = {kind: sum(r["count"] * r["bound_ms"] for r in rows if r["by"] == kind) for kind in ("bytes", "operations")}
    convs = sum(r["count"] for r in rows)
    print(f"kernel total over one {what} forward's {convs} quantized convs: "
          f"{total['ms']:.4f} ms kernel ({total['stream_ms']:.4f} ms launched back to back, "
          f"{total['bound_ms'] / total['ms']:.3f} of the bound), {total['plain_ms']:.4f} ms plain, "
          f"{total['bound_ms']:.4f} ms bound; {total['ops'] / 1e12:.3f} TOP, {total['bytes'] / 1e9:.3f} GB, "
          f"{total['in_elems'] / 1e9:.3f} G input elements (the activation quantizer's)")
    # no PyTorch call computes an s8 convolution on CUDA: no library time
    return {"ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"], "library_ms": None,
            "max_abs_err": max(r["err"] for r in rows), "by": by, "convs": convs}


def phase_kernels() -> dict:
    """K3 at every quantized conv shape of BiSeNet-R18 (``SHAPES``)."""
    out = _k3_forward("BiSeNet-R18", [(where, cin, cout, h, w, k, s, p, 1, count)
                                      for where, cin, cout, h, w, k, s, p, count in SHAPES])
    if out["convs"] != QUANT_CONVS:
        raise AssertionError(f"SHAPES holds {out['convs']} convs, not {QUANT_CONVS}")
    return out


LOVASZ_DISTRIBUTIONS = ("spread", "uniform", "one-hot")


def _lovasz_case(kind: str = "spread", n: int = H * W):
    """(8, 19, n) probabilities and labels with ~10% ignore, on the card.
    ``spread``: a softmax of 3 * randn logits, so the buckets fill;
    ``uniform``: p = 1/C everywhere, the state at initialisation (every
    background pixel of a class in one bucket, every foreground one in
    another); ``one-hot``: a near one-hot softmax on a random class, a
    confident model, whose errors fall in bucket 0 and bucket bins - 1."""
    g = torch.Generator(device=DEV).manual_seed(2)
    if kind == "spread":
        probas = torch.softmax(torch.randn((BATCH, CLASSES, n), generator=g, device=DEV) * 3.0, dim=1)
    elif kind == "uniform":
        probas = torch.full((BATCH, CLASSES, n), 1.0 / CLASSES, device=DEV)
    elif kind == "one-hot":
        top = torch.randint(0, CLASSES, (BATCH, 1, n), generator=g, device=DEV)
        logits = torch.randn((BATCH, CLASSES, n), generator=g, device=DEV)
        probas = torch.softmax(logits.scatter_add_(1, top, torch.full_like(logits[:, :1], 30.0)), dim=1)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    labels = torch.randint(0, CLASSES, (BATCH, n), generator=g, device=DEV, dtype=torch.int32)
    labels[torch.rand((BATCH, n), generator=g, device=DEV) < 0.1] = 255
    return probas, labels


def _hist_against_plain(what: str, probas, labels, bins: int) -> float:
    """K1 against its plain version, as the cuda test holds it: count and
    fg rows identical, error sums within rtol 1e-5, atol 1e-5 (their
    fixed-point rounding). Returns the error sums' largest |diff|."""
    hist, ref = klov.lovasz_hist(probas, labels, bins, 255), klov.lovasz_hist_plain(probas, labels, bins, 255)
    against_plain(f"K1 {what} counts", hist[:, :2], ref[:, :2])
    torch.testing.assert_close(hist[:, 2], ref[:, 2], rtol=1e-5, atol=1e-5, msg=lambda m: f"K1 {what} error sums: {m}")
    return (hist[:, 2] - ref[:, 2]).abs().max().item()


def _lovasz_hist_at(probas, labels, bins: int) -> float:
    """K1 where its histogram outgrows one block's shared memory and the
    classes split over block groups, checked as at 256 bins."""
    cg, groups, _ = klov.class_groups(CLASSES, bins)
    err = _hist_against_plain(f"bins {bins}", probas, labels, bins)
    ms = graph_ms(lambda: klov.lovasz_hist(probas, labels, bins, 255))
    stream_ms = cuda_ms(lambda: klov.lovasz_hist(probas, labels, bins, 255), 20)
    plain_ms = cuda_ms(lambda: klov.lovasz_hist_plain(probas, labels, bins, 255), 5, 1)
    bound, by = bound_ms(k1_bytes(*probas.shape, bins))
    print(f"kernel lovasz_hist bins {bins} ({groups} groups of {cg} classes): error sums max |diff| {err:.3e}; "
          f"{ms:.4f} ms ({stream_ms:.4f} ms launched back to back), plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by})")
    return err


def _lovasz_times(probas, labels, tables, where: str, plain: bool = True) -> dict:
    """K1 and K2 (256 bins) timed from a CUDA graph (the ``kernels`` line)
    and back to back, beside their bounds and plain versions; with
    ``plain``, each first held to its plain version (K2 bit-identical)."""
    out = {}
    for name, fn, plain_fn, nbytes in (
        ("lovasz_hist", lambda: klov.lovasz_hist(probas, labels, BINS, 255),
         lambda: klov.lovasz_hist_plain(probas, labels, BINS, 255), k1_bytes(*probas.shape, BINS)),
        ("lovasz_bwd", lambda: klov.lovasz_bwd(probas, labels, tables, BINS, 255, True),
         lambda: klov.lovasz_bwd_plain(probas, labels, tables, BINS, 255, True), k2_bytes(*probas.shape, BINS)),
    ):
        err = None
        if plain:
            err = (_hist_against_plain(f"{where} bins {BINS}", probas, labels, BINS) if name == "lovasz_hist"
                   else against_plain(f"K2 {where}", fn(), plain_fn()))
        ms = graph_ms(fn)
        stream_ms = cuda_ms(fn, 20)
        us = host_us(fn)
        plain_ms = cuda_ms(plain_fn, 5, 1) if plain else None
        bound, by = bound_ms(nbytes)
        print(f"kernel {name} {where} {tuple(probas.shape)}: "
              + ("" if err is None else f"max |diff| {err:.3e} against the plain version; ")
              + f"{ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, "
              f"{bound / ms:.3f} of the bound; {stream_ms:.4f} ms launched back to back), plain "
              + (f"{plain_ms:.4f} ms" if plain else "not timed")
              + f", bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB), host {us:.1f} us per launch")
        # no single PyTorch call computes either function: no library time
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "max_abs_err": err}
    return out


def phase_lovasz_kernels() -> dict:
    """K1 and K2 at the source-only step's shape and 256 bins, K1 also on
    the other two distributions of ``LOVASZ_DISTRIBUTIONS`` and at 1024 and
    2048 bins, each held to its plain version there; both timed there and
    at the flagship's source map (720x1280, spread)."""
    probas, labels = _lovasz_case()
    _, tables, _ = _binned_lovasz_forward(klov.lovasz_hist(probas, labels, BINS, 255), "present", True)
    tables = (tables * 0.37).contiguous()  # a cotangent / present-count fold
    out = _lovasz_times(probas, labels, tables, "spread")
    hist = out["lovasz_hist"]
    for bins in (1024, 2048):
        hist["max_abs_err"] = max(hist["max_abs_err"], _lovasz_hist_at(probas, labels, bins))
    del probas, labels
    for kind in LOVASZ_DISTRIBUTIONS[1:]:
        probas, labels = _lovasz_case(kind)
        err = _hist_against_plain(kind, probas, labels, BINS)
        hist["max_abs_err"] = max(hist["max_abs_err"], err)
        ms = graph_ms(lambda: klov.lovasz_hist(probas, labels, BINS, 255))
        stream_ms = cuda_ms(lambda: klov.lovasz_hist(probas, labels, BINS, 255), 20)
        print(f"kernel lovasz_hist {kind}: error sums max |diff| {err:.3e}; {ms:.4f} ms ({stream_ms:.4f} ms "
              f"launched back to back)")
        del probas, labels
    probas, labels = _lovasz_case("spread", SOURCE_HW[0] * SOURCE_HW[1])
    _lovasz_times(probas, labels, tables, "flagship source map", plain=False)
    return out


def _softmax_map(hw, seed: int) -> torch.Tensor:
    """(8, 19, H, W) bf16 softmax probabilities of 3 * randn logits: what the
    discriminator reads."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    logits = torch.randn((BATCH, CLASSES) + tuple(hw), generator=g, device=DEV) * 3.0
    return torch.softmax(logits, dim=1).to(torch.bfloat16)


def phase_conv4_kernels() -> dict:
    """K5a on the source and target maps, K5b on both, K5c on the target:
    the shapes of one adversarial step, each held to its plain version
    (K5a and K5c bf16 within one bf16 ulp + 1e-5 * max |ref|, K5b's f32
    within 1e-5 * max |ref|). Each kernel timed from a CUDA graph (the
    device time, the ``kernels`` line) and back to back, with the host
    time per launch. Returns per-step totals (K5a x1 source + x2 target,
    K5b x1 each, K5c x1 target) for the kernels line."""
    g = torch.Generator(device=DEV).manual_seed(3)
    w = torch.randn((NDF, CLASSES, 4, 4), generator=g, device=DEV) * 0.02
    w16 = w.to(torch.bfloat16)
    w_bytes = w.numel() * 4
    per_step = {"conv4x4s2p1": (1, 2), "conv4x4s2p1_dw": (1, 1), "conv4x4s2p1_dx": (0, 1)}
    out = {name: {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                  "max_abs_err": 0.0, "by": {"bytes": 0.0, "operations": 0.0}} for name in per_step}
    for where, hw, seed in (("source", SOURCE_HW, 10), ("target", TARGET_HW, 11)):
        x = _softmax_map(hw, seed)
        h, wd = hw
        ho, wo = h // 2, wd // 2
        dy = (torch.randn((BATCH, NDF, ho, wo), generator=g, device=DEV) * 1e-3).to(torch.bfloat16)
        # the conv's multiply-adds over the interior: 16 C per output (K5a,
        # K5b), 4 CO per input (K5c)
        macs = BATCH * ho * wo * NDF * CLASSES * 16
        cases = {
            "conv4x4s2p1": (lambda: kc.conv4x4s2p1(x, w), lambda: kc.conv4x4s2p1_plain(x, w),
                            lambda: torch.nn.functional.conv2d(x, w16, stride=2, padding=1),
                            x.numel() * 2 + w_bytes + dy.numel() * 2),
            "conv4x4s2p1_dw": (lambda: kc.conv4x4s2p1_dw(x, dy), lambda: kc.conv4x4s2p1_dw_plain(x, dy),
                               lambda: torch.nn.grad.conv2d_weight(x, w.shape, dy, stride=2, padding=1),
                               x.numel() * 2 + dy.numel() * 2 + w_bytes),
            "conv4x4s2p1_dx": (lambda: kc.conv4x4s2p1_dx(dy, w), lambda: kc.conv4x4s2p1_dx_plain(dy, w),
                               lambda: torch.nn.grad.conv2d_input(x.shape, w16, dy, stride=2, padding=1),
                               dy.numel() * 2 + w_bytes + x.numel() * 2),
        }
        for name, (fn, plain, library, nbytes) in cases.items():
            count = per_step[name][where == "target"]
            if not count:
                continue
            err = against_plain(f"{name} {where}", fn(), plain(), 1e-5)
            ms = graph_ms(fn)
            stream_ms = cuda_ms(fn, 20)
            us = host_us(fn)
            plain_ms = cuda_ms(plain, 5, 1)
            library_ms = graph_ms(library)
            bound, by = bound_ms(nbytes, 2.0 * macs, BF16_FLOPS)
            print(f"kernel {name} {where} {tuple(x.shape)}: max |diff| {err:.3e} against the plain version; "
                  f"{ms:.4f} ms ({2.0 * macs / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {bound / ms:.3f} of the bound; "
                  f"{stream_ms:.4f} ms launched back to back), plain {plain_ms:.4f} ms, "
                  f"cuDNN bf16 {library_ms:.4f} ms, bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
                  f"{2.0 * macs / 1e9:.1f} GFLOP), host {us:.1f} us per launch, x{count} per step")
            entry = out[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["ms"] += count * ms
            entry["stream_ms"] += count * stream_ms
            entry["plain_ms"] += count * plain_ms
            entry["library_ms"] += count * library_ms
            entry["bound_ms"] += count * bound
            entry["by"][by] += count * bound
        del x, dy
    for name, entry in out.items():
        by = entry.pop("by")
        entry["bound_by"] = "operations" if by["operations"] > by["bytes"] else "bytes"
        stream_ms = entry.pop("stream_ms")
        print(f"kernel {name} per adversarial step: {entry['ms']:.4f} ms kernel ({stream_ms:.4f} ms launched back "
              f"to back, {entry['bound_ms'] / entry['ms']:.3f} of the bound), {entry['plain_ms']:.4f} ms plain, "
              f"{entry['library_ms']:.4f} ms cuDNN, {entry['bound_ms']:.4f} ms bound")
    return out


def _conv3_case(i, c, co, h, w):
    """bf16 NHWC input, the port's bf16 HWIO weights (CO padded to 8, a
    view) and a folded BatchNorm, on the card."""
    g = torch.Generator(device=DEV).manual_seed(4000 + i)
    x = torch.randn((BATCH, h, w, c), generator=g, device=DEV).to(torch.bfloat16)
    wt = torch.randn((3, 3, c, co), generator=g, device=DEV) * (2.0 / (9 * c)) ** 0.5
    wt = torch.nn.functional.pad(wt, (0, -co % 8)).to(torch.bfloat16)[..., :co]
    scale = torch.rand(co, generator=g, device=DEV) + 0.5
    shift = torch.randn(co, generator=g, device=DEV) * 0.1
    return x, wt, scale, shift


def phase_conv3_kernels() -> dict:
    """K4 at every distinct shape of the three serve paths, its bf16 output
    with the epilogue and ReLU within one bf16 ulp + 1e-5 * max |ref| of
    the plain version's; returns, for the kernels line, the sums over one forward of each of BiSeNet-R18,
    BiSeNet-R101 and DeepLabV2 (78 convs)."""
    for model, n in K4_CONVS.items():
        if sum(counts.get(model, 0) for *_, counts in CONV3_SHAPES) != n:
            raise AssertionError(f"CONV3_SHAPES does not add up to {n} convs of {model}")
    per_model = {m: {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
                 for m in K4_CONVS}
    by = {"bytes": 0.0, "operations": 0.0}
    max_err = 0.0
    for i, (where, c, co, h, w, d, counts) in enumerate(CONV3_SHAPES):
        x, wt, scale, shift = _conv3_case(i, c, co, h, w)
        model_kw = dict(relu=True, dilation=d, out_dtype=torch.bfloat16)
        err = against_plain(f"K4 {where}", k4.conv3x3(x, wt, scale, shift, **model_kw),
                            k4.conv3x3_plain(x, wt, scale, shift, **model_kw), 1e-5)
        max_err = max(max_err, err)
        ms = graph_ms(lambda: k4.conv3x3(x, wt, scale, shift, **model_kw))
        stream_ms = cuda_ms(lambda: k4.conv3x3(x, wt, scale, shift, **model_kw), 20)
        us = host_us(lambda: k4.conv3x3(x, wt, scale, shift, **model_kw))
        plain_ms = cuda_ms(lambda: k4.conv3x3_plain(x, wt, scale, shift, **model_kw), 5, 1)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = graph_ms(lambda: torch.nn.functional.conv2d(x_cl, w_cl, padding=d, dilation=d))
        ops = 2.0 * BATCH * h * w * co * 9 * c
        # bf16 input, weights and output once, f32 scale and shift once
        nbytes = 2 * BATCH * h * w * c + 2 * 9 * c * co + 8 * co + 2 * BATCH * h * w * co
        bound, bound_by = bound_ms(nbytes, ops, BF16_FLOPS)
        print(f"kernel conv3x3 {where} {c}->{co} @{h}x{w} d{d} b{BATCH}: max |diff| {err:.3e}; {ms:.4f} ms "
              f"({ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {bound / ms:.3f} of the bound; {stream_ms:.4f} ms launched "
              f"back to back), plain {plain_ms:.4f} ms, "
              f"cuDNN bf16 channels_last conv alone {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"{ops / 1e9:.1f} GFLOP), host {us:.1f} us per launch, per forward {counts}")
        for model, n in counts.items():
            for key, t in (("ms", ms), ("stream_ms", stream_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bound_ms", bound)):
                per_model[model][key] += n * t
            by[bound_by] += n * bound
        del x, wt, x_cl, w_cl
    for model, t in per_model.items():
        print(f"kernel conv3x3 per {model} forward ({K4_CONVS[model]} convs): {t['ms']:.4f} ms kernel "
              f"({t['stream_ms']:.4f} ms launched back to back), {t['plain_ms']:.4f} ms plain, "
              f"{t['library_ms']:.4f} ms cuDNN, {t['bound_ms']:.4f} ms bound")
    total = {key: sum(t[key] for t in per_model.values()) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {**total, "max_abs_err": max_err, "bound_by": max(by, key=by.get)}


def _upsample_dy(c, out_hw, layout, dtype, seed):
    """A batch-8 gradient of the resize's output in the main path's layout
    (``UPSAMPLE_SITES``)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    if layout == "slice":
        lo = 256 if c == 256 else 512
        big = torch.randn((BATCH, 1024) + tuple(out_hw), generator=g, device=DEV).to(dtype)
        return big.contiguous(memory_format=torch.channels_last)[:, lo:lo + c]
    return torch.randn((BATCH, c) + tuple(out_hw), generator=g, device=DEV).to(dtype)


def phase_upsample_kernels() -> dict:
    """The resize's backward (``kernels/upsample.py``) at its seven sites on
    the train paths, in the main path's layouts, in bf16: against the plain
    version's exact sums (f64) within one bf16 ulp + 1e-6 * max |ref| and
    no further from them than PyTorch's backward; timed from a CUDA graph
    (and back to back), beside its bound (dy read once, dx written once),
    the plain version and PyTorch's backward (``library_ms``).
    Returns, for the kernels line, the sums over one flagship step and one
    DeepLabV2 step."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "bound_by": "bytes"}
    steps = {"flagship": [0.0, 0.0, 0.0, 0.0], "DeepLabV2": [0.0, 0.0, 0.0, 0.0]}
    for i, (where, c, in_hw, out_hw, layout, per_flagship, per_deeplab) in enumerate(UPSAMPLE_SITES):
        dy = _upsample_dy(c, out_hw, layout, torch.bfloat16, 500 + i)
        nbytes = (dy.numel() + BATCH * c * in_hw[0] * in_hw[1]) * dy.element_size()
        fn = functools.partial(kup.upsample_bilinear_bwd, dy, in_hw, torch.channels_last)
        library = functools.partial(torch.ops.aten.upsample_bilinear2d_backward, dy, list(out_hw),
                                    [BATCH, c, *in_hw], False)
        exact = kup.upsample_bilinear_bwd_plain(dy, in_hw, exact=True)
        err = against_plain(f"U1 {where}", fn(), exact, 1e-6)
        aten_err = (library().double() - exact).abs().max().item()
        if err > aten_err:
            raise AssertionError(f"U1 {where}: max |diff| {err:.3e} against f64, PyTorch's backward {aten_err:.3e}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del exact
        ms = graph_ms(fn)
        stream_ms = cuda_ms(fn, 20)
        us = host_us(fn)
        plain_ms = cuda_ms(functools.partial(kup.upsample_bilinear_bwd_plain, dy, in_hw), 3, 1)
        library_ms = graph_ms(library)
        bound, _ = bound_ms(nbytes)
        plan = kup.plan_of(dy, in_hw, kup.layout_of(dy))
        print(f"kernel upsample_bilinear_bwd {where} ({BATCH}, {c}) {out_hw} -> {in_hw} bf16 ({layout}, layout "
              f"{kup.layout_of(dy)}): max |diff| against f64 {err:.3e} (PyTorch's backward {aten_err:.3e}); "
              f"{ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, {bound / ms:.3f} of the bound; "
              f"{stream_ms:.4f} ms launched back to back), plain {plain_ms:.4f} ms, PyTorch's backward "
              f"{library_ms:.4f} ms, bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB), host {us:.1f} us per "
              f"launch; plan {plan}")
        for step, count in (("flagship", per_flagship), ("DeepLabV2", per_deeplab)):
            for k, v in enumerate((ms, plain_ms, library_ms, bound)):
                steps[step][k] += count * v
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["library_ms"] += library_ms
        out["bound_ms"] += bound
        del dy
    for step, (ms, plain_ms, library_ms, bound) in steps.items():
        print(f"kernel upsample_bilinear_bwd per {step} step: {ms:.4f} ms kernel ({bound / ms:.3f} of the bound), "
              f"{plain_ms:.4f} ms plain, {library_ms:.4f} ms PyTorch's backward, {bound:.4f} ms bound")
    return out


def cold_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call of ``fn`` with the L2 cache
    flushed before each (a 128 MiB write): a CUDA graph of ``iters`` x (the
    write, ``fn``) replayed, less one of the writes alone."""
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=DEV)

    def flushed():
        flush.zero_()
        fn()

    return graph_ms(flushed, iters) - graph_ms(flush.zero_, iters)


def _bn_operands(c, h, w, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = (torch.randn((BATCH, c, h, w), generator=g, device=DEV) * 1.5
         + torch.randn((1, c, 1, 1), generator=g, device=DEV)).to(dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.randn((BATCH, c, h, w), generator=g, device=DEV).to(dtype).contiguous(memory_format=torch.channels_last)
    weight = 1 + 0.2 * torch.randn(c, generator=g, device=DEV)
    bias = 0.1 * torch.randn(c, generator=g, device=DEV)
    stats = (0.1 * torch.randn(c, generator=g, device=DEV), 1 + 0.1 * torch.rand(c, generator=g, device=DEV))
    return x, dy, weight, bias, stats


def _bn_step(fn, x, dy, weight, bias, stats, relu):
    """A forward and backward of ``fn`` (``kbn.batch_norm_train`` or its
    plain version, or PyTorch's ``F.batch_norm``): (y, dx, dweight, dbias)."""
    xg = x.detach().requires_grad_(True)
    wg, bg = weight.detach().requires_grad_(True), bias.detach().requires_grad_(True)
    y = fn(xg, wg, bg, *stats, relu)
    return (y.detach(), *torch.autograd.grad(y, (xg, wg, bg), dy))


def _bn_kernel(x, w, b, rm, rv, relu):
    return kbn.batch_norm_train(x, w, b, rm, rv, eps=BN_EPS, momentum=BN_MOMENTUM, update=True, relu=relu)


def _bn_plain(x, w, b, rm, rv, relu):
    return kbn.batch_norm_train_plain(x, w, b, rm, rv, eps=BN_EPS, momentum=BN_MOMENTUM, update=True, relu=relu)


def _bn_library(x, w, b, rm, rv, relu):
    y = torch.nn.functional.batch_norm(x, rm, rv, w, b, training=True, momentum=1 - BN_MOMENTUM, eps=BN_EPS)
    return torch.relu(y) if relu else y


def _bn_f64_grads(dy, x, weight, bias, mask):
    """f64 autograd of the forward's expressions without rounding, the
    ReLU's mask fixed (None: no ReLU)."""
    x64 = x.detach().double().requires_grad_(True)
    w64, b64 = weight.double().requires_grad_(True), bias.double().requires_grad_(True)
    mean, var, _ = kbn.statistics(x64)
    z = kbn.apply_scale_shift(x64, *kbn.scale_shift(w64, b64, mean, var, BN_EPS))
    return torch.autograd.grad(z, (x64, w64, b64), dy.double() if mask is None else dy.double() * mask)


def _bn_check(where, x, dy, weight, bias, stats, relu) -> float:
    """The four BatchNorm kernels against f64 at one shape, as the cuda
    tests hold them: the mean within 1e-5 of E|x| and invstd within 2e-5
    relative of f64 sums; y the plain apply's bits from the kernels' mul
    and add; dx, dweight and dbias no further from f64 autograd than
    autograd of the plain version, plus one bf16 ulp of the largest
    gradient (1e-5 of it in f32). Returns dx's largest error."""
    y, coef = kbn.batch_norm_forward(x, weight, bias, stats[0].clone(), stats[1].clone(), eps=BN_EPS,
                                     momentum=BN_MOMENTUM, update=True, relu=relu)
    x64 = x.double()
    mean64 = x64.mean(dim=(0, 2, 3))
    invstd64 = torch.rsqrt(x64.square().mean(dim=(0, 2, 3)) - mean64.square() + BN_EPS)
    mean_err = (coef[0].double() - mean64).abs().max().item() / x64.abs().mean().item()
    invstd_err = ((coef[1].double() - invstd64) / invstd64).abs().max().item()
    del x64
    plain_y = kbn.apply_scale_shift(x, coef[2], coef[3])
    against_plain(f"batchnorm {where} y", y, torch.relu(plain_y) if relu else plain_y)
    errs = {}
    for path, fn in (("kernel", _bn_kernel), ("plain", _bn_plain)):
        run = _bn_step(fn, x, dy, weight, bias, stats, relu)
        want = _bn_f64_grads(dy, x, weight, bias, (run[0] > 0) if relu else None)
        errs[path] = [((g.double() - w_).abs().max().item(), w_.abs().max().item()) for g, w_ in zip(run[1:], want)]
    slack = [2.0 ** (math.frexp(top)[1] - 9) if x.dtype == torch.bfloat16 else 1e-5 * top
             for _, top in errs["kernel"]]
    print(f"kernel batchnorm {where} {tuple(x.shape)} {x.dtype} relu={relu}: mean error {mean_err:.2e} of E|x|, "
          f"invstd {invstd_err:.2e} relative; y the plain apply's bits; largest errors against f64 (dx, dweight, "
          "dbias) kernel " + ", ".join(f"{e:.3e}" for e, _ in errs["kernel"]) + " / plain autograd "
          + ", ".join(f"{e:.3e}" for e, _ in errs["plain"]))
    if mean_err > 1e-5 or invstd_err > 2e-5 or any(
            k[0] > p[0] + sl for k, p, sl in zip(errs["kernel"], errs["plain"], slack)):
        raise AssertionError(f"the BatchNorm kernels ({where}) fail their gates")
    return errs["kernel"][0][0]


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


# the BatchNorm kernels' passes, in the order a forward and backward runs them
BN_PASSES = ("stats", "finish_stats", "apply", "grad_sums", "finish_grad", "dx")


def _bn_pass(name: str):
    """The pass of the BatchNorm kernels a trace's kernel ``name`` is
    (``BN_PASSES``), None for any other kernel."""
    m = re.search(r"batchnorm_(sums|finish_stats|finish_grad|map)\b", name)
    if m is None:
        return None
    if m.group(1).startswith("finish"):
        return m.group(1)
    grad = re.search(r"batchnorm_\w+<[^>]*true>", name) is not None
    return {"sums": ("stats", "grad_sums"), "map": ("apply", "dx")}[m.group(1)][grad]


def _bn_pass_ms(step, iters: int = 10) -> dict:
    """Device ms per call of each pass (``BN_PASSES``) that ``step`` (a
    forward and backward) runs, from a torch.profiler trace of ``iters``
    steps grouped by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    out = dict.fromkeys(BN_PASSES, 0.0)
    for e in prof.key_averages():
        which = _bn_pass(e.key) if e.device_type == DeviceType.CUDA else None
        if which is not None:
            out[which] += _device_us(e) / 1e3 / iters
    if min(out.values()) <= 0:
        raise AssertionError(f"the trace shows no device time for a pass of the BatchNorm kernels: {out}")
    return out


def worker_bn_passes(out: str) -> None:
    """Phase 3's per-pass BatchNorm times (``_bn_pass_ms``) at each of
    ``BN_SHAPES``, written to ``out``: in a process of their own, so that
    no profiler session runs in the process whose launches the phases
    time."""
    times = {}
    for i, (where, c, h, w, dtype, relu) in enumerate(BN_SHAPES):
        x, dy, weight, bias, stats = _bn_operands(c, h, w, dtype, 600 + i)
        times[where] = _bn_pass_ms(lambda: _bn_step(_bn_kernel, x, dy, weight, bias, stats, relu))
    with open(out, "w") as f:
        json.dump(times, f)


def _bn_times(x, dy, weight, bias, stats, relu) -> dict:
    """The forward and the backward (graph replay, and with a cold L2), the
    plain version's and PyTorch's ``F.batch_norm`` (+ ReLU) forward and
    backward, ms; the host's us a forward and backward, the kernels' and
    the plain version's."""
    rm, rv = stats[0].clone(), stats[1].clone()
    _, coef = kbn.batch_norm_forward(x, weight, bias, rm, rv, eps=BN_EPS, momentum=BN_MOMENTUM, update=True,
                                     relu=relu)
    whole = {
        "forward": functools.partial(kbn.batch_norm_forward, x, weight, bias, rm, rv, eps=BN_EPS,
                                     momentum=BN_MOMENTUM, update=True, relu=relu),
        "backward": functools.partial(kbn.batch_norm_backward, dy, x, weight, coef, relu=relu),
    }
    out = {}
    for name, fn in whole.items():
        out[name] = graph_ms(fn)
        out[name + "_cold"] = cold_ms(fn)
    out["host_us"] = host_us(lambda: _bn_step(_bn_kernel, x, dy, weight, bias, stats, relu))
    out["plain_host_us"] = host_us(lambda: _bn_step(_bn_plain, x, dy, weight, bias, stats, relu))
    for name, fn in (("kernel_step", _bn_kernel), ("plain_step", _bn_plain), ("library_step", _bn_library)):
        out[name] = cuda_ms(lambda: _bn_step(fn, x, dy, weight, bias, (rm, rv), relu), 5, 1)
    return out


def phase_batchnorm_kernels() -> dict:
    """Train-mode BatchNorm + ReLU (``kernels/batchnorm.py``) at the main
    path's shapes (``BN_SHAPES``), bf16 channels_last and the f32 gate.
    Each pass timed inside a forward and backward (``worker_bn_passes``)
    beside its HBM bound (the statistics read x: 2 bytes an element in
    bf16; the apply reads x and writes y: 4; the gradient's sums read dy
    and x: 4; dx reads dy and x and writes dx: 6); the forward and backward
    (graph replay, and with a cold L2) beside the plain version's and
    PyTorch's ``F.batch_norm`` (the yardstick; the port never calls it),
    after ``_bn_check`` holds the kernels to f64 there. Then DeepLabV2's
    104 a step (``BN_DEEPLAB_STEP``), timed by shape. Returns, for the
    kernels line, the sums over one DeepLabV2 step."""
    max_err = 0.0
    for i, (where, c, h, w, dtype, relu) in enumerate(BN_SHAPES):
        ops = _bn_operands(c, h, w, dtype, 600 + i)
        x = ops[0]
        max_err = max(max_err, _bn_check(where, *ops, relu))
        t = _bn_times(*ops, relu)
        e = x.element_size()
        bound = 8 * e * x.numel() / HBM_BYTES_S * 1e3
        print(f"kernel batchnorm {where}: forward {t['forward']:.4f} + backward {t['backward']:.4f} ms "
              f"(cold {t['forward_cold']:.4f} + {t['backward_cold']:.4f}) against the bound {bound:.4f} ms "
              f"({8 * e} bytes an element); forward and backward launched: kernels {t['kernel_step']:.4f} ms, "
              f"plain {t['plain_step']:.4f} ms, F.batch_norm {t['library_step']:.4f} ms; host {t['host_us']:.1f} us "
              f"a forward and backward (plain {t['plain_host_us']:.1f} us); plans {kbn.plan_of(x, False)} and "
              f"{kbn.plan_of(x, True)}")
        del ops, x
    out = os.path.join("build", "chip_smoke_bn_passes.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", "bn_passes", out],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the BatchNorm passes' worker failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out) as f:
        passes = json.load(f)
    for where, c, h, w, dtype, _ in BN_SHAPES:
        t, n, e = passes[where], BATCH * c * h * w, torch.finfo(dtype).bits // 8
        bounds = {"stats": e * n, "apply": 2 * e * n, "grad_sums": 2 * e * n, "dx": 3 * e * n}
        print(f"kernel batchnorm {where}, passes in a forward and backward (a profiler trace): "
              + ", ".join(f"{p} {t[p]:.4f} ms ({bounds[p] / HBM_BYTES_S * 1e3 / t[p]:.2f} of its bound)"
                          for p in bounds)
              + f", finishing passes {t['finish_stats']:.4f} + {t['finish_grad']:.4f} ms")
    step = {"ms": 0.0, "cold_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for c, h, w, count in BN_DEEPLAB_STEP:
        ops = _bn_operands(c, h, w, torch.bfloat16, c + h)
        t = _bn_times(*ops, True)
        bound = 16 * ops[0].numel() / HBM_BYTES_S * 1e3
        print(f"kernel batchnorm DeepLabV2 ({BATCH}, {c}, {h}, {w}) x{count}: forward + backward "
              f"{t['forward'] + t['backward']:.4f} ms (cold {t['forward_cold'] + t['backward_cold']:.4f}), "
              f"plain {t['plain_step']:.4f}, F.batch_norm {t['library_step']:.4f}, bound {bound:.4f}")
        for key, v in (("ms", t["forward"] + t["backward"]), ("cold_ms", t["forward_cold"] + t["backward_cold"]),
                       ("plain_ms", t["plain_step"]), ("library_ms", t["library_step"]), ("bound_ms", bound)):
            step[key] += count * v
        del ops
    print(f"kernel batchnorm per DeepLabV2 step (104 calls): {step['ms']:.3f} ms kernels "
          f"({step['bound_ms'] / step['ms']:.2f} of the bound; cold {step['cold_ms']:.3f}), plain "
          f"{step['plain_ms']:.3f} ms, F.batch_norm {step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return {"ms": step["ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
            "bound_ms": step["bound_ms"], "max_abs_err": max_err, "bound_by": "bytes"}


def _ln_operands(rows, c, seed, dtype=torch.bfloat16):
    """Rows off-centre each (as a residual stream's are), weight, bias and
    an output gradient, on the card."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = (torch.randn((rows, c), generator=g, device=DEV) * 1.5
         + torch.randn((rows, 1), generator=g, device=DEV)).to(dtype)
    dy = torch.randn((rows, c), generator=g, device=DEV).to(dtype)
    weight = 1 + 0.2 * torch.randn(c, generator=g, device=DEV)
    bias = 0.1 * torch.randn(c, generator=g, device=DEV)
    return x, dy, weight, bias


def _ulps(got, want) -> float:
    """The largest |got - want| over the elements, each in ulps of ``got``'s
    dtype at the f64 ``want``."""
    _, e = torch.frexp(want)  # want in [2^(e-1), 2^e)
    ulp = torch.ldexp(torch.full_like(want, torch.finfo(got.dtype).eps), e - 1)
    return ((got.double() - want).abs() / ulp).max().item()


def _ln_check(where, x, dy, weight, bias) -> tuple[float, float, float]:
    """The LayerNorm kernels at one shape, as the cuda tests hold them: y
    within one bf16 ulp, plus 1e-6 of the largest, of the plain version's
    (where y nearly cancels to 0 both are several ulps of it from f64);
    mean within 1e-5 of E|x|
    and rstd within 2e-5 relative of f64; dx within one bf16 ulp (+ 1e-6
    of the largest) of the backward's expressions in f64; dweight and
    dbias within 1e-5 of the f64 sums of their terms' magnitudes. Returns
    dx's largest error, and the largest y error in ulps against the
    function in f64 of the kernels and of the plain version
    (``F.layer_norm``)."""
    y, mean, rstd = kln.layer_norm_forward(x, weight, bias, LN_EPS)
    plain = kln.layer_norm_plain(x, weight, bias, LN_EPS)
    against_plain(f"layernorm {where} y", y, plain, 1e-6)
    y64 = kln.layer_norm_plain(x.double(), weight.to(x.dtype).float(), bias.to(x.dtype).float(), LN_EPS)
    y_ulps, plain_ulps = _ulps(y, y64), _ulps(plain, y64)
    mean64, rstd64 = kln.row_stats_plain(x, LN_EPS)
    mean_err = (mean.double() - mean64).abs().max().item() / x.double().abs().mean().item()
    rstd_err = ((rstd.double() - rstd64) / rstd64).abs().max().item()
    dx, dweight, dbias = kln.layer_norm_backward(dy, x, weight, mean, rstd)
    want = kln.layer_norm_grad_plain(dy, x, weight, mean64, rstd64)
    err = against_plain(f"layernorm {where} dx", dx, want[0], 1e-6)
    xh = (x.double() - mean64.unsqueeze(-1)) * rstd64.unsqueeze(-1)
    scales = ((dy.double() * xh).abs().sum(0), dy.double().abs().sum(0))
    param_err = max(((got.double() - w).abs() / s).max().item() for got, w, s in zip((dweight, dbias), want[1:], scales))
    print(f"kernel layernorm {where} {tuple(x.shape)} {x.dtype}: y within one bf16 ulp of the plain version's; mean "
          f"error {mean_err:.2e} of E|x|, rstd {rstd_err:.2e} relative; dx max |diff| against f64 {err:.3e}; "
          f"dweight, dbias {param_err:.2e} of their terms' magnitudes; y at most {y_ulps:.2f} ulps from f64 "
          f"(F.layer_norm {plain_ulps:.2f})")
    if mean_err > 1e-5 or rstd_err > 2e-5 or param_err > 1e-5:
        raise AssertionError(f"the LayerNorm kernels ({where}) fail their gates")
    return err, y_ulps, plain_ulps


def _ln_step(fn, x, dy, weight, bias):
    """A forward and backward of ``fn`` (the plain version, or
    ``F.layer_norm`` given the parameters in x's dtype) through autograd."""
    xg = x.detach().requires_grad_(True)
    wg, bg = weight.detach().requires_grad_(True), bias.detach().requires_grad_(True)
    y = fn(xg, wg, bg, LN_EPS)
    return torch.autograd.grad(y, (xg, wg, bg), dy)


def _ln_library(x, w, b, eps):
    return torch.nn.functional.layer_norm(x, w.shape, w, b, eps)


def _ln_b5_calls() -> tuple[int, int]:
    """The LayerNorm calls of one eager forward and backward of
    SegFormer-B5's encoder (``model.backbone``: no graph, whose replay
    counts its modules, not launches) at b8 512x1024 bf16, the counters
    set to 0 first: ``(calls, copies)``. Raises unless the forward and the
    backward each made ``LN_SHAPES``' 161."""
    model = build_model(ModelConfig(name="segformer", compute_dtype="bfloat16"), DEV, train=True)
    init_model(model, torch.Generator().manual_seed(0))
    x = torch.randn((BATCH, 3, H, W), device=DEV).to(torch.bfloat16)
    _zero_counters("layernorm.fwd_calls", "layernorm.bwd_calls", "layernorm.copies")
    tokens = [t for t, _ in model.backbone(x.contiguous(memory_format=torch.channels_last))]
    fwd = kln.fwd_calls
    sum(t.float().sum() for t in tokens).backward()
    torch.cuda.synchronize()
    calls, copies, want = fwd, kln.copies, sum(norms for *_, norms in LN_SHAPES)
    print(f"kernel layernorm in an eager SegFormer-B5 encoder forward and backward ({BATCH}, 3, {H}, {W}): "
          f"{fwd} forward, {kln.bwd_calls} backward calls, {copies} copies (LN_SHAPES: {want})")
    if not fwd == kln.bwd_calls == want:
        raise AssertionError(f"SegFormer-B5 ran {fwd} / {kln.bwd_calls} LayerNorms, LN_SHAPES says {want}")
    return calls, copies


def phase_layernorm_kernels() -> dict:
    """LayerNorm (``kernels/layernorm.py``) at SegFormer-B5's shapes
    (``LN_SHAPES``), bf16: held to the plain version and f64 by
    ``_ln_check``, then the forward and the backward replayed from a CUDA
    graph (and the two launched back to back) beside their byte bound
    (forward: read x, write y, 4 bytes an element; backward: read dy and x,
    write dx, 6), the plain version's forward and backward
    (``F.layer_norm`` on the parameters cast to bf16, with the casts) and
    PyTorch's own ``F.layer_norm`` on parameters already in bf16
    (``library_ms``; the port never calls it on a card), both replayed from
    a graph. Then the calls of an eager B5 encoder step (``_ln_b5_calls``).
    Returns, for the kernels line, the sums over one ``segb5-train`` step
    (161 norms each way), its measured calls and copies, and y's largest
    error in ulps against f64, the kernels' and ``F.layer_norm``'s."""
    step = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_err = y_ulps = library_y_ulps = 0.0
    for i, (where, rows, c, norms) in enumerate(LN_SHAPES):
        x, dy, weight, bias = _ln_operands(rows, c, 700 + i)
        err, ulps, plain_ulps = _ln_check(where, x, dy, weight, bias)
        max_err, y_ulps, library_y_ulps = max(max_err, err), max(y_ulps, ulps), max(library_y_ulps, plain_ulps)
        _, mean, rstd = kln.layer_norm_forward(x, weight, bias, LN_EPS)
        forward = functools.partial(kln.layer_norm_forward, x, weight, bias, LN_EPS)
        backward = functools.partial(kln.layer_norm_backward, dy, x, weight, mean, rstd)

        def both():
            forward()
            backward()

        fwd_ms, bwd_ms, stream_ms = graph_ms(forward), graph_ms(backward), cuda_ms(both, 20)
        xg = x.detach().requires_grad_(True)
        wg, bg = weight.detach().requires_grad_(True), bias.detach().requires_grad_(True)
        us = host_us(lambda: torch.autograd.grad(kln.layer_norm(xg, wg, bg, LN_EPS), (xg, wg, bg), dy))
        plain_ms = graph_ms(lambda: _ln_step(kln.layer_norm_plain, x, dy, weight, bias))
        library_ms = graph_ms(lambda: _ln_step(_ln_library, x, dy, weight.to(x.dtype), bias.to(x.dtype)))
        e = x.element_size()
        fwd_bound, bwd_bound = 2 * e * x.numel() / HBM_BYTES_S * 1e3, 3 * e * x.numel() / HBM_BYTES_S * 1e3
        ms = fwd_ms + bwd_ms
        print(f"kernel layernorm {where} ({rows}, {c}) x{norms}: forward {fwd_ms:.4f} ms "
              f"({fwd_bound / fwd_ms:.2f} of its bound {fwd_bound:.4f}), backward {bwd_ms:.4f} ms "
              f"({bwd_bound / bwd_ms:.2f} of {bwd_bound:.4f}); launched back to back {stream_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms, F.layer_norm {library_ms:.4f} ms; host {us:.1f} us a forward and backward; plan "
              f"{kln.plan_of(x)}")
        for key, v in (("ms", ms), ("stream_ms", stream_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                       ("bound_ms", fwd_bound + bwd_bound)):
            step[key] += norms * v
        del x, dy, mean, rstd, xg
    torch.cuda.empty_cache()
    calls, copies = _ln_b5_calls()
    print(f"kernel layernorm per segb5-train step ({calls} norms each way): {step['ms']:.3f} ms kernels "
          f"({step['bound_ms'] / step['ms']:.2f} of the bound; launched back to back {step['stream_ms']:.3f}), plain "
          f"{step['plain_ms']:.3f} ms, F.layer_norm {step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms; "
          f"y at most {y_ulps:.2f} ulps from f64 (F.layer_norm {library_y_ulps:.2f})")
    torch.cuda.empty_cache()
    return {"ms": step["ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
            "bound_ms": step["bound_ms"], "max_abs_err": max_err, "bound_by": "bytes", "calls": calls,
            "copies": copies, "y_ulps": y_ulps, "library_y_ulps": library_y_ulps}


def _frames(seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (BATCH, H, W, 3), np.uint8)).to(DEV)


def _check_masks(masks, what):
    if masks.dtype != torch.uint8 or tuple(masks.shape) != (BATCH, H, W):
        raise AssertionError(f"{what}: masks {masks.dtype} {tuple(masks.shape)}")
    if int(masks.max()) >= 19:
        raise AssertionError(f"{what}: mask value {int(masks.max())} >= 19")


def _card_vs_cpu_f32_forward(what, cfg, cpu_vars, shape) -> None:
    """The f32 forward on the card against the CPU's, on a small input (TF32
    off): within 1e-3 * max |logit|, argmax agreement >= 0.999."""
    aug = AugmentConfig()
    small = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (*shape, 3), np.uint8))
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    card_vars = {k: v.to(DEV) for k, v in cpu_vars.items()}
    lg_gpu = make_serving_fn(f32, aug, card_vars, "f32", device=DEV).logits(small).cpu()
    lg_cpu = make_serving_fn(f32, aug, cpu_vars, "f32", device="cpu").logits(small)
    f32_err = (lg_gpu - lg_cpu).abs().max().item()
    scale = lg_cpu.abs().max().item()
    agree_small = (lg_gpu.argmax(1) == lg_cpu.argmax(1)).float().mean().item()
    print(f"{what} f32 forward, card vs CPU at {'x'.join(map(str, shape))}: max |diff| {f32_err:.3e} "
          f"(max |logit| {scale:.3e}), argmax agreement {agree_small:.6f}")
    if not f32_err <= 1e-3 * scale or agree_small < 0.999:
        raise AssertionError(f"{what}: the f32 forward on the card disagrees with the CPU's")


@contextlib.contextmanager
def _each_launch_checked(module, name):
    """Run ``module.<name>`` and, on the same operands, its plain version;
    every bf16 output must be within one bf16 ulp + 1e-5 * max |ref| of
    the plain version's (``against_plain``: where an output cancels to far
    below its terms, the f32 sums' order moves it by more than a bf16 ulp
    of itself before it is rounded). Yields the list of the launches' max
    |diff|."""
    kernel, plain = getattr(module, name), getattr(module, name + "_plain")
    errs = []

    def checked(*args, **kw):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        if got.dtype != want.dtype:
            raise AssertionError(f"{name} launch {len(errs)}: {got.dtype}, its plain version {want.dtype}")
        errs.append(against_plain(f"{name} launch {len(errs)} ({tuple(got.shape)})", got, want, 1e-5))
        return got

    setattr(module, name, checked)
    try:
        yield errs
    finally:
        setattr(module, name, kernel)


def _mask_agreement(masks, logits_ref, masks_ref) -> tuple:
    """(share of pixels where ``masks`` equal ``masks_ref``, the same share
    over the pixels whose reference top-2 logits lie more than 2 bf16 ulps
    apart, that pixel share)."""
    same = decided = n_decided = 0.0
    for m, lg, ref in zip(masks, logits_ref, masks_ref):
        top2 = lg.float().topk(2, dim=1).values
        ulp = torch.ldexp(torch.ones_like(top2[:, 0]), torch.frexp(top2[:, 0].abs())[1] - 8)
        sure = (top2[:, 0] - top2[:, 1]) > 2 * ulp
        eq = m == ref
        same += eq.float().mean().item()
        decided += (eq & sure).float().sum().item()
        n_decided += sure.float().sum().item()
    return same / len(masks), decided / max(n_decided, 1.0), n_decided / (len(masks) * masks[0].numel())


def _k4_serving(what, cfg, variables, requests, convs: int) -> int:
    """bf16 serving of one model with ``fused_conv3`` off (cuDNN) and on
    (K4): valid masks and finite logits both ways, ``convs`` K4 launches per
    request, every K4 launch of a request within one bf16 ulp (+ 1e-5 *
    max |ref|) of its plain version on the same operands, and K4's masks
    >= 0.995 equal to those with K4 swapped for its plain version at the
    pixels whose plain top-2 logits lie more than 2 bf16 ulps apart. Not
    0.999 of all pixels: the random models' bf16 logits tie or nearly tie
    at up to 13% of the pixels, where a one-ulp difference in one conv,
    which any kernel that sums in another order than its plain version
    makes, flips the argmax (PERF.md, section 6). Returns the K4 launches of
    the requests."""
    aug = AugmentConfig()
    serve = make_serving_fn(cfg, aug, variables, "bf16", device=DEV)
    serve_k4 = make_serving_fn(cfg, aug, variables, "bf16", device=DEV, fused_conv3=True)
    masks = [serve(x) for x in requests]
    # the main path: K4's launches during the fused requests only
    _zero_counters("conv3x3.launches", "conv3x3.copies")
    masks_k4 = [serve_k4(x) for x in requests]
    torch.cuda.synchronize()
    launches = k4.launches
    print(f"{what} bf16 serving with fused_conv3: {launches} K4 launches over {REQUESTS} requests, "
          f"{k4.copies} operand copies")
    if launches != convs * REQUESTS:
        raise AssertionError(f"{what}: expected {convs * REQUESTS} K4 launches, got {launches}")
    if k4.copies:
        raise AssertionError(f"{what}: the model path made {k4.copies} K4 operand copies")
    for m in masks + masks_k4:
        _check_masks(m, what)
    for fn in (serve, serve_k4):
        if not bool(torch.isfinite(fn.logits(requests[0])).all()):
            raise AssertionError(f"{what}: non-finite logits")
    with _each_launch_checked(k4, "conv3x3") as errs:
        serve_k4(requests[0])
    print(f"{what}: each of one request's {len(errs)} K4 launches within 1 bf16 ulp of its plain version "
          f"on the same operands (max |diff| {max(errs):.3e})")
    if len(errs) != convs:
        raise AssertionError(f"{what}: checked {len(errs)} K4 launches, expected {convs}")
    with plain_versions(CONV3_KERNELS):
        logits_plain = [serve_k4.logits(x) for x in requests]
    masks_plain = [lg.argmax(1).to(torch.uint8) for lg in logits_plain]
    agree, agree_sure, sure = _mask_agreement(masks_k4, logits_plain, masks_plain)
    agree_cudnn = float(np.mean([(a == b).float().mean().item() for a, b in zip(masks_k4, masks)]))
    print(f"{what} K4 masks vs the plain-version K4 masks: agreement {agree:.6f}, {agree_sure:.6f} over "
          f"the {sure:.4f} of pixels whose plain top-2 logits lie > 2 bf16 ulps apart; vs the cuDNN path "
          f"(random weights, informational): {agree_cudnn:.6f}")
    if agree_sure < 0.995:
        raise AssertionError(f"{what}: the K4 path agrees with its plain version on only {agree_sure:.6f} "
                             "of the decided pixels")
    return launches


@contextlib.contextmanager
def k3_plain():
    """K3 swapped for its plain version, which needs no K-major weights."""
    kernel = k3.int8_conv
    k3.int8_conv = lambda *args, kmajor=None, **kw: k3.int8_conv_plain(*args, **kw)
    try:
        yield
    finally:
        k3.int8_conv = kernel


def phase_slice() -> tuple:
    aug = AugmentConfig()
    cfg = ModelConfig(compute_dtype="bfloat16")
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    _card_vs_cpu_f32_forward("BiSeNet-R18", cfg, variables, (2, 64, 128))
    variables = {k: v.to(DEV) for k, v in variables.items()}

    t0 = time.perf_counter()
    calib = [normalize_u8(_frames(s), aug) for s in (1, 2)]
    variables = freeze(cfg, calibrate(cfg, variables, calib, device=DEV))
    torch.cuda.synchronize()
    print(f"calibrate (2 x {BATCH} frames) + freeze: {time.perf_counter() - t0:.2f} s")

    serve_bf16 = make_serving_fn(cfg, aug, variables, "bf16", device=DEV)
    serve_int8 = make_serving_fn(cfg, aug, variables, "int8", device=DEV)
    requests = [_frames(100 + r) for r in range(REQUESTS)]

    masks_bf16 = [serve_bf16(x) for x in requests]
    # the main path: the kernel's launches during the int8 requests only
    _zero_counters("int8_conv.launches", "int8_conv.copies")
    masks_int8 = [serve_int8(x) for x in requests]
    torch.cuda.synchronize()
    launches = k3.launches
    print(f"int8 serving: {launches} kernel launches over {REQUESTS} requests, {k3.copies} operand copies")
    if launches != QUANT_CONVS * REQUESTS:
        raise AssertionError(f"expected {QUANT_CONVS * REQUESTS} kernel launches, got {launches}")
    if k3.copies:
        raise AssertionError(f"the int8 model path made {k3.copies} K3 operand copies")
    for what, masks in (("bf16", masks_bf16), ("int8", masks_int8)):
        for m in masks:
            _check_masks(m, what)
        lg = (serve_bf16 if what == "bf16" else serve_int8).logits(requests[0])
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{what}: non-finite logits")

    before = k3.launches
    with k3_plain():
        masks_plain = [serve_int8(x) for x in requests]
    torch.cuda.synchronize()
    print(f"int8 serving with K3 swapped for its plain version: {k3.launches - before} K3 launches "
          f"over {REQUESTS} requests")
    if k3.launches != before:
        raise AssertionError("the k3_plain seam still launched K3")
    agree_plain = float(np.mean([(a == b).float().mean().item() for a, b in zip(masks_int8, masks_plain)]))
    agree_bf16 = float(np.mean([(a == b).float().mean().item() for a, b in zip(masks_int8, masks_bf16)]))
    print(f"int8 masks vs the plain-version int8 masks: agreement {agree_plain:.6f}")
    print(f"int8 vs bf16 mask agreement (random weights, informational): {agree_bf16:.6f}")
    if agree_plain < 0.999:
        raise AssertionError(f"int8 kernel path agrees with its plain version on only {agree_plain:.6f}")
    k4_launches = _k4_serving("BiSeNet-R18", cfg, variables, requests, K4_CONVS["r18"])
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, k4_launches


# the artifact phase: (label, precision, fused_conv3) of the R18 artifacts
# exported on the card, each with a symbolic batch
ARTIFACT_KINDS = (("R18 bf16", "bf16", False), ("R18 int8", "int8", False),
                  ("R18 bf16 fused_conv3", "bf16", True))


def _artifact(cfg, variables, precision, fused, export_device) -> tuple:
    """Export with a symbolic batch on ``export_device``, save into a
    temporary directory under build/, load onto the card. Returns (the
    loaded fn, {export_s, load_s, mb})."""
    aug = AugmentConfig()
    t0 = time.perf_counter()
    exported, meta = export_serving(cfg, aug, variables, H, W, precision=precision, fused_conv3=fused,
                                    device=export_device)
    export_s = time.perf_counter() - t0
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as path:
        save_artifact(path, exported, meta)
        mb = os.path.getsize(os.path.join(path, ARTIFACT_GRAPH)) / 1e6
        t0 = time.perf_counter()
        fn, loaded = load_artifact(path, device=DEV)
        load_s = time.perf_counter() - t0
    if loaded["platforms"] != [torch.device(export_device).type] or loaded["batch"] is not None:
        raise AssertionError(f"artifact meta {loaded}")
    return fn, {"export_s": export_s, "load_s": load_s, "mb": mb}


def _artifact_requests(what, fn, eager, requests, k3_per, k4_per) -> tuple:
    """Serve ``requests`` and one b1 request through the artifact ``fn``:
    masks bit-equal to the eager path's, exactly ``k3_per`` K3 and
    ``k4_per`` K4 launches a request and no operand copy. Returns the K3
    and K4 launches."""
    masks_eager = [eager(x) for x in requests] + [eager(requests[0][:1])]
    # the main path: the kernels' launches during the artifact's requests only
    _zero_counters("int8_conv.launches", "int8_conv.copies", "conv3x3.launches", "conv3x3.copies")
    masks = [fn(x) for x in requests] + [fn(requests[0][:1])]
    torch.cuda.synchronize()
    n3, n4 = k3.launches, k4.launches
    n = len(masks)
    print(f"{what} artifact: {n3} K3 and {n4} K4 launches over {n} requests (the last at b1), "
          f"{k3.copies + k4.copies} operand copies")
    if (n3, n4) != (k3_per * n, k4_per * n) or k3.copies or k4.copies:
        raise AssertionError(f"{what} artifact: expected {k3_per * n} K3 and {k4_per * n} K4 launches and no "
                             f"operand copy, got {n3}, {n4}, copies {k3.copies + k4.copies}")
    for m, want in zip(masks, masks_eager):
        if m.dtype != torch.uint8 or m.shape != want.shape or not torch.equal(m, want):
            raise AssertionError(f"{what} artifact: masks differ from the eager path's")
    for m in masks[:-1]:
        _check_masks(m, what)
    print(f"{what} artifact: masks of {n} requests bit-equal to make_serving_fn's")
    return n3, n4


def phase_artifact() -> tuple:
    """Serving artifacts at b8 512x1024, seeded random weights: BiSeNet-R18
    in bf16, int8 (calibrated on 2 batches) and bf16 with fused_conv3,
    exported on the card with a symbolic batch, saved, loaded and served;
    then DeepLabV2 int8, calibrated and frozen on the card, exported on the
    CPU and served on the card. Returns the K3 and K4 launches."""
    aug = AugmentConfig()
    requests = [_frames(400 + r) for r in range(REQUESTS)]
    calib = [normalize_u8(_frames(s), aug) for s in (1, 2)]
    launches3 = launches4 = 0
    cfg = ModelConfig(compute_dtype="bfloat16")
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    variables = {k: v.to(DEV) for k, v in variables.items()}
    calibrated = calibrate(cfg, variables, calib, device=DEV)
    for what, precision, fused in ARTIFACT_KINDS:
        v = calibrated if precision == "int8" else variables
        fn, info = _artifact(cfg, v, precision, fused, DEV)
        print(f"{what} artifact exported on the card in {info['export_s']:.2f} s, loaded in "
              f"{info['load_s']:.2f} s, {info['mb']:.1f} MB on disk")
        eager = make_serving_fn(cfg, aug, v, precision, device=DEV, fused_conv3=fused)
        n3, n4 = _artifact_requests(what, fn, eager, requests, QUANT_CONVS if precision == "int8" else 0,
                                    K4_CONVS["r18"] if fused else 0)
        launches3, launches4 = launches3 + n3, launches4 + n4
        del fn, eager
    del variables, calibrated

    what = "DeepLabV2 int8 (exported on the CPU)"
    cfg = ModelConfig(name="deeplabv2", compute_dtype="bfloat16")
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    variables = {k: v.to(DEV) for k, v in variables.items()}
    frozen = freeze(cfg, calibrate(cfg, variables, calib, device=DEV))
    eager = make_serving_fn(cfg, aug, frozen, "int8", device=DEV)
    fn, info = _artifact(cfg, {k: v.cpu() for k, v in frozen.items()}, "int8", False, "cpu")
    print(f"{what}: exported in {info['export_s']:.2f} s, moved to the card and loaded in {info['load_s']:.2f} s, "
          f"{info['mb']:.1f} MB on disk")
    n3, _ = _artifact_requests(what, fn, eager, requests, R101_QUANT_CONVS["deeplabv2"], 0)
    del fn, eager, variables, frozen
    return launches3 + n3, launches4


def phase_r101() -> int:
    """BiSeNet-R101 and DeepLabV2 served in bf16 on cuDNN and on K4; returns
    the K4 launches of both."""
    requests = [_frames(200 + r) for r in range(REQUESTS)]
    launches = 0
    for what, key, fields, small in (
            ("BiSeNet-R101", "r101", dict(context_path="resnet101"), (2, 64, 128)),
            ("DeepLabV2", "deeplabv2", dict(name="deeplabv2"), (1, 65, 129))):
        cfg = ModelConfig(compute_dtype="bfloat16", **fields)
        variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
        _card_vs_cpu_f32_forward(what, cfg, variables, small)
        variables = {k: v.to(DEV) for k, v in variables.items()}
        torch.cuda.reset_peak_memory_stats()
        launches += _k4_serving(what, cfg, variables, requests, K4_CONVS[key])
        print(f"{what}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del variables
    return launches


@contextlib.contextmanager
def _dilated_launches_checked():
    """K3's first launch at each dilation above 1, held bit-exact against
    its plain version on the same operands. Yields {dilation: the launch's
    (input shape, weight shape)}."""
    kernel = k3.int8_conv
    checked = {}

    def checked_call(*args, kmajor=None, **kw):
        out = kernel(*args, kmajor=kmajor, **kw)
        d = kw["dilation"]
        if d > 1 and d not in checked:
            want = k3.int8_conv_plain(*args, **kw)
            if not torch.equal(out, want):
                raise AssertionError(f"K3 at dilation {d} {tuple(args[0].shape)} differs from its plain version")
            checked[d] = (tuple(args[0].shape), tuple(args[1].shape))
        return out

    k3.int8_conv = checked_call
    try:
        yield checked
    finally:
        k3.int8_conv = kernel


def _k3_census(serve, request) -> tuple:
    """The shapes of K3's launches in one request, each with its count, in
    the form of ``R101_K3_SHAPES``."""
    kernel = k3.int8_conv
    seen = {}

    def recording(xq, wq, *args, stride, padding, dilation=1, **kw):
        key = (xq.shape[3], wq.shape[3], xq.shape[1], xq.shape[2], wq.shape[0], stride, padding, dilation)
        seen[key] = seen.get(key, 0) + 1
        return kernel(xq, wq, *args, stride=stride, padding=padding, dilation=dilation, **kw)

    k3.int8_conv = recording
    try:
        serve(request)
    finally:
        k3.int8_conv = kernel
    return tuple((*key, n) for key, n in sorted(seen.items()))


def phase_r101_int8() -> tuple:
    """BiSeNet-R101 and DeepLabV2 served in int8 at b8 512x1024: calibrated
    on 2 batches and frozen; exactly one K3 launch per quantized conv of a
    request and no operand copy; masks >= 0.999 equal to those with K3
    swapped for its plain version; DeepLabV2's first launch at d = 2 and at
    d = 4 bit-exact against the plain version; the non-frozen ``int8``
    model's masks equal to the frozen one's; K3's launches in a request
    those of ``R101_K3_SHAPES``. Then K3 at each of the request's shapes,
    as in phase 3. Returns (the K3 launches of both models' requests,
    {model: K3 per forward})."""
    aug = AugmentConfig()
    requests = [_frames(300 + r) for r in range(REQUESTS)]
    calib = [normalize_u8(_frames(s), aug) for s in (1, 2)]
    launches, times = 0, {}
    for what, key, fields in R101_MODELS:
        cfg = ModelConfig(compute_dtype="bfloat16", **fields)
        variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
        variables = {k: v.to(DEV) for k, v in variables.items()}
        t0 = time.perf_counter()
        calibrated = calibrate(cfg, variables, calib, device=DEV)
        frozen = freeze(cfg, calibrated)
        torch.cuda.synchronize()
        print(f"{what} calibrate (2 x {BATCH} frames) + freeze: {time.perf_counter() - t0:.2f} s")
        serve = make_serving_fn(cfg, aug, frozen, "int8", device=DEV)
        torch.cuda.reset_peak_memory_stats()
        # the main path: K3's launches during the int8 requests only
        _zero_counters("int8_conv.launches", "int8_conv.copies")
        masks = [serve(x) for x in requests]
        torch.cuda.synchronize()
        n, copies = k3.launches, k3.copies
        launches += n
        want = R101_QUANT_CONVS[key] * REQUESTS
        print(f"{what} int8 serving: {n} K3 launches over {REQUESTS} requests, {copies} operand copies")
        if n != want or copies:
            raise AssertionError(f"{what}: expected {want} K3 launches and no operand copy, got {n}, {copies}")
        for m in masks:
            _check_masks(m, what)
        if not bool(torch.isfinite(serve.logits(requests[0])).all()):
            raise AssertionError(f"{what}: non-finite int8 logits")
        with k3_plain():
            masks_plain = [serve(x) for x in requests[:2]]
        agree = float(np.mean([(a == b).float().mean().item() for a, b in zip(masks, masks_plain)]))
        print(f"{what} int8 masks vs the plain-version int8 masks (2 requests): agreement {agree:.6f}")
        if agree < 0.999:
            raise AssertionError(f"{what}: the int8 kernel path agrees with its plain version on only {agree:.6f}")
        if key == "deeplabv2":
            with _dilated_launches_checked() as checked:
                serve(requests[0])
            print(f"{what}: K3's first launches at dilation 2 and 4 bit-identical to the plain version: {checked}")
            if sorted(checked) != [2, 4]:
                raise AssertionError(f"{what}: checked dilated launches {sorted(checked)}, expected [2, 4]")
        live = quantized_model(cfg, frozen=False, device=DEV)
        load_variables(live, calibrated)
        with torch.inference_mode():
            masks_live = live(normalize_u8(requests[0], aug).to(torch.bfloat16).permute(0, 3, 1, 2)).argmax(1)
        same = (masks_live.to(torch.uint8) == masks[0]).float().mean().item()
        print(f"{what}: non-frozen int8 masks vs frozen: agreement {same:.6f}")
        if same != 1.0:
            raise AssertionError(f"{what}: the non-frozen int8 model's masks differ from the frozen model's")
        del live, masks_live
        print(f"{what} int8 serving: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        census = _k3_census(serve, requests[0])
        if census != R101_K3_SHAPES[key]:
            raise AssertionError(f"{what}: K3's launches in a request are not R101_K3_SHAPES[{key!r}]: {census}")
        times[key] = _k3_forward(what, [(f"{row[4]}x{row[4]}/s{row[5]}", *row) for row in census])
        del serve, variables, calibrated, frozen
    return launches, times


def _train_batch(b: int, h: int, w: int, seed: int, device) -> dict:
    """Synthetic uint8 frames and structured labels: classes in 64x128
    blocks (32x48 at small sizes), ~10% ignore, each frame the block
    colours plus noise."""
    rng = np.random.RandomState(seed)
    bh, bw = (64, 128) if h >= 256 else (32, 48)
    grid = rng.randint(0, CLASSES, (b, -(-h // bh), -(-w // bw)))
    labels = np.repeat(np.repeat(grid, bh, axis=1), bw, axis=2)[:, :h, :w].astype(np.int32)
    palette = rng.randint(0, 256, (CLASSES, 3))
    frames = 0.6 * palette[labels] + 0.4 * rng.randint(0, 256, (b, h, w, 3))
    labels[rng.rand(b, h, w) < 0.1] = 255
    return {"image": torch.from_numpy(frames.astype(np.uint8)).to(device),
            "label": torch.from_numpy(labels).to(device)}


def _train_setup(cfg, device, fused_conv1: bool = False):
    """A seeded G (and, in the adversarial modes, D) with their optimizers
    and schedules, and the step. DeepLabV2's optimizer freezes its
    BatchNorm affines, as the train loop builds it."""
    model = build_model(cfg.model, device=device, train=True)
    init_model(model, torch.Generator().manual_seed(0))
    sched = poly_lr_schedule(cfg.optimizer.learning_rate, MAX_ITER, cfg.optimizer.poly_power)
    tx = build_generator_tx(cfg.optimizer, model, freeze_bn=cfg.model.name == "deeplabv2", decay_exempt=EXEMPT)
    state = TrainState(model, tx, sched)
    if not cfg.adversarial.enabled:
        return state, make_train_step(cfg, sched)
    disc = build_discriminator(cfg.model, device=device, fused_conv1=fused_conv1)
    init_discriminator(disc, torch.Generator().manual_seed(1))
    state.discriminator, state.d_optimizer = disc, build_discriminator_tx(cfg.adversarial, disc)
    state.d_schedule = poly_lr_schedule(cfg.adversarial.disc_learning_rate, MAX_ITER, cfg.optimizer.poly_power)
    return state, make_train_step(cfg, sched, state.d_schedule)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


@contextlib.contextmanager
def plain_versions(kernels):
    """Swap each (module, wrapper) for the module's ``<wrapper>_plain``."""
    saved = [(m, name, getattr(m, name)) for m, name in kernels]
    for m, name, _ in saved:
        setattr(m, name, getattr(m, name + "_plain"))
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _kernels_vs_plain_step(state, step, batch, kernels) -> tuple:
    """From one saved state: the metrics of a step with the kernels and of a
    step with their plain versions swapped in."""
    modules = [(state.model, state.optimizer)]
    if state.discriminator is not None:
        modules.append((state.discriminator, state.d_optimizer))
    saved = [(copy.deepcopy(m.state_dict()), copy.deepcopy(o.state_dict())) for m, o in modules]
    step0 = state.step
    results = []
    for plain in (False, True):
        for (m, o), (ms, os_) in zip(modules, saved):
            m.load_state_dict(ms)
            o.load_state_dict(os_)
        state.step = step0
        with plain_versions(kernels if plain else ()):
            _, m = step(state, batch, torch.Generator(device=DEV).manual_seed(5))
        results.append({k: float(v) for k, v in m.items()})
    return tuple(results)


def _adversarial_batch(b, src_hw, tgt_hw, seed, device) -> dict:
    batch = _train_batch(b, *src_hw, seed, device)
    batch["target_image"] = _train_batch(b, *tgt_hw, seed + 1, device)["image"]
    return batch


def _card_vs_cpu_f32_step(cfg) -> None:
    """One f32 step at 2x64x96 on the card and on the CPU, TF32 off; no
    augmentation, whose draws differ between a CUDA and a CPU generator. An
    adversarial step uses the default discriminator (cuDNN conv1)."""
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                      augment=dataclasses.replace(cfg.augment, pipeline="no_new_aug"))
    adversarial = cfg.adversarial.enabled
    out = []
    for device in (DEV, torch.device("cpu")):
        state, step = _train_setup(cfg, device)
        batch = _adversarial_batch(2, (64, 96), (64, 96), 11, device) if adversarial else \
            _train_batch(2, 64, 96, 11, device)
        _, m = step(state, batch, torch.Generator(device=device))
        out.append({k: float(v) for k, v in m.items()})
    card, cpu = out
    # the losses within 1e-4; the grad norm within 1e-2: the train-form
    # BatchNorm's var = E[x^2] - mean^2 cancels in f32 over as few as 2 values
    # (the ARM gates, n = B) at this size, so the order of its sums moves
    # the gradient by up to a few 1e-3
    tols = {"loss": 1e-4, "loss_ce": 1e-4, "loss_lovasz": 1e-4, "grad_norm": 1e-2}
    if adversarial:
        tols.update({"loss_d": 1e-4, "loss_adv_g": 1e-4, "grad_norm_d": 1e-2})
    tols = {k: tol for k, tol in tols.items() if k in cpu}
    errs = {k: _rel(card[k], cpu[k]) for k in tols}
    print(f"f32 {cfg.model.name} {cfg.train_mode} step, card vs CPU at 2x64x96: " + ", ".join(
        f"{k} {card[k]:.6f} vs {cpu[k]:.6f} (rel {errs[k]:.1e})" for k in errs))
    if any(errs[k] > tol for k, tol in tols.items()):
        raise AssertionError("the f32 train step on the card disagrees with the CPU's")


@contextlib.contextmanager
def _upsample_census():
    """The distinct calls of the resize's backward while the block runs:
    (C, output size, input size, the layout the kernel reads)."""
    seen, launch = set(), kup.upsample_bilinear_bwd

    def recording(dy, in_hw, *args, **kw):
        seen.add((dy.shape[1], tuple(dy.shape[2:]), tuple(in_hw), kup.layout_of(dy)))
        return launch(dy, in_hw, *args, **kw)

    kup.upsample_bilinear_bwd = recording
    try:
        yield seen
    finally:
        kup.upsample_bilinear_bwd = launch


def _steps(state, step, batch, gen, steps: int) -> list:
    """``steps`` steps on one batch; their metrics."""
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, gen)
        metrics.append(m)
    return metrics


def phase_train() -> dict:
    cfg = get_preset("bisenet_source_aug")
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, use_lovasz=True))
    h, w = cfg.train_size
    b = cfg.train.batch_size
    _card_vs_cpu_f32_step(cfg)

    state, step = _train_setup(cfg, DEV)
    batch = _train_batch(b, h, w, 21, DEV)
    kern, plain = _kernels_vs_plain_step(state, step, batch, LOVASZ_KERNELS)
    print(f"train step, kernels vs plain versions from one state: loss {kern['loss']:.6f} vs "
          f"{plain['loss']:.6f}, loss_lovasz {kern['loss_lovasz']:.6f} vs {plain['loss_lovasz']:.6f}, "
          f"grad_norm {kern['grad_norm']:.6f} vs {plain['grad_norm']:.6f}")
    if _rel(kern["loss"], plain["loss"]) > 1e-4 or _rel(kern["grad_norm"], plain["grad_norm"]) > 1e-2:
        raise AssertionError("the train step with the kernels disagrees with the plain versions")
    state, step = _train_setup(cfg, DEV)  # the 8 steps start from the init
    gen = torch.Generator(device=DEV).manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: the kernels' launches during the train steps only
    _zero_counters("lovasz.hist_launches", "lovasz.bwd_launches", "upsample.bwd_launches", "upsample.copies")
    _zero_counters("batchnorm.fwd_calls", "batchnorm.bwd_calls", "batchnorm.copies")
    metrics = _steps(state, step, batch, gen, TRAIN_STEPS)
    launches = {"lovasz_hist": klov.hist_launches, "lovasz_bwd": klov.bwd_launches,
                "upsample_bilinear_bwd": kup.bwd_launches}
    losses = [float(m["loss"]) for m in metrics]
    print(f"train {cfg.train_mode} b{b} {h}x{w} bf16: losses " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train: launches {launches} over {TRAIN_STEPS} steps, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss on a repeated batch did not fall: {losses}")
    # the resize's backward: the ARM features cx1 and cx2 and the logits
    if launches != {"lovasz_hist": TRAIN_STEPS, "lovasz_bwd": TRAIN_STEPS, "upsample_bilinear_bwd": 3 * TRAIN_STEPS}:
        raise AssertionError(f"expected one K1 and one K2 launch and 3 of the resize's backward per step, "
                             f"got {launches}")
    if kup.copies:
        raise AssertionError(f"the resize's backward copied {kup.copies} gradients on the train path")
    bn = (kbn.fwd_calls, kbn.bwd_calls, kbn.copies)
    print(f"train: the BatchNorm kernels {bn[0]} forward and {bn[1]} backward calls and {bn[2]} copies over "
          f"{TRAIN_STEPS} steps")
    if bn[2] or bn[0] != bn[1] or not bn[0] or bn[0] % TRAIN_STEPS:
        raise AssertionError(f"expected as many BatchNorm forward as backward calls, the same each step, and no "
                             f"copy, got {bn}")
    return {**launches, "batchnorm": bn[0]}


def phase_adversarial() -> dict:
    cfg = get_preset("bisenet_adversarial_lovasz")
    if (cfg.train_size, cfg.data.cityscapes_size) != (SOURCE_HW, TARGET_HW):
        raise AssertionError(f"the flagship preset trains {cfg.train_size} on {cfg.data.cityscapes_size}")
    b = cfg.train.batch_size
    _card_vs_cpu_f32_step(cfg)

    batch = _adversarial_batch(b, SOURCE_HW, TARGET_HW, 31, DEV)
    state, step = _train_setup(cfg, DEV, fused_conv1=True)
    kern, plain = _kernels_vs_plain_step(state, step, batch, LOVASZ_KERNELS + CONV4_KERNELS)
    tols = {"loss": 1e-4, "loss_d": 1e-3, "loss_adv_g": 1e-3, "grad_norm": 1e-2, "grad_norm_d": 1e-2}
    errs = {k: _rel(kern[k], plain[k]) for k in tols}
    print("adversarial step, kernels vs plain versions from one state: " + ", ".join(
        f"{k} {kern[k]:.6f} vs {plain[k]:.6f} (rel {errs[k]:.1e})" for k in tols))
    if any(errs[k] > tol for k, tol in tols.items()):
        raise AssertionError("the adversarial step with the kernels disagrees with the plain versions")
    del state, step

    state, step = _train_setup(cfg, DEV, fused_conv1=True)  # the 8 steps start from the init
    gen = torch.Generator(device=DEV).manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: the kernels' launches during the adversarial steps only
    _zero_counters("lovasz.hist_launches", "lovasz.bwd_launches", "upsample.bwd_launches", "upsample.copies")
    _zero_counters("conv4x4.fwd_launches", "conv4x4.dw_launches", "conv4x4.dx_launches", "conv4x4.copies")
    _zero_counters("batchnorm.fwd_calls", "batchnorm.bwd_calls", "batchnorm.copies")
    with _upsample_census() as census:
        metrics = _steps(state, step, batch, gen, TRAIN_STEPS)
    bn = (kbn.fwd_calls, kbn.bwd_calls, kbn.copies)
    print(f"adversarial: the BatchNorm kernels {bn[0]} forward and {bn[1]} backward calls and {bn[2]} copies over "
          f"{TRAIN_STEPS} steps")
    if bn[2] or bn[0] != bn[1] or not bn[0] or bn[0] % TRAIN_STEPS:
        raise AssertionError(f"expected as many BatchNorm forward as backward calls, the same each step, and no "
                             f"copy, got {bn}")
    k5_copies, upsample_copies = kc.copies, kup.copies
    launches = {"conv4x4s2p1": kc.fwd_launches, "conv4x4s2p1_dw": kc.dw_launches,
                "conv4x4s2p1_dx": kc.dx_launches, "lovasz_hist": klov.hist_launches,
                "lovasz_bwd": klov.bwd_launches, "upsample_bilinear_bwd": kup.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step
    losses = {k: [float(m[k]) for m in metrics] for k in ("loss", "loss_d", "loss_adv_g", "loss_seg")}
    (sh, sw), (th, tw) = SOURCE_HW, TARGET_HW
    for k, v in losses.items():
        print(f"adversarial {cfg.train_mode} b{b} source {sh}x{sw} target {th}x{tw} "
              f"{cfg.model.compute_dtype}: {k} "
              + " ".join(f"{x:.4f}" for x in v))
    print(f"adversarial: launches {launches} over {TRAIN_STEPS} steps, {k5_copies} K5 operand copies, "
          f"{upsample_copies} copies by the resize's backward; its calls in a step (C, out -> in, layout): "
          f"{sorted(census)}; peak device memory {peak:.2f} GiB")

    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite adversarial loss: {losses}")
    if not np.mean(losses["loss"][-3:]) < losses["loss"][0]:
        raise AssertionError(f"the loss on a repeated batch did not fall: {losses['loss']}")
    if abs(losses["loss_d"][0] - np.log(2.0)) > 0.1:
        raise AssertionError(f"loss_d starts at {losses['loss_d'][0]}, not within 0.1 of ln 2")
    if k5_copies or upsample_copies:
        raise AssertionError(f"the flagship path made {k5_copies} K5 operand copies and {upsample_copies} copies "
                             f"of the resize's gradients")
    want = {"conv4x4s2p1": 3, "conv4x4s2p1_dw": 2, "conv4x4s2p1_dx": 1, "lovasz_hist": 1, "lovasz_bwd": 1,
            "upsample_bilinear_bwd": 6}
    if launches != {k: n * TRAIN_STEPS for k, n in want.items()}:
        raise AssertionError(f"expected per step {want} launches, got {launches} over {TRAIN_STEPS} steps")
    return {**launches, "batchnorm": bn[0]}


def _running_stats(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def _bn_affines(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if is_bn_affine(n)}


def phase_deeplab_train() -> tuple:
    """The ``deeplabv2_cityscapes`` step (DeepLabV2, bf16, SGD, batch 8 at
    512x1024, the BatchNorm affines frozen): an f32 step at 2x64x96 on the
    card against the CPU's; from one state a step with ``train.remat`` and
    one without (the same loss and running statistics, bit for bit, each
    step's peak memory); then 8 steps on one repeated batch from the init:
    losses finite and falling, every BatchNorm affine bit-identical to its
    init, every running statistic moved, one launch of the resize's backward
    a step and no copy, 104 forward and backward calls of the BatchNorm
    kernels a step and no copy. BiSeNet-R101's vanilla step at the same
    size, twice from one state, to the same loss. Returns the resize
    backward's launches and the BatchNorm kernels' forward calls in the 8
    steps."""
    cfg = get_preset("deeplabv2_cityscapes")
    h, w = cfg.train_size
    b = cfg.train.batch_size
    _card_vs_cpu_f32_step(cfg)

    batch = _train_batch(b, h, w, 41, DEV)
    state, _ = _train_setup(cfg, DEV)
    saved = (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()))
    results = {}
    for remat in (False, True):
        state.model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = 0
        step = make_train_step(cfg.replace(train=dataclasses.replace(cfg.train, remat=remat)), state.schedule)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, m = step(state, batch, torch.Generator(device=DEV))
        results[remat] = (float(m["loss"]), _running_stats(state.model), torch.cuda.max_memory_allocated() / 2**30)
    (loss_off, stats_off, peak_off), (loss_on, stats_on, peak_on) = results[False], results[True]
    diff = max((stats_on[k] - v).abs().max().item() for k, v in stats_off.items())
    print(f"deeplabv2 step b{b} {h}x{w} bf16 from one state: without remat loss {loss_off:.6f}, peak device memory "
          f"{peak_off:.2f} GiB; with train.remat loss {loss_on:.6f}, peak {peak_on:.2f} GiB; running statistics "
          f"max |diff| {diff:.3e}")
    if loss_on != loss_off or diff != 0.0:
        raise AssertionError("the step with train.remat differs from the one without (loss or running statistics)")
    del state, saved, stats_off, stats_on

    state, step = _train_setup(cfg, DEV)  # the 8 steps start from the init
    affines, stats = _bn_affines(state.model), _running_stats(state.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters("upsample.bwd_launches", "upsample.copies")
    _zero_counters("batchnorm.fwd_calls", "batchnorm.bwd_calls", "batchnorm.copies")
    with _upsample_census() as census:
        metrics = _steps(state, step, batch, torch.Generator(device=DEV).manual_seed(7), TRAIN_STEPS)
    bn = (kbn.fwd_calls, kbn.bwd_calls, kbn.copies)
    print(f"deeplabv2 train: the BatchNorm kernels {bn[0]} forward and {bn[1]} backward calls and {bn[2]} copies "
          f"over {TRAIN_STEPS} steps")
    if bn != (104 * TRAIN_STEPS, 104 * TRAIN_STEPS, 0):
        raise AssertionError(f"expected 104 BatchNorm forward and backward calls a DeepLabV2 step and no copy, "
                             f"got {bn}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    resizes = (kup.bwd_launches, kup.copies)
    print(f"deeplabv2 train: the resize's backward {resizes[0]} launches and {resizes[1]} copies over "
          f"{TRAIN_STEPS} steps; its calls in a step (C, out -> in, layout): {sorted(census)}")
    if resizes != (TRAIN_STEPS, 0):
        raise AssertionError(f"expected one launch of the resize's backward per DeepLabV2 step and no copy, "
                             f"got {resizes}")
    losses = [float(m["loss"]) for m in metrics]
    print(f"deeplabv2 {cfg.train_mode} b{b} {h}x{w} bf16: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; peak device memory {peak:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite deeplabv2 loss: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the deeplabv2 loss on a repeated batch did not fall: {losses}")
    after = _bn_affines(state.model)
    frozen = all(torch.equal(after[n], v) for n, v in affines.items())
    moved = sum(not torch.equal(v, stats[k]) for k, v in _running_stats(state.model).items())
    print(f"deeplabv2: {len(affines)} BatchNorm affines bit-identical to their init: {frozen}; "
          f"{moved} of {len(stats)} running statistics moved")
    if not frozen or moved != len(stats):
        raise AssertionError("DeepLabV2's frozen BatchNorm: an affine moved or a running statistic did not")
    del state, step, batch

    # BiSeNet-R101's first step from its init, run twice from the same state
    cfg_b = get_preset("bisenet_source_aug")
    cfg_b = cfg_b.replace(model=dataclasses.replace(cfg_b.model, context_path="resnet101"))
    hb, wb = cfg_b.train_size
    state, step = _train_setup(cfg_b, DEV)
    saved = (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()))
    batch = _train_batch(b, hb, wb, 43, DEV)
    losses = []
    for _ in range(2):
        state.model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, m = step(state, batch, torch.Generator(device=DEV).manual_seed(7))
        losses.append(float(m["loss"]))
    print(f"bisenet/resnet101 {cfg_b.train_mode} b{b} {hb}x{wb} bf16 ({cfg_b.augment.pipeline}): loss "
          f"{losses[0]:.4f} / {losses[1]:.4f} (its first step, twice from the same state), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)) or losses[0] != losses[1]:
        raise AssertionError(f"BiSeNet-R101's step: losses {losses}, not finite or not the same from one state")
    del state, step, batch, saved
    return resizes[0], bn[0]


LOOP_DIR = os.path.join("build", "chip_smoke_loop")


def _loop_argv(*extra) -> list:
    return ["--preset", "bisenet_adversarial_lovasz", "--train_dataset", "synthetic", "--val_dataset", "synthetic",
            "--target_dataset", "synthetic", "--batch_size", "8", "--eval_batch_size", "8",
            "--steps_per_epoch", "3", "--save_checkpoint_freq_epoch", "1", "--log_backend", "jsonl",
            "--log_dir", os.path.join(LOOP_DIR, "logs"), "--checkpoint_dir", os.path.join(LOOP_DIR, "ckpt"),
            "--run_name", "loop", *extra]


def _loop_run(argv, cli: str = "train_adversarial") -> tuple:
    """One run of ``cli/<cli>.py`` with the K1/K2/K3 counts set to 0 just
    before it; the report and the counts."""
    import importlib

    main = importlib.import_module(f"rtda_semanticsegmentation_tpu_torch.cli.{cli}").main
    _zero_counters("lovasz.hist_launches", "lovasz.bwd_launches")
    _zero_counters("int8_conv.launches", "int8_conv.copies")
    report = main(argv)
    torch.cuda.synchronize()
    counts = {"lovasz_hist": klov.hist_launches, "lovasz_bwd": klov.bwd_launches, "int8_conv": k3.launches,
              "int8_conv_copies": k3.copies}
    return report, counts


def _loop_losses(path: str) -> list:
    """(step, key, value) of every loss logged in a jsonl file."""
    out = []
    for line in open(path):
        event = json.loads(line)
        if event["event"] == "metrics":
            out += [(event["step"], k, v) for k, v in event.items() if "loss" in k]
    return out


def phase_loop() -> int:
    from rtda_semanticsegmentation_tpu_torch.train.checkpoint import FILENAME, CheckpointManager

    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    report, counts = _loop_run(_loop_argv("--epochs", "2", "--final_int8_eval", "--print_freq_batch", "1"))
    trainer = report["trainer"]
    cfg = trainer.cfg
    if (cfg.train_size, cfg.eval_size, cfg.train.batch_size) != (SOURCE_HW, TARGET_HW, 8):
        raise AssertionError(f"the loop trained {cfg.train_size} / evaluated {cfg.eval_size}")
    steps = report["global_step"]
    n_eval = -(-len(trainer.val_ds) // cfg.data.eval_batch_size)
    print(f"loop: {steps} steps, 2 epochs, {len(trainer.val_ds)} val images in {n_eval} batches; launches {counts}")
    print(f"loop report: best mIoU {report['best_miou']:.4f}, int8 mIoU {report.get('int8_miou')}, delta "
          f"{report.get('int8_miou_delta')}, FLOPs {report['flops_g']} G, params {report['params_m']} M")

    ckpt = CheckpointManager(cfg, run_name="loop", device=DEV)
    files = {w: os.path.join(d, FILENAME) for w, d in (("best", ckpt.best_dir), ("latest", ckpt.latest_dir))}
    if not all(os.path.isfile(f) for f in files.values()):
        raise AssertionError(f"a checkpoint stream is missing: {files}")
    saved = torch.load(files["latest"], map_location=DEV, weights_only=True)

    losses = _loop_losses(os.path.join(LOOP_DIR, "logs", "loop.jsonl"))
    loss_d1 = [v for s, k, v in losses if s == 1 and k == "train/loss_d"]
    print(f"loop: loss_d at step 1 {loss_d1}, {len(losses)} logged losses")
    if not losses or not all(math.isfinite(v) for _, _, v in losses):
        raise AssertionError(f"a logged loss is not finite: {[x for x in losses if not math.isfinite(x[2])]}")
    if len(loss_d1) != 1 or abs(loss_d1[0] - math.log(2.0)) > 0.1:
        raise AssertionError(f"loss_d at step 1 is {loss_d1}, not within 0.1 of ln 2")
    if steps != 6 or counts["lovasz_hist"] != steps or counts["lovasz_bwd"] != steps:
        raise AssertionError(f"expected one K1 and one K2 launch per step over 6 steps, got {counts} in {steps}")
    k3_loop = counts["int8_conv"]
    if counts["int8_conv"] != QUANT_CONVS * n_eval or counts["int8_conv_copies"]:
        raise AssertionError(f"expected {QUANT_CONVS} K3 launches per int8 forward over {n_eval} batches and no "
                             f"operand copy, got {counts}")
    if not ("int8_miou" in report and "int8_miou_delta" in report):
        raise AssertionError("the report lacks int8_miou / int8_miou_delta")

    val = trainer.validate()
    pixels = sum(int((trainer.val_ds.load(i)[1] != 255).sum()) for i in range(len(trainer.val_ds)))
    print(f"loop: a validation pass of the best model: mIoU {val['miou']:.4f}, loss {val['loss']:.4f}, "
          f"hist {val['hist'].dtype} total {int(val['hist'].sum())} of {pixels} non-ignored pixels")
    if val["hist"].dtype != np.int64 or int(val["hist"].sum()) != pixels:
        raise AssertionError("the validation histogram does not total the non-ignored pixels")
    if not all(0.0 <= m <= 1.0 for m in (val["miou"], report["best_miou"], report["int8_miou"])):
        raise AssertionError(f"an mIoU lies outside [0, 1]: {val['miou']}, {report['best_miou']}")
    del report, trainer, val

    # resume from 'latest' (epoch 1, step 3) to 3 epochs; capture the state
    # right after the restore
    restored = {}
    original = CheckpointManager.restore_into

    def capture(self, state, which="latest"):
        out = original(self, state, which)
        if out is not None and not restored:
            restored.update(step=state.step, g=copy.deepcopy(state.model.state_dict()),
                            d=copy.deepcopy(state.discriminator.state_dict()))
        return out

    CheckpointManager.restore_into = capture
    try:
        report, counts = _loop_run(_loop_argv("--epochs", "3", "--resume_checkpoint", "latest", "--no_perf"))
    finally:
        CheckpointManager.restore_into = original
    resumed_steps = report["global_step"] - restored["step"]
    print(f"loop resumed: from step {restored['step']} to {report['global_step']}; launches {counts}")
    equal = all(torch.equal(restored["g"][k], v) for k, v in saved["generator"].items()) and all(
        torch.equal(restored["d"][k], v) for k, v in saved["discriminator"].items())
    if restored["step"] != 3 or report["global_step"] != 9 or not equal:
        raise AssertionError(f"the resume started at step {restored['step']} (want 3), ended at "
                             f"{report['global_step']} (want 9), G and D equal to the file's: {equal}")
    if counts["lovasz_hist"] != resumed_steps or counts["lovasz_bwd"] != resumed_steps:
        raise AssertionError(f"expected one K1 and one K2 launch per resumed step, got {counts}")
    losses = _loop_losses(os.path.join(LOOP_DIR, "logs", "loop.jsonl"))
    if not all(math.isfinite(v) for _, _, v in losses):
        raise AssertionError("a logged loss of the resumed run is not finite")
    del report
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    return k3_loop


DEEPLAB_LOOP_DIR = os.path.join("build", "chip_smoke_deeplab_loop")


def phase_deeplab_loop() -> int:
    """DeepLabV2's training job through ``cli/train.main``: the
    ``deeplabv2_cityscapes`` preset on synthetic train and validation sets
    (64 frames each) at 512x1024, batch 8, 1 epoch of 2 steps, validation
    in 2 batches of 32, one checkpoint, the final int8 evaluation. Gates:
    2 steps, finite logged losses, the 'best' checkpoint, the BatchNorm
    affines at their init, ``int8_miou`` in [0, 1], K3 exactly 95 times per
    int8 batch and no operand copy, no K1 or K2 launch (CE only). Returns
    K3's launches."""
    shutil.rmtree(DEEPLAB_LOOP_DIR, ignore_errors=True)
    argv = ["--preset", "deeplabv2_cityscapes", "--train_dataset", "synthetic", "--val_dataset", "synthetic",
            "--train_size", str(H), str(W), "--batch_size", "8", "--eval_batch_size", "32", "--epochs", "1",
            "--steps_per_epoch", "2", "--save_checkpoint_freq_epoch", "1", "--final_int8_eval", "--no_perf",
            "--print_freq_batch", "1", "--log_backend", "jsonl", "--log_dir", os.path.join(DEEPLAB_LOOP_DIR, "logs"),
            "--checkpoint_dir", os.path.join(DEEPLAB_LOOP_DIR, "ckpt"), "--run_name", "deeplab"]
    report, counts = _loop_run(argv, cli="train")
    trainer = report["trainer"]
    cfg = trainer.cfg
    n_eval = -(-len(trainer.val_ds) // cfg.data.eval_batch_size)
    print(f"deeplab loop: {report['global_step']} steps, {len(trainer.val_ds)} val images in {n_eval} batches; "
          f"launches {counts}; best mIoU {report['best_miou']:.4f}, int8 mIoU {report.get('int8_miou')}, delta "
          f"{report.get('int8_miou_delta')}")
    if (cfg.model.name, cfg.train_size, cfg.eval_size) != ("deeplabv2", (H, W), (H, W)):
        raise AssertionError(f"the deeplab loop ran {cfg.model.name} at {cfg.train_size} / {cfg.eval_size}")
    losses = _loop_losses(os.path.join(DEEPLAB_LOOP_DIR, "logs", "deeplab.jsonl"))
    if report["global_step"] != 2 or not losses or not all(math.isfinite(v) for _, _, v in losses):
        raise AssertionError(f"the deeplab loop ran {report['global_step']} steps, losses {losses}")
    from rtda_semanticsegmentation_tpu_torch.train.checkpoint import FILENAME, CheckpointManager

    ckpt = CheckpointManager(cfg, run_name="deeplab", device=DEV)
    if not os.path.isfile(os.path.join(ckpt.best_dir, FILENAME)):  # a run's last epoch saves no 'latest'
        raise AssertionError("the deeplab loop saved no 'best' checkpoint")
    affines = _bn_affines(trainer.model)
    identity = all(torch.equal(v, torch.ones_like(v) if n.endswith("weight") else torch.zeros_like(v))
                   for n, v in affines.items())
    if not identity:
        raise AssertionError("a frozen BatchNorm affine of the deeplab loop moved from its init")
    if not 0.0 <= report.get("int8_miou", -1.0) <= 1.0 or "int8_miou_delta" not in report:
        raise AssertionError("the deeplab loop's report lacks int8_miou / int8_miou_delta")
    want = R101_QUANT_CONVS["deeplabv2"] * n_eval
    if counts["int8_conv"] != want or counts["int8_conv_copies"] or counts["lovasz_hist"] or counts["lovasz_bwd"]:
        raise AssertionError(f"the deeplab loop: expected {want} K3 launches, no copy and no K1/K2, got {counts}")
    del report, trainer
    shutil.rmtree(DEEPLAB_LOOP_DIR, ignore_errors=True)
    return counts["int8_conv"]


DIST_DIR = os.path.join("build", "chip_smoke_dist")
DIST_STEPS = 3


def _dist_argv(name: str) -> list:
    """The flagship's job for the distributed phase: 1 epoch of 3 steps,
    every step's losses logged."""
    return ["--preset", "bisenet_adversarial_lovasz", "--train_dataset", "synthetic", "--val_dataset", "synthetic",
            "--target_dataset", "synthetic", "--batch_size", "8", "--eval_batch_size", "8", "--epochs", "1",
            "--steps_per_epoch", str(DIST_STEPS), "--no_perf", "--print_freq_batch", "1", "--log_backend", "jsonl",
            "--log_dir", os.path.join(DIST_DIR, "logs"), "--checkpoint_dir", os.path.join(DIST_DIR, "ckpt"),
            "--run_name", name]


def _torchrun(nproc: int, *args, timeout: int = 600) -> str:
    """``python -m torch.distributed.run`` of this script with ``args`` on
    ``nproc`` ranks; returns the output, raises on failure."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", str(nproc),
           "--master_addr", "127.0.0.1", "--master_port", str(port), os.path.abspath(__file__), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1"))
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def worker_cli(out: str, argv: list) -> None:
    """A rank of phase 13a: ``cli/train_adversarial.main`` with the kernels'
    counts from 0; rank 0 writes them to ``out``."""
    from rtda_semanticsegmentation_tpu_torch.cli import train_adversarial

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _zero_counters("lovasz.hist_launches", "lovasz.bwd_launches")
    report = train_adversarial.main(argv)
    torch.cuda.synchronize()
    trainer = report["trainer"]
    if trainer.mesh.is_main:
        with open(out, "w") as f:
            json.dump({"lovasz_hist": klov.hist_launches, "lovasz_bwd": klov.bwd_launches,
                       "world": trainer.mesh.world, "steps": report["global_step"]}, f)


BN_COUNTERS = ("batchnorm.fwd_calls", "batchnorm.bwd_calls", "batchnorm.copies")


def _bn_counts() -> tuple:
    """The BatchNorm kernels' (forward calls, backward calls, copies)."""
    return kbn.fwd_calls, kbn.bwd_calls, kbn.copies


def _ranks_counts(mesh, counts) -> list:
    """Every rank's ``counts`` (a tuple of ints), in rank order."""
    table = torch.zeros(mesh.world, len(counts), dtype=torch.int64, device=DEV)
    table[mesh.rank] = torch.tensor(counts, device=DEV)
    torch.distributed.all_reduce(table)
    return table.cpu().tolist()


def _dist_flagship(mesh=None):
    """The flagship step of phase 13b from its seeded init, on the global
    batch's rows of ``mesh``'s rank (all of them without a mesh); its
    metrics and the BatchNorm kernels' counts in the step."""
    cfg = get_preset("bisenet_adversarial_lovasz")
    state, _ = _train_setup(cfg, DEV)
    step = make_train_step(cfg, state.schedule, state.d_schedule, mesh=mesh)
    batch = _adversarial_batch(cfg.train.batch_size, SOURCE_HW, TARGET_HW, 31, DEV)
    if mesh is not None:
        sync_batch_norm(state.model, mesh)
        local = mesh.check_batch(cfg.train.batch_size)
        batch = {k: v[mesh.rank * local:(mesh.rank + 1) * local].contiguous() for k, v in batch.items()}
    _zero_counters(*BN_COUNTERS)
    _, m = step(state, batch, torch.Generator(device=DEV).manual_seed(5))
    return {k: float(v) for k, v in m.items()}, _bn_counts()


def worker_dp(out: str) -> None:
    """A rank of phases 13b and 13c: gloo on cuda:0, the flagship step on
    its rows, then K1's integer histogram of its rows of the flagship's
    source map summed over the ranks; rank 0 writes both and every rank's
    BatchNorm counts to ``out``."""
    from rtda_semanticsegmentation_tpu_torch.parallel import create_mesh, ensure_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ensure_distributed(device=DEV, backend="gloo")
    mesh = create_mesh(device=DEV)
    metrics, bn = _dist_flagship(mesh)
    bn = _ranks_counts(mesh, bn)
    probas, labels = _lovasz_case("spread", SOURCE_HW[0] * SOURCE_HW[1])
    local = mesh.check_batch(BATCH)
    rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
    raw = klov.lovasz_hist_raw(probas[rows].contiguous(), labels[rows].contiguous(), BINS, 255)
    hist = klov.finalize_hist(mesh.sum_(raw))
    torch.cuda.synchronize()
    if mesh.is_main:
        torch.save({"metrics": metrics, "world": mesh.world, "backend": torch.distributed.get_backend(),
                    "hist": hist.cpu(), "batchnorm": bn}, out)
    torch.distributed.destroy_process_group()


def phase_distributed() -> dict:
    """Phase 13; returns K1's and K2's launches on its main path (13a)."""
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    torch.cuda.empty_cache()
    # (a) the job under the launcher at world 1, on NCCL, and without it
    out = os.path.join(DIST_DIR, "cli.json")
    t0 = time.perf_counter()
    log = _torchrun(1, "--worker", "cli", out, *_dist_argv("nccl"))
    launched_s = time.perf_counter() - t0
    got = json.load(open(out))
    start = [line for line in log.splitlines() if line.startswith("mode=")]
    print(f"distributed (a): torch.distributed.run --nproc_per_node 1, {launched_s:.1f} s; start line {start}; "
          f"launches K1 {got['lovasz_hist']} K2 {got['lovasz_bwd']} over {got['steps']} steps")
    if len(start) != 1 or "backend=nccl world=1" not in start[0]:
        raise AssertionError(f"the launched run's start line does not name NCCL at world 1: {start}")
    if got["steps"] != DIST_STEPS or (got["lovasz_hist"], got["lovasz_bwd"]) != (DIST_STEPS, DIST_STEPS):
        raise AssertionError(f"expected one K1 and one K2 launch per step over {DIST_STEPS} steps, got {got}")
    _, counts = _loop_run(_dist_argv("alone"))
    _loop_run(_dist_argv("again"))
    nccl = _loop_losses(os.path.join(DIST_DIR, "logs", "nccl.jsonl"))
    alone = _loop_losses(os.path.join(DIST_DIR, "logs", "alone.jsonl"))
    again = _loop_losses(os.path.join(DIST_DIR, "logs", "again.jsonl"))
    spread = max((_rel(a[2], b[2]) for a, b in zip(again, alone) if a[0] > 1), default=0.0)
    worst = max((_rel(a[2], b[2]) for a, b in zip(nccl, alone) if a[0] > 1), default=0.0)
    first = [(a, b) for a, b in zip(nccl, alone) if a[0] == 1]
    print(f"distributed (a): {len(nccl)} logged losses; step 1 "
          + ", ".join(f"{a[1]} {a[2]!r} vs {b[2]!r}" for a, b in first)
          + f"; steps 2-{DIST_STEPS}: largest relative difference {worst:.3e} (two runs without the launcher: "
          f"{spread:.3e})")
    if [(s, k) for s, k, _ in nccl] != [(s, k) for s, k, _ in alone] or len(nccl) == 0:
        raise AssertionError("the launched run and the run without the launcher logged different losses")
    if any(a[2] != b[2] for a, b in first) or worst > 1e-2:
        raise AssertionError("the launched run's losses differ from those without the launcher")
    if (counts["lovasz_hist"], counts["lovasz_bwd"]) != (DIST_STEPS, DIST_STEPS):
        raise AssertionError(f"the run without the launcher: launches {counts}")

    # (b) and (c): two gloo ranks on cuda:0
    out = os.path.join(DIST_DIR, "dp.pt")
    t0 = time.perf_counter()
    _torchrun(2, "--worker", "dp", out)
    ranks = torch.load(out, weights_only=False)
    one, one_bn = _dist_flagship()
    tols = {"loss": 1e-4, "loss_ce": 1e-4, "loss_lovasz": 1e-4, "loss_d": 1e-4, "loss_adv_g": 1e-4,
            "grad_norm": 1e-2, "grad_norm_d": 1e-2}
    errs = {k: _rel(ranks["metrics"][k], one[k]) for k in tols}
    print(f"distributed (b): 2 ranks ({ranks['backend']}, world {ranks['world']}) on one card, "
          f"{time.perf_counter() - t0:.1f} s with the single-process step: "
          + ", ".join(f"{k} {ranks['metrics'][k]:.6f} vs {one[k]:.6f} (rel {errs[k]:.1e})" for k in tols))
    if (ranks["backend"], ranks["world"]) != ("gloo", 2) or any(errs[k] > tol for k, tol in tols.items()):
        raise AssertionError("the 2-rank flagship step disagrees with the single-process step")
    print(f"distributed (b): the BatchNorm kernels' (forward calls, backward calls, copies) in the step, per rank "
          f"{ranks['batchnorm']}, in the single process {one_bn}")
    if not one_bn[0] or one_bn[2] or any(tuple(c) != (one_bn[0], one_bn[0], 0) for c in ranks["batchnorm"]):
        raise AssertionError("expected each rank to call the BatchNorm kernels as often as the single process, "
                             "forward and backward, with no copy")
    probas, labels = _lovasz_case("spread", SOURCE_HW[0] * SOURCE_HW[1])
    whole = klov.lovasz_hist(probas, labels, BINS, 255)
    saved = klov.MAX_PIXELS
    klov.MAX_PIXELS = 3 * SOURCE_HW[0] * SOURCE_HW[1]
    try:
        before = klov.hist_launches
        cut = klov.lovasz_hist(probas, labels, BINS, 255)
        cut_launches = klov.hist_launches - before
    finally:
        klov.MAX_PIXELS = saved
    plain = klov.lovasz_hist_plain(probas, labels, BINS, 255)
    same = (torch.equal(whole, cut), torch.equal(whole.cpu(), ranks["hist"]), torch.equal(whole, plain))
    print(f"distributed (c): K1 on (8, 19, {SOURCE_HW[0] * SOURCE_HW[1]}): one launch against {cut_launches} "
          f"launches, 2 ranks' sum and the plain version: the same bits {same}")
    if cut_launches != 3 or not all(same):
        raise AssertionError("K1 cut into launches or summed over ranks is not the same bits as one launch")
    del probas, labels, plain

    # (d) b32 at 512x1024: 2**24 pixels, two K1 launches a step
    cfg = get_preset("bisenet_source_aug")
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, use_lovasz=True),
                      train=dataclasses.replace(cfg.train, batch_size=32))
    h, w = H, W
    torch.cuda.empty_cache()
    state, step = _train_setup(cfg, DEV)
    batch = _train_batch(32, h, w, 41, DEV)
    gen = torch.Generator(device=DEV).manual_seed(9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters("lovasz.hist_launches", "lovasz.bwd_launches")
    metrics = _steps(state, step, batch, gen, 4)
    launches = (klov.hist_launches, klov.bwd_launches)
    losses = [float(m["loss"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"distributed (d): bisenet_source_aug + binned Lovász at b32 {h}x{w} ({32 * h * w} pixels): losses "
          + " ".join(f"{x:.4f}" for x in losses) + f"; launches (K1, K2) {launches} over {len(losses)} steps; "
          f"peak device memory {peak:.2f} GiB")
    if launches != (2 * len(losses), len(losses)) or not all(np.isfinite(losses)):
        raise AssertionError(f"the b32 Lovász step: launches {launches}, losses {losses}")
    del state, step, batch
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return {"lovasz_hist": got["lovasz_hist"], "lovasz_bwd": got["lovasz_bwd"]}


TP_MIN_CHANNELS = 256  # the train loop's rule: convs of >= 256 output channels shard
TP_STEPS = 2  # steps after the checked one
TP_LAYOUTS = ((2, 2), (4, 2))  # (ranks, model): (data=1, model=2), (data=2, model=2)


def _state_bytes(state) -> int:
    """Bytes of the parameters and optimizer state this rank holds (G and D)."""
    total = 0
    for module, opt in ((state.model, state.optimizer), (state.discriminator, state.d_optimizer)):
        total += sum(p.numel() * p.element_size() for p in module.parameters())
        total += sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
                     if torch.is_tensor(v))
    return total


def _tp_flagship(mesh=None, dtype: str = "bfloat16", steps: int = TP_STEPS) -> dict:
    """The flagship step at full shapes from its seeded init, computing in
    ``dtype`` (the rows of ``mesh``'s data index, its wide kernels sharded;
    all of it without a mesh): the first step's metrics, then ``steps``
    more; K1/K2's launches and the BatchNorm kernels' counts in all the
    steps, the state's bytes and the state."""
    from rtda_semanticsegmentation_tpu_torch.parallel import shard_state

    cfg = get_preset("bisenet_adversarial_lovasz")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    state, _ = _train_setup(cfg, DEV)
    batch = _adversarial_batch(cfg.train.batch_size, SOURCE_HW, TARGET_HW, 31, DEV)
    if mesh is not None:
        sync_batch_norm(state.model, mesh)
        shard_state(state, mesh, TP_MIN_CHANNELS)
        local = mesh.check_batch(cfg.train.batch_size)
        batch = {k: v[mesh.data_rank * local:(mesh.data_rank + 1) * local].contiguous() for k, v in batch.items()}
    step = make_train_step(cfg, state.schedule, state.d_schedule, mesh=mesh)
    gen = torch.Generator(device=DEV).manual_seed(5)
    _zero_counters("lovasz.hist_launches", "lovasz.bwd_launches", *BN_COUNTERS)
    _, m = step(state, batch, gen)
    metrics = {k: float(v) for k, v in m.items()}
    _steps(state, step, batch, gen, steps)
    return {"metrics": metrics, "launches": (klov.hist_launches, klov.bwd_launches), "batchnorm": _bn_counts(),
            "bytes": _state_bytes(state), "state": state}


def _model_group_spread(mesh, tensors) -> float:
    """The largest difference of ``tensors`` between the ranks of this
    rank's model group, and the largest over the world of that: 0 when
    every model group holds the same bits."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.model_group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.model_group)
    spread = (hi - lo).abs().max().reshape(1)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    return spread.item()


def worker_tp(out: str, model: int) -> None:
    """A rank of phase 14a/b: gloo on cuda:0 at (data = world / model,
    model), the flagship step sharded (``_tp_flagship``), first one step in
    f32 (TF32 off), then the bf16 steps; then, over the ranks, the spread
    of the replicated parameters and of the BatchNorm running statistics
    within each model group and every rank's K1/K2 launches and BatchNorm
    counts of the bf16 steps. Rank 0 writes them to ``out``."""
    import torch.distributed as dist

    from rtda_semanticsegmentation_tpu_torch.config import MeshConfig
    from rtda_semanticsegmentation_tpu_torch.parallel import create_mesh, ensure_distributed, tp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ensure_distributed(device=DEV, backend="gloo")
    mesh = create_mesh(MeshConfig(model=model), device=DEV)
    f32 = _tp_flagship(mesh, "float32", steps=0)["metrics"]
    torch.cuda.empty_cache()
    got = _tp_flagship(mesh)
    state = got["state"]
    replicated, stats = [], []
    for module in (state.model, state.discriminator):
        skip = tp.sharded_ids(module)
        replicated += [p for p in module.parameters() if id(p) not in skip]
        stats += [b for b in module.buffers() if b.is_floating_point()]
    spread = (_model_group_spread(mesh, replicated), _model_group_spread(mesh, stats))
    launches = torch.zeros(mesh.world, 2, dtype=torch.int64, device=DEV)
    launches[mesh.rank] = torch.tensor(got["launches"], device=DEV)
    dist.all_reduce(launches)
    bn = _ranks_counts(mesh, got["batchnorm"])
    if mesh.is_main:
        torch.save({"metrics": got["metrics"], "f32": f32, "bytes": got["bytes"], "spread": spread,
                    "launches": launches.cpu().tolist(), "batchnorm": bn,
                    "layout": (mesh.data_size, mesh.model_size),
                    "backend": dist.get_backend(),
                    "sharded": (len(tp.sharded_convs(state.model)), len(tp.sharded_convs(state.discriminator)))},
                   out)
    dist.destroy_process_group()


def phase_tp(card: str) -> dict:
    """Phase 14; returns K1's and K2's launches on its main path (rank 0 of
    14a and 14b)."""
    os.makedirs(DIST_DIR, exist_ok=True)
    torch.cuda.empty_cache()
    one_f32 = _tp_flagship(dtype="float32", steps=0)["metrics"]
    torch.cuda.empty_cache()
    one = _tp_flagship()
    one_bytes, one_bn = one["bytes"], one["batchnorm"]
    whole = one["metrics"]
    del one
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True  # other algorithms than the heuristics' for the same convs
    try:
        again = _tp_flagship(steps=0)["metrics"]
    finally:
        torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    # the gate, phase 13b's tolerances: the TP step against one process with
    # whole convs, in f32 (TF32 off). In bf16 a sharded conv runs cuDNN
    # kernels of other shapes than the whole conv, which round other bf16
    # sums: that difference is printed beside the single-process step's
    # under another choice of cuDNN algorithms
    tols = {"loss": 1e-4, "loss_ce": 1e-4, "loss_lovasz": 1e-4, "loss_d": 1e-4, "loss_adv_g": 1e-4,
            "grad_norm": 1e-2, "grad_norm_d": 1e-2}
    print("tp: bf16, the single-process step with cuDNN's benchmarked algorithms against its heuristic ones: "
          + ", ".join(f"{k} rel {_rel(again[k], whole[k]):.1e}" for k in tols) + f"; {card}")
    counts = {"lovasz_hist": 0, "lovasz_bwd": 0}
    for ranks, model in TP_LAYOUTS:
        out = os.path.join(DIST_DIR, f"tp{ranks}.pt")
        t0 = time.perf_counter()
        _torchrun(ranks, "--worker", "tp", out, str(model))
        got = torch.load(out, weights_only=False)
        errs = {k: _rel(got["f32"][k], one_f32[k]) for k in tols}
        what = f"tp ({'a' if ranks == 2 else 'b'}): {ranks} gloo ranks on cuda:0 at (data={got['layout'][0]}, model=" \
               f"{got['layout'][1]})"
        print(f"{what}, {time.perf_counter() - t0:.1f} s with the process starts; f32 (TF32 off) against one process: "
              + ", ".join(f"{k} {got['f32'][k]:.6f} vs {one_f32[k]:.6f} (rel {errs[k]:.1e})" for k in tols))
        print(f"{what}; bf16 against one process (not gated): "
              + ", ".join(f"{k} {got['metrics'][k]:.6f} vs {whole[k]:.6f} (rel {_rel(got['metrics'][k], whole[k]):.1e})"
                          for k in tols))
        print(f"{what}: {got['sharded'][0]} G and {got['sharded'][1]} D convs sharded (>= {TP_MIN_CHANNELS} "
              f"output channels); launches (K1, K2) per rank over {1 + TP_STEPS} steps {got['launches']}; "
              f"replicated parameters' spread in a model group {got['spread'][0]!r}, BatchNorm statistics' "
              f"{got['spread'][1]!r}; weights + optimizer state {got['bytes'] / 2**20:.2f} MiB a rank against "
              f"{one_bytes / 2**20:.2f} MiB in one process; {card}")
        if got["backend"] != "gloo" or tuple(got["layout"]) != (ranks // model, model):
            raise AssertionError(f"{what}: backend {got['backend']}, layout {got['layout']}")
        if any(errs[k] > tol for k, tol in tols.items()):
            raise AssertionError(f"{what}: the tensor-parallel step disagrees with the single-process step")
        if any(tuple(c) != (1 + TP_STEPS, 1 + TP_STEPS) for c in got["launches"]):
            raise AssertionError(f"{what}: expected one K1 and one K2 launch per step and rank, got {got['launches']}")
        print(f"{what}: the BatchNorm kernels' (forward calls, backward calls, copies) over {1 + TP_STEPS} steps "
              f"per rank {got['batchnorm']}, in the single process {one_bn}")
        if not one_bn[0] or one_bn[2] or any(tuple(c) != (one_bn[0], one_bn[0], 0) for c in got["batchnorm"]):
            raise AssertionError(f"{what}: expected each rank to call the BatchNorm kernels as often as the single "
                                 f"process, forward and backward, with no copy")
        if got["spread"][0] != 0.0 or got["sharded"] != (13, 2):
            raise AssertionError(f"{what}: replicated parameters differ in a model group ({got['spread'][0]}) "
                                 f"or sharded convs {got['sharded']} are not (13, 2)")
        counts["lovasz_hist"] += got["launches"][0][0]
        counts["lovasz_bwd"] += got["launches"][0][1]
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def _k3_entry(times: list) -> dict:
    """K3's kernels-line numbers: the sums of the per-forward times of the
    three int8 models."""
    by = {kind: sum(t["by"][kind] for t in times) for kind in ("bytes", "operations")}
    return {"ms": sum(t["ms"] for t in times), "plain_ms": sum(t["plain_ms"] for t in times),
            "bound_ms": sum(t["bound_ms"] for t in times), "bound_by": max(by, key=by.get), "library_ms": None,
            "max_abs_err": max(t["max_abs_err"] for t in times)}


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        kind, out = sys.argv[2], sys.argv[3]
        if kind == "tp":
            return worker_tp(out, int(sys.argv[4]))
        if kind == "bn_passes":
            return worker_bn_passes(out)
        return worker_cli(out, sys.argv[4:]) if kind == "cli" else worker_dp(out)
    only = {"upsample": phase_upsample_kernels, "batchnorm": phase_batchnorm_kernels,
            "layernorm": phase_layernorm_kernels}
    if sys.argv[1:] not in ([], ["--only", "distributed"], ["--only", "tp"], *(["--only", k] for k in only)):
        raise SystemExit(f"unknown arguments {sys.argv[1:]}: none, --only distributed, --only tp, "
                         f"--only upsample, --only batchnorm or --only layernorm")
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--only"] and sys.argv[2] in only:
        only[sys.argv[2]]()
        print(f"chip_smoke.py: the {sys.argv[2]} phase passed in {time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:]:
        if sys.argv[2] == "distributed":
            phase_distributed()
        phase_tp(card)
        print(f"chip_smoke.py: the {sys.argv[2]} phase{'s' if sys.argv[2] == 'distributed' else ''} passed in "
              f"{time.perf_counter() - t0:.1f} s")
        return
    k3_times = phase_kernels()
    lovasz_times = phase_lovasz_kernels()
    conv4_times = phase_conv4_kernels()
    conv3_times = phase_conv3_kernels()
    upsample_times = phase_upsample_kernels()
    batchnorm_times = phase_batchnorm_kernels()
    layernorm_times = phase_layernorm_kernels()
    k3_launches, k4_launches = phase_slice()
    artifact_k3, artifact_k4 = phase_artifact()
    k3_launches += artifact_k3
    k4_launches += artifact_k4
    k4_launches += phase_r101()
    r101_k3_launches, r101_k3_times = phase_r101_int8()
    k3_launches += r101_k3_launches
    train_launches = phase_train()
    adversarial_launches = phase_adversarial()
    upsample_launches = train_launches.pop("upsample_bilinear_bwd") + adversarial_launches["upsample_bilinear_bwd"]
    deeplab_upsample, batchnorm_calls = phase_deeplab_train()
    upsample_launches += deeplab_upsample
    batchnorm_calls += train_launches.pop("batchnorm") + adversarial_launches["batchnorm"]
    k3_launches += phase_loop()
    k3_launches += phase_deeplab_loop()
    dist_launches = phase_distributed()
    tp_launches = phase_tp(card)
    train_launches = {k: v + dist_launches[k] + tp_launches[k] for k, v in train_launches.items()}
    k3_entry = _k3_entry([k3_times, r101_k3_times["r101"], r101_k3_times["deeplabv2"]])
    pkg = "rtda_semanticsegmentation_tpu_torch/csrc"
    ref = "rtda_semanticsegmentation_tpu/ops"
    kernels = [{
        "name": "int8_conv", "route": "cuda", "source": f"{pkg}/int8_conv.cu",
        "replaces": f"{ref}/pallas_conv_int8.py:145", "launches": k3_launches, **k3_entry,
    }] + [{
        "name": name, "route": "cuda", "source": f"{pkg}/lovasz.cu",
        "replaces": f"{ref}/pallas_lovasz.py:{line}", "launches": train_launches[name],
        **lovasz_times[name],
    } for name, line in (("lovasz_hist", 124), ("lovasz_bwd", 257))] + [{
        "name": name, "route": "cuda", "source": f"{pkg}/conv4x4s2.cu",
        "replaces": f"{ref}/pallas_conv.py:{line}", "launches": adversarial_launches[name],
        **conv4_times[name],
    } for name, line in (("conv4x4s2p1", 155), ("conv4x4s2p1_dw", 262), ("conv4x4s2p1_dx", 403))] + [{
        "name": "conv3x3", "route": "cuda", "source": f"{pkg}/conv3x3.cu",
        "replaces": f"{ref}/pallas_conv3.py:120", "launches": k4_launches, **conv3_times,
    }, {
        "name": "upsample_bilinear_bwd", "route": "cuda", "source": f"{pkg}/upsample.cu", "replaces": None,
        "launches": upsample_launches, **upsample_times,
    }, {
        "name": "batchnorm", "route": "cuda", "source": f"{pkg}/batchnorm.cu", "replaces": None,
        "calls": batchnorm_calls, **batchnorm_times,
    }, {
        "name": "layernorm", "route": "cuda", "source": f"{pkg}/layernorm.cu", "replaces": None,
        **layernorm_times,
    }]
    print(f"chip_smoke.py: all phases passed in {time.perf_counter() - t0:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
