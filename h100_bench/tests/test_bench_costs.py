"""The FLOP and byte counts against sums worked by hand."""

import pytest
import torch

from h100_bench.costs import flops, lovasz
from h100_bench.lib import spec


def test_one_conv_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty((2, 4, 10, 12), device="meta")
    w = torch.empty((8, 4, 3, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        torch.nn.functional.conv2d(x, w, None, 1, 1)
    # 2 FLOPs a multiply-accumulate: 2 * (8 * 4 * 9) per output pixel, 2 * 10 * 12 pixels
    assert counter.get_total_flops() == 2 * 8 * 4 * 9 * 2 * 10 * 12


def test_lovasz_bytes_by_hand():
    n = 512 * 1024
    assert lovasz.k1_bytes(8, 19, n, 256) == 4 * 8 * 19 * n + 4 * 8 * n + 4 * 19 * 3 * 256 == 335_602_688
    n = 720 * 1280
    assert lovasz.k1_bytes(8, 19, n, 256) == 589_882_368
    assert lovasz.k2_bytes(8, 19, n, 256) == 2 * 4 * 8 * 19 * n + 4 * 8 * n + 4 * 19 * 2 * 256 == 1_150_195_712


def test_serve_flops_r18():
    """BiSeNet-R18's eval forward at 512x1024: 50.9 GFLOP a frame, as
    ``FlopCounterMode`` counts the port's own model."""
    cfg = spec.load_json(spec.BENCH / "configs" / "bisenet-r18.json")
    per_frame = flops.serve_flops(cfg, {"batch": 2, "size": [512, 1024]}) / 2
    assert per_frame == pytest.approx(50.9e9, rel=2e-3)


def test_train_flops_split():
    """A vanilla step is forward + backward: about three forwards' worth,
    less the first conv's input gradient."""
    cfg = spec.load_json(spec.BENCH / "configs" / "deeplabv2-r101.json")
    fwd = flops.serve_flops(cfg, {"batch": 1, "size": [64, 96]})
    step = flops.train_step_flops(cfg, {"batch": 1, "source": [64, 96], "target": None})
    stem = 2 * 64 * 3 * 49 * 32 * 48  # the stem conv's input gradient, not taken
    assert step == pytest.approx(3 * fwd - stem, rel=1e-6)
