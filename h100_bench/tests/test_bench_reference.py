"""The plain reference against the port at tiny sizes in float32 on the
CPU: the augmentation, the serving forward and the first train steps."""

import pytest
import torch

from h100_bench.drivers import serve_closed_loop, train_step
from h100_bench.lib import compare, scenes, spec
from h100_bench.lib.outcome import Context
from h100_bench.lib.port import experiment
from h100_bench.reference import augment as ref_aug
from h100_bench.reference.serve import logits as ref_logits


def _config(name):
    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    cfg["model"] = {**cfg["model"], "compute_dtype": "float32"}
    cfg["augment"] = {**cfg["augment"], "aug_dtype": "float32"}
    return cfg


def test_augmentation_draws_and_ops():
    from rtda_semanticsegmentation_tpu_torch.ops.augment import augment_batch

    cfg = _config("bisenet-r18")
    gen = torch.Generator().manual_seed(4)
    frames, labels = scenes.make(6, 40, 56, gen)
    aug = experiment(cfg).augment
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    want, want_labels = augment_batch(frames, labels, g1, aug)
    got, got_labels = ref_aug.augment(frames, labels, g2, cfg["augment"])
    assert torch.equal(got_labels, want_labels)
    # the same draws in the same order: both generators end in the same state
    assert torch.equal(g1.get_state(), g2.get_state())
    diff = (got - want).abs()
    assert float(diff.mean()) < 1e-4 and float((diff > 1e-3).float().mean()) < 1e-3


def test_serving_forward():
    cfg = _config("bisenet-r18")
    from rtda_semanticsegmentation_tpu_torch import serving

    exp = experiment(cfg)
    w = serve_closed_loop.make_weights(cfg, {"size": [64, 96]}, 5, "cpu")
    fn = serving.make_serving_fn(exp.model, exp.augment, w, "f32", device="cpu")
    frames, _ = scenes.make(2, 64, 96, torch.Generator().manual_seed(1))
    want = fn.logits(frames)
    got = ref_logits(cfg, w, frames)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert compare.mask_numbers(got, fn(frames))["mask_gap"] < 1e-5


@pytest.mark.parametrize("name,traffic", [
    ("bisenet-r18", {"batch": 8, "source": [64, 96], "target": [64, 96]}),
    ("deeplabv2-r101", {"batch": 4, "source": [64, 96], "target": None}),
])
def test_first_steps(name, traffic):
    cfg = _config(name)
    traffic = {**spec.load_json(spec.BENCH / "traffic" / ("gta5_to_cityscapes_b8.json" if traffic["target"]
                                                          else "cityscapes_b8.json")), **traffic, "first_steps": 2}
    ctx = Context(cell="test", seed=2147483647 + 40, seconds=0.1, trace=False, config=cfg, traffic=traffic,
                  settings={}, device="cpu")
    prog = train_step.Program(ctx)
    read = prog.first_steps(traffic["first_steps"])
    ref = train_step.reference(ctx, prog.ring, prog.gen_states)
    got = compare.train_numbers(read, ref)
    # float32 on both sides: the port's train BatchNorm takes E[x^2] - mean^2,
    # the reference the two-pass variance, which moves the gradients by ~1e-4;
    # DeepLabV2's first SGD step from random weights is large, so its second
    # loss moves by ~1e-3
    assert compare.rel_gap(read["loss"][0], ref["loss"][0]) < 1e-5, got
    assert got["loss"] < 3e-3 and got["grad1"] < 3e-3 and got["change3"] < 3e-3, got
    assert read["grad"].keys() == ref["grad"].keys()
