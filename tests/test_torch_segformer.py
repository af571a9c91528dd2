"""SegFormer in the port (``models/segformer.py``) against the benchmark's
plain float32 reference (``h100_bench/reference/archs/segformer.py``), on
the CPU at a tiny MiT: widths 8/16/40/64, heads 1/2/5/8 of 8, blocks
1/1/2/1, reduction 8/4/2/1, a 32-wide head, b2 64x128, float32. Weights
come from the benchmark's seeded draw (``lib/weights.make``) and are loaded
into the port. No JAX: the JAX package has no SegFormer.

Tolerances are float32's. Both sides compute the same products, but the
port's attention is one fused kernel (``F.scaled_dot_product_attention``)
where the reference writes the softmax out, its train BatchNorm takes
``E[x^2] - mean^2`` where the reference takes the two-pass variance, and
its resize's backward is the gather of ``kernels/upsample.py``: sums in
other orders, which move a forward by ~1e-6 of its largest value.
"""

import dataclasses

import pytest
import torch

from h100_bench.drivers import serve_closed_loop, train_step
from h100_bench.lib import compare, scenes, spec, weights
from h100_bench.lib.outcome import Context
from h100_bench.lib.port import experiment
from h100_bench.reference import losses as ref_losses
from h100_bench.reference import nets
from h100_bench.reference.serve import logits as ref_logits
from h100_bench.reference.train import Optimizer
from rtda_semanticsegmentation_tpu_torch import serving
from rtda_semanticsegmentation_tpu_torch.config import ModelConfig, OptimizerConfig, get_preset
from rtda_semanticsegmentation_tpu_torch.kernels import upsample as kup
from rtda_semanticsegmentation_tpu_torch.models import quantize
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, load_variables
from rtda_semanticsegmentation_tpu_torch.obs import spans
from rtda_semanticsegmentation_tpu_torch.ops.losses import cross_entropy_with_ignore
from rtda_semanticsegmentation_tpu_torch.train.optim import build_generator_tx

TINY = {"mit_embed_dims": [8, 16, 40, 64], "mit_depths": [1, 1, 2, 1], "mit_num_heads": [1, 2, 5, 8],
        "mit_sr_ratios": [8, 4, 2, 1], "mit_mlp_ratio": 4, "decoder_dim": 32}
B, H, W = 2, 64, 128
SEED = 2147483647 + 19


def _config(name="segformer-b5", **model):
    """A configuration file of the benchmark, at float32 and the tiny MiT
    (SegFormer as G where ``name`` is another configuration)."""
    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    seg = spec.load_json(spec.BENCH / "configs" / "segformer-b5.json")
    cfg["model"] = {**cfg["model"], **{k: seg["model"][k] for k in ("name", *TINY)}, **TINY,
                    "compute_dtype": "float32", **model}
    cfg["augment"] = {**cfg["augment"], "aug_dtype": "float32"}
    cfg["init"] = seg["init"]
    return cfg


def _weights(cfg, train=True, seed=SEED):
    model = cfg["model"]
    return weights.make(nets.param_shapes(model, train), seed, "generator", "cpu", cfg["init"],
                        rule=nets.arch(model).init_rule)


def _port(cfg, w, train):
    model = build_model(experiment(cfg).model, device="cpu", train=train)
    load_variables(model, w)
    return model


def _frames(seed=7):
    gen = torch.Generator().manual_seed(seed)
    frames, labels = scenes.make(B, H, W, gen, 19)
    x = frames.float().div(255.0).sub(0.45).div(0.22)  # any fixed normalization: both sides read x
    return x.permute(0, 3, 1, 2), labels


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_match_reference(train):
    """Eval logits (seeded running statistics) and train-mode logits, whose
    head BatchNorm takes the batch's statistics and moves the running ones."""
    cfg = _config()
    w = _weights(cfg)
    gen = torch.Generator().manual_seed(3)
    for k in w:
        if k.endswith("running_mean"):
            w[k] = torch.randn(w[k].shape, generator=gen) * 0.1
        elif k.endswith("running_var"):
            w[k] = torch.rand(w[k].shape, generator=gen) + 0.5
    x, _ = _frames()
    port = _port(cfg, w, train)
    with torch.no_grad():
        got = port(x)
    got = got[0] if train else got
    stats = {k: v.clone() for k, v in w.items()}
    with torch.no_grad():
        want = nets.generator(cfg["model"], stats, x.contiguous(), train, stats)
    assert got.shape == want.shape == (B, 19, H, W)
    # f32 both sides; sums in other orders (module docstring): ~1e-6 seen
    assert _rel(got, want) < 1e-5
    for k in ("decode_head.linear_fuse.bn.running_mean", "decode_head.linear_fuse.bn.running_var"):
        assert _rel(port.state_dict()[k], stats[k]) < 1e-5, k
        assert torch.equal(stats[k], w[k]) != train  # train moves them, eval reads them


def _leaf_grads():
    cfg = _config()
    w = _weights(cfg)
    x, labels = _frames()
    port = _port(cfg, w, True)
    logits = port(x)[0]
    loss = cross_entropy_with_ignore(logits, labels, 255)
    loss.backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    P = {k: v.clone().requires_grad_(not nets.is_buffer(k)) for k, v in w.items()}
    ref_loss = ref_losses.cross_entropy(nets.generator(cfg["model"], P, x.contiguous(), True, dict(P)), labels, 255)
    leaves = [k for k in P if not nets.is_buffer(k)]
    want = dict(zip(leaves, torch.autograd.grad(ref_loss, [P[k] for k in leaves])))
    return float(loss.detach()), float(ref_loss.detach()), got, want


@pytest.fixture(scope="module")
def grads():
    return _leaf_grads()


def test_cross_entropy_matches_reference(grads):
    loss, ref_loss, _, _ = grads
    # f32 both sides: the logits agree to ~1e-6, the mean over pixels to ~1e-7
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)


GROUPS = ("patch_embed", "attn.q.", "attn.kv.", "attn.proj.", "attn.sr.", "attn.norm.", "norm1.", "norm2.",
          "mlp.fc1.", "mlp.dwconv.", "mlp.fc2.", "linear_c", "linear_fuse.conv", "linear_fuse.bn", "linear_pred")


@pytest.mark.parametrize("group", GROUPS)
def test_every_leaf_gradient_matches_reference(grads, group):
    """Each leaf's gradient, by kind of leaf: its gap over the larger of its
    own norm and the median leaf's."""
    _, _, got, want = grads
    assert got.keys() == want.keys()
    norms = sorted(float(g.norm()) for g in want.values())
    median = norms[len(norms) // 2]
    names = [k for k in want if group in k]
    assert names
    for k in names:
        assert got[k] is not None, k
        # f32 both sides, sums in other orders: at most ~1e-5 seen, but for
        # the head's Linear biases, which sit ahead of the train BatchNorm
        # whose mean cancels them: their gradients are round-off, ~6e-5
        assert float((got[k] - want[k]).norm()) <= 3e-4 * max(float(want[k].norm()), median), k


def _first_steps(name, traffic, steps):
    cfg = _config(name)
    base = spec.load_json(spec.BENCH / "traffic" / ("gta5_to_cityscapes_b8.json" if traffic.get("target")
                                                    else "cityscapes_b8.json"))
    traffic = {**base, **traffic, "first_steps": steps}
    ctx = Context(cell="test", seed=SEED, seconds=0.1, trace=False, config=cfg, traffic=traffic, settings={},
                  device="cpu")
    prog = train_step.Program(ctx)
    read = prog.first_steps(steps)
    ref = train_step.reference(ctx, prog.ring, prog.gen_states)
    return read, ref, compare.train_numbers(read, ref)


def test_three_adamw_steps_follow_reference():
    """``source_step`` with AdamW at 6e-5 (the configuration's), three
    steps on distinct batches, against ``reference/train.py::follow``."""
    read, ref, got = _first_steps("segformer-b5", {"batch": B, "source": [H, W], "target": None}, 3)
    assert read["grad"].keys() == ref["grad"].keys()
    # f32 both sides: the losses to ~1e-7, the gradients to ~2e-5; AdamW's
    # first steps divide by the root of tiny second moments, so the worst
    # leaf's change moves by ~1.4e-3 (the running mean: BatchNorm's variance)
    assert compare.rel_gap(read["loss"][0], ref["loss"][0]) < 1e-5, got
    assert got["loss"] < 1e-4 and got["grad1"] < 1e-3 and got["change3"] < 1e-2, got
    assert got["grad1_median"] < 1e-5 and got["change3_median"] < 1e-4, got


def test_adversarial_lovasz_step_with_segformer_as_g():
    """One flagship step (augmentation, D's step, CE + binned Lovász, the
    adversarial BCE through the updated D) with SegFormer as G."""
    read, ref, got = _first_steps("bisenet-r18", {"batch": B, "source": [H, W], "target": [H, W]}, 1)
    assert any(k.startswith("g.backbone.") for k in read["grad"]) and any(k.startswith("d.") for k in read["grad"])
    # f32 both sides; the augmentation's colour ops and the binned Lovász
    # sum in other orders (h100_bench/tests/test_bench_reference.py): the
    # loss ~4e-6, the gradients and changes ~1e-4 seen
    assert got["loss"] < 1e-4 and got["loss_d"] < 1e-5, got
    assert got["grad1"] < 3e-3 and got["change3"] < 3e-3, got


def test_serving_masks_match_reference_argmax():
    cfg = _config()
    exp = experiment(cfg)
    w = serve_closed_loop.make_weights(cfg, {"size": [H, W]}, SEED, "cpu")
    fn = serving.make_serving_fn(exp.model, exp.augment, w, "f32", device="cpu")
    frames, _ = scenes.make(B, H, W, torch.Generator().manual_seed(1))
    want = ref_logits(cfg, w, frames)
    # f32 both sides (module docstring)
    assert _rel(fn.logits(frames), want) < 1e-5
    assert compare.mask_numbers(want, fn(frames))["mask_gap"] < 1e-5


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_b5_param_shapes_are_the_ports_state_dict(train):
    """At MiT-B5's published widths, on ``meta``: the reference's tensor
    list is the port's ``state_dict``, name by name in order, shape by
    shape (84.6 M parameters)."""
    cfg = spec.load_json(spec.BENCH / "configs" / "segformer-b5.json")
    port = build_model(experiment(cfg).model, device="meta", train=train).state_dict()
    want = nets.param_shapes(cfg["model"], train)
    assert [(k, tuple(v.shape)) for k, v in port.items()] == [(k, tuple(s)) for k, s in want]
    assert sum(v.numel() for k, v in port.items() if not nets.is_buffer(k)) == 84_607_955


def test_b5_preset_is_the_configuration():
    cfg = spec.load_json(spec.BENCH / "configs" / "segformer-b5.json")
    exp, preset = experiment(cfg), get_preset("segformer_cityscapes")
    assert exp.model == preset.model and exp.optimizer == preset.optimizer
    assert (preset.optimizer.name, preset.optimizer.learning_rate, preset.optimizer.weight_decay,
            preset.optimizer.poly_power) == ("adamw", 6e-5, 0.01, 1.0)
    assert (preset.model.mit_embed_dims, preset.model.mit_depths, preset.model.mit_num_heads,
            preset.model.mit_sr_ratios, preset.model.decoder_dim) == ((64, 128, 320, 512), (3, 6, 40, 3),
                                                                       (1, 2, 5, 8), (8, 4, 2, 1), 768)


@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_adamw_is_torchs_and_the_references(wd):
    """``build_generator_tx`` with ``adamw``: PyTorch's AdamW, decay
    decoupled, ``eps`` outside the root; three steps at falling rates match
    ``reference/train.py::Optimizer`` (itself held to PyTorch's)."""
    model = build_model(ModelConfig(name="segformer", compute_dtype="float32",
                                    **{k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()}),
                        device="cpu", train=True)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    cfg = OptimizerConfig(name="adamw", learning_rate=6e-5, weight_decay=wd, adam_b1=0.9, adam_b2=0.999)
    tx = build_generator_tx(cfg, model)
    assert type(tx) is torch.optim.AdamW
    assert [(g["weight_decay"], g["betas"], g["eps"]) for g in tx.param_groups] == [(wd, (0.9, 0.999), 1e-8)]
    ref = Optimizer("adamw", wd, betas=(0.9, 0.999))
    mine = {k: p.detach().clone() for k, p in model.named_parameters()}
    for lr in (6e-5, 4e-5, 2e-5):
        grads = {k: torch.randn(p.shape, generator=gen) for k, p in model.named_parameters()}
        for group in tx.param_groups:
            group["lr"] = lr
        for k, p in model.named_parameters():
            p.grad = grads[k].clone()
        tx.step()
        mine = {k: ref.step(k, mine[k], grads[k], lr) for k in mine}
    for k, p in model.named_parameters():
        # f32 both sides, the same expressions in another order
        torch.testing.assert_close(p.detach(), mine[k], rtol=1e-6, atol=1e-9)


# the head's resizes at b8 512x1024: stages 2-4 (768 wide) to the 1/4 grid,
# and the logits x4 to the input
HEAD_RESIZES = {"c2": (768, (64, 128), (128, 256)), "c3": (768, (32, 64), (128, 256)),
                "c4": (768, (16, 32), (128, 256)), "logits": (19, (128, 256), (512, 1024))}
LAYOUTS = [(site, layout) for site in HEAD_RESIZES for layout in (kup.TILED, kup.MERGED, kup.ROWS)
           if layout != kup.TILED or HEAD_RESIZES[site][0] % 8 == 0]


@pytest.mark.parametrize("site,layout", LAYOUTS, ids=[f"{s}-{('tiled', 'merged', 'rows')[lay]}" for s, lay in LAYOUTS])
def test_resize_backward_plans_fit_the_head_in_bf16(site, layout):
    """U1 takes each of the head's resizes at b8 in bf16, in every layout
    that can read it: within a block's shared memory and 256 threads."""
    c, in_hw, out_hw = HEAD_RESIZES[site]
    p = kup.launch_plan(8, c, in_hw, out_hw, layout, 2, 132)
    assert p["smem"] <= 232448 and p["threads"] <= 256 and p["e"] * p["threads"] >= p["tw"] * p["tc"]


def test_resize_backward_merged_f32_x8_is_refused():
    """A limit the head's shapes reach: MERGED reads all 768 channels of a
    column at once, which in f32 at x8 needs more shared memory than a
    block has. The plan raises instead of launching."""
    with pytest.raises(ValueError, match="above 232448"):
        kup.launch_plan(8, 768, (16, 32), (128, 256), kup.MERGED, 4, 132)


@pytest.mark.parametrize("quant,fused", [("calib", False), ("int8", False), ("int8_frozen", False), ("none", True)])
def test_int8_and_fused_conv3_raise(quant, fused):
    cfg = dataclasses.replace(get_preset("segformer_cityscapes").model, quant=quant)
    with pytest.raises(ValueError, match="segformer runs in float only"):
        build_model(cfg, device="meta", fused_conv3=fused)


def test_int8_serving_raises():
    with pytest.raises(ValueError, match="segformer runs in float only"):
        quantize.quantized_model(get_preset("segformer_cityscapes").model, device="meta")


def test_attention_calls_counted():
    cfg = _config()
    port = _port(cfg, _weights(cfg), False)
    before = spans.counter("attention.calls")
    with torch.no_grad():
        port(_frames()[0])
    assert spans.counter("attention.calls") - before == sum(TINY["mit_depths"])
