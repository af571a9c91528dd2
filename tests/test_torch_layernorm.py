"""LayerNorm (``kernels/layernorm.py``) on the CPU: the plain version and
the backward's expressions against f64 autograd, ``launch_plan`` at every
shape SegFormer-B5 runs, ``chip_smoke.LN_SHAPES`` against a census of the
model, the module's CPU path (today's ``F.layer_norm`` bits), and what the
card's entry points refuse. The kernels themselves are checked on a card
(``tests/test_torch_cuda.py -k layernorm``)."""

import collections

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from rtda_semanticsegmentation_tpu_torch.kernels import layernorm as kln
from rtda_semanticsegmentation_tpu_torch.models.layers import LayerNorm
from rtda_semanticsegmentation_tpu_torch.models.segformer import SegFormer, _Stages
from rtda_semanticsegmentation_tpu_torch.obs import spans

WIDTHS = (64, 128, 320, 512)
EPS = 1e-6


def _case(rows, c, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, c), generator=g, dtype=torch.float64) * 1.5 + torch.randn((rows, 1), generator=g,
                                                                                      dtype=torch.float64)
    weight = 1 + 0.2 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    dy = torch.randn((rows, c), generator=g, dtype=torch.float64)
    return x, weight, bias, dy


def _f64_autograd(x, weight, bias, dy):
    """y and the three gradients of the unrounded function, in f64."""
    x64 = x.double().requires_grad_(True)
    w64, b64 = weight.double().requires_grad_(True), bias.double().requires_grad_(True)
    y = F.layer_norm(x64, w64.shape, w64, b64, EPS)
    return (y.detach(), *torch.autograd.grad(y, (x64, w64, b64), dy.double()))


@pytest.mark.parametrize("c", WIDTHS)
def test_plain_version_against_f64_autograd(c):
    """In f32 on 7 rows: y, dx, dweight and dbias of ``layer_norm_plain``
    through autograd within 1e-5 of f64 autograd's largest value (f32
    sums)."""
    x, weight, bias, dy = _case(7, c, c)
    xf = x.float().requires_grad_(True)
    wf, bf = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    y = kln.layer_norm_plain(xf, wf, bf, EPS)
    got = (y.detach(), *torch.autograd.grad(y, (xf, wf, bf), dy.float()))
    for g, w in zip(got, _f64_autograd(x.float(), weight, bias, dy.float())):
        assert (g.double() - w).abs().max().item() <= 1e-5 * w.abs().max().item()


@pytest.mark.parametrize("c", WIDTHS)
def test_backward_expressions_against_f64_autograd(c):
    """``layer_norm_grad_plain`` (the kernels' backward) in f64 on the f64
    statistics of ``row_stats_plain`` is autograd's gradient, to f64
    round-off; in f32 within 1e-5 of the largest value."""
    x, weight, bias, dy = _case(5, c, 100 + c)
    want = _f64_autograd(x, weight, bias, dy)[1:]
    mean, rstd = kln.row_stats_plain(x, EPS)
    assert torch.allclose(mean, x.mean(-1)) and torch.allclose(rstd, 1 / torch.sqrt(x.var(-1, unbiased=False) + EPS))
    for g, w in zip(kln.layer_norm_grad_plain(dy, x, weight.double(), mean, rstd), want):
        assert (g - w).abs().max().item() <= 1e-12 * w.abs().max().item()
    mean32, rstd32 = kln.row_stats_plain(x.float(), EPS, torch.float32)
    got = kln.layer_norm_grad_plain(dy.float(), x.float(), weight, mean32, rstd32, torch.float32)
    for g, w in zip(got, _f64_autograd(x.float(), weight, bias, dy.float())[1:]):
        assert (g.double() - w).abs().max().item() <= 1e-5 * w.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("where,rows,c,norms", chip_smoke.LN_SHAPES, ids=[s[0] for s in chip_smoke.LN_SHAPES])
def test_launch_plan_at_b5_shapes(where, rows, c, norms, dtype):
    """Every width B5 runs fills whole 16-byte vectors with no idle slot,
    stage 3's 320 too (bf16: 8 lanes of 5 vectors, 40 elements a thread, so
    its backward runs blocks of 128); the forward's grid and the
    backward's blocks cover the rows in one wave, the backward's at most 4
    blocks an SM."""
    plan = kln.launch_plan(rows, c, dtype)
    vec = 128 // torch.finfo(dtype).bits
    assert plan["v"] == vec and plan["lanes"] * plan["n"] * plan["v"] == c
    assert plan["lanes"] in (1, 2, 4, 8, 16, 32) and 1 <= plan["n"] <= kln.MAX_N
    assert plan["grid"] <= 4 * 132 and plan["grid"] * (plan["threads"] // plan["lanes"]) <= max(rows, 4 * 132 * 256)
    assert plan["blocks"] * plan["rows_per_block"] >= rows > (plan["blocks"] - 1) * plan["rows_per_block"]
    assert plan["rows_per_block"] % (plan["bwd_threads"] // plan["lanes"]) == 0 and plan["blocks"] <= 4 * 132
    assert plan["bwd_threads"] == (128 if plan["n"] * plan["v"] > kln.LIGHT else 256) and plan["threads"] == 256
    if (c, dtype) == (320, torch.bfloat16):
        assert (plan["lanes"], plan["n"], plan["bwd_threads"]) == (8, 5, 128)


@pytest.mark.parametrize("rows,c,dtype,want", [
    (77, 96, torch.bfloat16, (8, 4, 3)),     # three vectors a thread
    (8, 1280, torch.bfloat16, (8, 32, 5)),   # the widest row
    (3, 64, torch.float32, (4, 16, 1)),
    (1000, 320, torch.float32, (4, 16, 5)),  # stage 3's width in f32
    (5, 8, torch.bfloat16, (8, 1, 1)),       # one vector a row
])
def test_launch_plan_edges(rows, c, dtype, want):
    """(v, lanes, n) off the main path: the group's vectors are exactly the
    row's."""
    plan = kln.launch_plan(rows, c, dtype)
    assert (plan["v"], plan["lanes"], plan["n"]) == want
    assert plan["lanes"] * plan["n"] * plan["v"] == c
    assert plan["bwd_threads"] == (128 if plan["n"] * plan["v"] > kln.LIGHT else 256)


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="bf16 or f32"):
        kln.launch_plan(4, 64, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        kln.launch_plan(0, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds"):
        kln.launch_plan(4, 2048, torch.bfloat16)


@pytest.mark.parametrize("c,dtype,match", [
    (100, torch.bfloat16, "whole 16-byte vectors"),  # 12.5 vectors
    (33, torch.float32, "whole 16-byte vectors"),
    (56, torch.bfloat16, "exceeds"),                 # 7 vectors: 1 lane of 7
    (1280, torch.float32, "exceeds"),                # 320 vectors: 32 lanes of 10
])
def test_launch_plan_refuses_rows_the_grouping_does_not_fill(c, dtype, match):
    """A row that is no whole number of 16-byte vectors, or whose vectors
    no power-of-two group of at most 32 lanes holds exactly, 5 a lane at
    most, is refused: the kernels leave no slot of a row idle."""
    with pytest.raises(ValueError, match=match):
        kln.launch_plan(4, c, dtype)


def test_ln_shapes_are_b5s_norms():
    """``chip_smoke.LN_SHAPES`` is what a b8 512x1024 forward of SegFormer-B5
    normalizes (on the meta device, no data): 161 norms, every one of the
    encoder's LayerNorms once, as a graph replay counts them."""
    with torch.device("meta"):
        model = SegFormer(dtype=torch.bfloat16).train()
    seen = collections.Counter()
    for m in model.backbone.modules():
        if isinstance(m, LayerNorm):
            m.register_forward_hook(lambda m, i, o: seen.update([(i[0].numel() // i[0].shape[-1], i[0].shape[-1])]))
    x = torch.empty((8, 3, 512, 1024), device="meta", dtype=torch.bfloat16)
    model.backbone(x.contiguous(memory_format=torch.channels_last))
    assert dict(seen) == {(rows, c): norms for _, rows, c, norms in chip_smoke.LN_SHAPES}
    assert sum(seen.values()) == _Stages(model.backbone).norms == 161


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_module_on_the_cpu_is_f_layer_norm(dtype):
    """On a CPU tensor ``layers.LayerNorm`` gives the bits it always gave:
    ``F.layer_norm`` on the parameters cast to its dtype, output and
    gradients; the kernels' counters do not move."""
    x, weight, bias, dy = _case(6 * 5, 320, 7)
    norm = LayerNorm(320, EPS, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    before = [spans.counter(f"layernorm.{k}") for k in ("fwd_calls", "bwd_calls", "copies")]
    xg = x.float().view(6, 5, 320).requires_grad_(True)
    y = norm(xg)
    y.backward(dy.view(6, 5, 320).to(dtype))
    wg, bg = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    xw = x.float().view(6, 5, 320).requires_grad_(True)
    want = F.layer_norm(xw.to(dtype), wg.shape, wg.to(dtype), bg.to(dtype), EPS)
    want.backward(dy.view(6, 5, 320).to(dtype))
    assert y.dtype == dtype and torch.equal(y, want)
    assert torch.equal(xg.grad, xw.grad) and torch.equal(norm.weight.grad, wg.grad)
    assert torch.equal(norm.bias.grad, bg.grad)
    assert [spans.counter(f"layernorm.{k}") for k in ("fwd_calls", "bwd_calls", "copies")] == before


def test_card_entry_points_refuse_cpu_and_other_dtypes():
    """The kernels' entry points check before they launch: a CPU tensor,
    fp16, rows that are not dense, parameters that are not f32 vectors of
    the width."""
    x, weight, bias, dy = _case(4, 64, 3)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kln.layer_norm_forward(xb, weight, bias, EPS)
    with pytest.raises(ValueError, match="bf16 or f32"):
        kln.layer_norm_forward(x.half(), weight, bias, EPS)
    with pytest.raises(ValueError, match="dense rows"):
        kln.layer_norm_forward(xb.t(), weight[:4], bias[:4], EPS)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kln.layer_norm_forward(xb.flatten()[1:253].view(4, 63), weight[:63], bias[:63], EPS)
    with pytest.raises(ValueError, match="f32 vectors"):
        kln.layer_norm_forward(xb, weight.double(), bias, EPS)
    with pytest.raises(ValueError, match="dy must match"):
        kln.layer_norm_backward(dy.float(), xb, weight, None, None)


def test_operand_copies_and_counts_what_the_kernels_do_not_take():
    """Rows that are not dense, or that start off a 16-byte boundary, are
    copied, each copy counted."""
    x = torch.zeros((8, 64), dtype=torch.bfloat16)
    before = spans.counter("layernorm.copies")
    assert kln.takes(x) and kln.operand(x) is x
    for odd in (x.t().contiguous().t(), torch.zeros(8 * 64 + 1, dtype=torch.bfloat16)[1:].view(8, 64)):
        assert not kln.takes(odd)
        assert kln.takes(kln.operand(odd))
    assert spans.counter("layernorm.copies") == before + 2
