"""Train-mode BatchNorm (``kernels/batchnorm.py``) on the CPU: the plain
path the layer takes there against the module's expressions as they stood
before the kernels (written out below as ``_module_train`` and, data
parallel, ``_module_train_dp``), bit for bit: forward, running statistics
and autograd's gradients; the data-parallel path (two ranks as threads,
``thread_mesh.py``) against one process on the whole batch; the kernels'
backward in plain PyTorch against f64 autograd, data parallel too; the
launch plan and the checks the wrapper makes before it launches; and the
kernels' names in the trace's ``elementwise`` group.

Tolerances, each with its reason: the closed-form backward in f64 against
f64 autograd, 1e-10 of the largest gradient (the same sums in another
order); in f32, 2e-5 of it (f32 sums over 1,000 to 4,000 elements); two
ranks against one process in f64, 1e-12 (sums in another order).
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from h100_bench.lib.trace import group
from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn
from rtda_semanticsegmentation_tpu_torch.models.layers import ConvBN, FoldableBatchNorm, running_stats_held
from thread_mesh import run_ranks

EPS, MOMENTUM = 1e-5, 0.9
SOURCE = Path(kbn.__file__).resolve().parents[1] / kbn.SOURCE


def _module_train(x, weight, bias, running_mean, running_var, update, relu):
    """``FoldableBatchNorm.forward`` in train mode (no mesh) and the
    ConvBN's ReLU, as the module wrote them before the kernels."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.numel() // x.shape[1]
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
    if update:
        with torch.no_grad():
            m = MOMENTUM
            unbiased = n / max(n - 1, 1)
            running_mean.copy_(m * running_mean + (1 - m) * mean)
            running_var.copy_(m * running_var + (1 - m) * var * unbiased)
    mul = weight * torch.rsqrt(var + EPS)
    add = bias - mean * mul
    y = x * mul.to(x.dtype).view(1, -1, 1, 1) + add.to(x.dtype).view(1, -1, 1, 1)
    return F.relu(y) if relu else y


def _module_train_dp(x, weight, bias, running_mean, running_var, update, relu, mesh):
    """The same, data parallel (``mesh``), as the module wrote it before the
    kernels."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = x.shape[1]
    count = torch.full((1,), float(x.numel() // c), dtype=xf.dtype, device=x.device)
    sums = mesh.sum(torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)), count]))
    n = sums[2 * c]
    mean = sums[:c] / n
    var = sums[c: 2 * c] / n - mean.square()
    if update:
        with torch.no_grad():
            m = MOMENTUM
            unbiased = n / (n - 1).clamp_min(1)
            running_mean.copy_(m * running_mean + (1 - m) * mean)
            running_var.copy_(m * running_var + (1 - m) * var * unbiased)
    mul = weight * torch.rsqrt(var + EPS)
    add = bias - mean * mul
    y = x * mul.to(x.dtype).view(1, -1, 1, 1) + add.to(x.dtype).view(1, -1, 1, 1)
    return F.relu(y) if relu else y


def _case(dtype, layout, seed=0, shape=(4, 24, 9, 13)):
    """x (requires grad), weight, bias, running statistics and dy, seeded;
    x off-centre per channel, as a conv's output is."""
    g = torch.Generator().manual_seed(seed)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=g) * 1.5 + torch.randn((1, c, 1, 1), generator=g)).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    weight = 1 + 0.2 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    stats = (0.1 * torch.randn(c, generator=g), 1 + 0.1 * torch.rand(c, generator=g))
    dy = torch.randn(shape, generator=g).to(dtype)
    return x, weight, bias, stats, dy


def _run(fn, x, weight, bias, stats, dy, update, relu):
    """``fn``'s output, running statistics after it, and the gradients of
    x, weight and bias for ``dy``, from fresh leaves."""
    x = x.detach().clone().requires_grad_(True)
    weight, bias = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    rm, rv = stats[0].clone(), stats[1].clone()
    y = fn(x, weight, bias, rm, rv, update, relu)
    y.backward(dy)
    return y.detach(), rm, rv, x.grad, weight.grad, bias.grad


def _plain(x, weight, bias, rm, rv, update, relu):
    return kbn.batch_norm_train(x, weight, bias, rm, rv, eps=EPS, momentum=MOMENTUM, update=update, relu=relu)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_is_the_module_expressions_bit_for_bit(dtype, layout, relu):
    x, weight, bias, stats, dy = _case(dtype, layout)
    want = _run(_module_train, x, weight, bias, stats, dy, True, relu)
    got = _run(_plain, x, weight, bias, stats, dy, True, relu)
    for name, a, b in zip(("y", "running_mean", "running_var", "dx", "dweight", "dbias"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got[0].is_contiguous(memory_format=torch.channels_last) == (layout == "channels_last")


def test_gate_plain_path_reduces_over_the_batch():
    """The ARM's gate: (B, C, 1, 1) f32 statistics over the batch alone,
    n = B in the unbiased factor."""
    x, weight, bias, stats, dy = _case(torch.float32, "nchw", seed=3, shape=(8, 32, 1, 1))
    want = _run(_module_train, x, weight, bias, stats, dy, True, False)
    got = _run(_plain, x, weight, bias, stats, dy, True, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    xf = x.double().flatten(1)
    assert torch.allclose(got[2].double(), 0.9 * stats[1].double() + 0.1 * xf.var(dim=0, unbiased=True),
                          rtol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
def test_plain_path_holds_the_running_statistics(relu):
    x, weight, bias, stats, dy = _case(torch.bfloat16, "channels_last", seed=5)
    y, rm, rv, *grads = _run(_plain, x, weight, bias, stats, dy, False, relu)
    assert torch.equal(rm, stats[0]) and torch.equal(rv, stats[1])
    want = _run(_module_train, x, weight, bias, stats, dy, True, relu)
    assert torch.equal(y, want[0]) and all(torch.equal(a, b) for a, b in zip(grads, want[3:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bn_train_and_eval_match_the_module_expressions(dtype):
    """Through the modules: a ConvBN in train mode (its ReLU), then inside
    ``running_stats_held``, then in eval mode, each against the expressions
    written out."""
    torch.manual_seed(0)
    block = ConvBN(6, 24, 3, 1, 1, dtype=dtype)
    for p in (block.conv.weight, block.bn.weight, block.bn.bias):
        torch.nn.init.normal_(p, 1.0 if p is block.bn.weight else 0.0, 0.1)
    inp = torch.randn(2, 6, 10, 12).to(dtype).contiguous(memory_format=torch.channels_last)
    bn = block.bn
    start = (bn.running_mean.clone(), bn.running_var.clone())
    block.train()
    conv_out = block.conv(inp).detach()
    rm, rv = start[0].clone(), start[1].clone()
    want = _module_train(conv_out, bn.weight, bn.bias, rm, rv, True, True).to(dtype)
    assert torch.equal(block(inp), want)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)
    with running_stats_held(block):
        assert torch.equal(block(inp), want)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)
    block.eval()
    mul = bn.weight * torch.rsqrt(bn.running_var + EPS)
    add = bn.bias - bn.running_mean * mul
    want = F.relu(conv_out * mul.to(dtype).view(1, -1, 1, 1) + add.to(dtype).view(1, -1, 1, 1)).to(dtype)
    assert torch.equal(block(inp), want)


def test_foldable_batch_norm_takes_no_relu_by_default():
    bn = FoldableBatchNorm(16).train()
    x, *_ = _case(torch.float32, "nchw", seed=7, shape=(2, 16, 5, 5))
    rm, rv = torch.zeros(16), torch.ones(16)
    y = bn(x)
    assert (y < 0).any()
    assert torch.equal(y, _module_train(x, bn.weight, bn.bias, rm, rv, True, False))


def _f64_grads(dy, x, weight, bias, relu):
    """f64 autograd of the forward's expressions without rounding, the
    ReLU's mask fixed to where the forward's output (from the plain
    coefficients) is above 0."""
    x64 = x.detach().double().requires_grad_(True)
    w64, b64 = weight.double().requires_grad_(True), bias.double().requires_grad_(True)
    mean, var, _ = kbn.statistics(x64)
    z = kbn.apply_scale_shift(x64, *kbn.scale_shift(w64, b64, mean, var, EPS))
    g = dy.double()
    if relu:
        coef = kbn.coefficients_plain(x.detach(), weight, bias, EPS)
        g = g * (kbn.apply_scale_shift(x.detach(), coef[2], coef[3]) > 0)
    z.backward(g)
    return x64.grad, w64.grad, b64.grad


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_closed_form_backward_is_autograds_gradient(dtype, layout, relu):
    """The kernels' backward (its plain version) against f64 autograd of the
    forward: dx, dweight, dbias."""
    x, weight, bias, _, dy = _case(dtype, layout, seed=11)
    coef = kbn.coefficients_plain(x, weight, bias, EPS)
    got = kbn.batch_norm_grad_plain(dy, x, weight, coef, relu=relu)
    want = _f64_grads(dy, x, weight, bias, relu)
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    for a, b in zip(got, want):
        assert (a.double() - b).abs().max().item() <= tol * b.abs().max().item()
    assert got[0].dtype == dtype


def test_closed_form_backward_in_bf16_is_within_one_rounding():
    """bf16 activations: dx within one bf16 ulp of f64 autograd (f32 sums,
    one rounding) and no further from it than autograd of the plain
    version, which rounds at each bf16 step."""
    x, weight, bias, stats, dy = _case(torch.bfloat16, "channels_last", seed=13)
    coef = kbn.coefficients_plain(x, weight, bias, EPS)
    dx = kbn.batch_norm_grad_plain(dy, x, weight, coef, relu=True)[0]
    want = _f64_grads(dy, x, weight, bias, True)[0]
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    assert ((dx.double() - want).abs() <= ulp + 1e-6 * want.abs().max()).all()
    chain = _run(_plain, x, weight, bias, stats, dy, False, True)[3]
    assert (dx.double() - want).abs().max() <= (chain.double() - want).abs().max()


def test_coefficients_plain_are_the_plain_forwards():
    x, weight, bias, *_ = _case(torch.bfloat16, "channels_last", seed=17)
    mean, var, n = kbn.statistics(x)
    assert n == 4 * 9 * 13
    mul, add = kbn.scale_shift(weight, bias, mean, var, EPS)
    coef = kbn.coefficients_plain(x, weight, bias, EPS)
    assert coef.shape == (4, 24) and coef.dtype == torch.float32
    assert torch.equal(coef[0], mean) and torch.equal(coef[2], mul) and torch.equal(coef[3], add)
    assert torch.equal(kbn.apply_scale_shift(x, coef[2], coef[3]),
                       _module_train(x, weight, bias, torch.zeros(24), torch.ones(24), False, False))


def _ranks_case(dtype, seed, ranks=2, shape=(2, 24, 9, 13)):
    """Each rank's (x, dy), of other rows and other means, and the weight,
    bias and running statistics the ranks share."""
    cases = [_case(dtype, "channels_last", seed + r, shape) for r in range(ranks)]
    _, weight, bias, stats, _ = cases[0]
    return [(c[0], c[4]) for c in cases], weight, bias, stats


def _plain_dp(mesh):
    def fn(x, weight, bias, rm, rv, update, relu):
        return kbn.batch_norm_train(x, weight, bias, rm, rv, eps=EPS, momentum=MOMENTUM, update=update, relu=relu,
                                    mesh=mesh)
    return fn


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_data_parallel_plain_path_is_the_module_expressions_bit_for_bit(dtype, relu):
    """Two ranks: each rank's output, running statistics and gradients the
    bits of the module's former data-parallel expressions."""
    per_rank, weight, bias, stats = _ranks_case(dtype, 21)

    def rank(mesh, x, dy):
        got = _run(_plain_dp(mesh), x, weight, bias, stats, dy, True, relu)
        want = _run(lambda *a: _module_train_dp(*a, mesh), x, weight, bias, stats, dy, True, relu)
        return got, want

    for got, want in run_ranks(rank, per_rank):
        for name, a, b in zip(("y", "running_mean", "running_var", "dx", "dweight", "dbias"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("relu", [True, False])
def test_data_parallel_is_one_process_on_the_whole_batch(relu):
    """In f64, two ranks give the rows of one process's output and input
    gradient on the whole batch, its running statistics on every rank, and
    its parameter gradients as the sum of the ranks' (the step sums them)."""
    per_rank, weight, bias, stats = _ranks_case(torch.float64, 23)
    weight, bias, stats = weight.double(), bias.double(), tuple(t.double() for t in stats)
    ranks = run_ranks(lambda mesh, x, dy: _run(_plain_dp(mesh), x, weight, bias, stats, dy, True, relu), per_rank)
    whole = _run(_plain, torch.cat([x for x, _ in per_rank]), weight, bias, stats,
                 torch.cat([dy for _, dy in per_rank]), True, relu)

    def close(a, b):
        return (a - b).abs().max().item() <= 1e-12 * max(b.abs().max().item(), 1.0)

    assert close(torch.cat([r[0] for r in ranks]), whole[0]) and close(torch.cat([r[3] for r in ranks]), whole[3])
    assert all(close(r[1], whole[1]) and close(r[2], whole[2]) for r in ranks)
    assert close(sum(r[4] for r in ranks), whole[4]) and close(sum(r[5] for r in ranks), whole[5])
    assert not close(ranks[0][4], whole[4])


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_data_parallel_closed_form_backward_is_autograds_gradient(dtype, relu):
    """The kernels' data-parallel backward (its plain version: every rank's
    sums in dx, the rank's own in dweight and dbias) against f64 autograd of
    the data-parallel forward, on each of two ranks."""
    per_rank, weight, bias, _ = _ranks_case(dtype, 25)

    def rank(mesh, x, dy):
        coef = kbn.coefficients_plain(x, weight, bias, EPS, mesh)
        got = kbn.batch_norm_grad_plain(dy, x, weight, coef, relu=relu, mesh=mesh)
        x64 = x.double().requires_grad_(True)
        w64, b64 = weight.double().requires_grad_(True), bias.double().requires_grad_(True)
        z = kbn.batch_norm_train_plain(x64, w64, b64, torch.zeros(24, dtype=torch.float64),
                                       torch.ones(24, dtype=torch.float64), eps=EPS, momentum=MOMENTUM,
                                       update=False, relu=False, mesh=mesh)
        g = dy.double()
        if relu:
            g = g * (kbn.apply_scale_shift(x, coef[2], coef[3]) > 0)
        z.backward(g)
        return got, (x64.grad, w64.grad, b64.grad)

    tol = 1e-10 if dtype == torch.float64 else 2e-5
    for got, want in run_ranks(rank, per_rank):
        assert got[0].dtype == dtype
        for a, b in zip(got, want):
            assert (a.double() - b).abs().max().item() <= tol * b.abs().max().item()


# (where, rows, C, element bytes): the train-mode BatchNorms of the
# benchmark's cells, batch 8, and the kernels' odd cases
PLAN_CASES = [
    ("r18 stem, source 720x1280", 8 * 360 * 640, 64, 2),
    ("r18 layer4, target", 8 * 16 * 32, 512, 2),
    ("dlv2 layer3 conv1/conv2", 8 * 65 * 129, 256, 2),
    ("dlv2 layer3 conv3", 8 * 65 * 129, 1024, 2),
    ("dlv2 layer4 conv3", 8 * 65 * 129, 2048, 2),
    ("segformer linear_fuse", 8 * 128 * 256, 768, 2),
    ("arm gate f32", 8, 512, 4),
    ("ffm 19 channels", 8 * 64 * 128, 19, 2),
    ("one row", 1, 3, 2),
]


@pytest.mark.parametrize("per_sm", [None, (2, 3)])
@pytest.mark.parametrize("where,rows,c,elem", PLAN_CASES, ids=[p[0] for p in PLAN_CASES])
def test_launch_plan_covers_every_element(where, rows, c, elem, per_sm):
    """Both grids (the partial sums' and the elementwise pass's) cover every
    row and channel once, in at most 256 threads, with 16-byte vectors
    exactly where the rows keep them aligned, in one wave of the kernel's
    occupancy on 132 SMs, and filling most of it where the tensor has the
    rows."""
    plan = kbn.launch_plan(rows, c, elem, True, 132, per_sm)
    v, tx, ty, tiles = plan["v"], plan["tx"], plan["ty"], plan["tiles"]
    vec = 16 // elem
    assert plan["threads"] == tx * ty <= 256
    assert v == (vec if c % vec == 0 else 1)
    assert 1 <= tx <= 32 and ty == 256 // tx
    assert (tiles - 1) * tx * v < c <= tiles * tx * v
    for chunks, chunk_len, occupancy in ((plan["chunks"], plan["chunk_len"], (per_sm or (4, 4))[0]),
                                         (plan["map_chunks"], plan["map_chunk_len"], (per_sm or (4, 4))[1])):
        assert 1 <= chunks <= 65535 and chunk_len % (ty * 4) == 0
        assert chunks * chunk_len >= rows > (chunks - 1) * chunk_len
        assert chunks == 1 or tiles * chunks <= 132 * occupancy
        if rows >= 132 * occupancy * ty * 64:
            assert tiles * chunks >= 132 * occupancy * 3 // 4


def test_launch_plan_vectors_only_aligned_operands():
    assert kbn.launch_plan(4096, 256, 2, False, 132)["v"] == 1
    assert kbn.launch_plan(4096, 256, 2, True, 132)["v"] == 8
    assert kbn.launch_plan(4096, 256, 4, True, 132)["v"] == 4
    assert kbn.launch_plan(4096, 250, 2, True, 132)["v"] == 1


@pytest.mark.parametrize("args,match", [
    ((64, 8, 8), "bf16 or f32"),
    ((64, 8, 1), "bf16 or f32"),
    ((0, 8, 2), "no empty"),
    ((64, 0, 2), "no empty"),
])
def test_launch_plan_refuses_what_the_kernels_do_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        kbn.launch_plan(*args, True, 132)


def test_takes_and_operand():
    x = torch.zeros(2, 8, 5, 7)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert kbn.takes(cl) and kbn.takes(torch.zeros(8, 16, 1, 1))
    assert not kbn.takes(x) and not kbn.takes(cl.transpose(2, 3)) and not kbn.takes(cl[:, :4])
    assert not kbn.takes(torch.zeros(8, 16))
    before = kbn.copies
    assert kbn.operand(cl) is cl
    assert kbn.copies == before
    for i, other in enumerate((x, cl.transpose(2, 3))):
        got = kbn.operand(other)
        assert got.is_contiguous(memory_format=torch.channels_last) and torch.equal(got, other)
        assert kbn.copies == before + i + 1


def test_row_stride_takes_channel_slices_of_channels_last():
    """The backward reads a gradient in place where its rows lie evenly with
    the channels innermost: dense channels_last, a channel slice of a wider
    channels_last tensor (one part of a torch.cat's gradient), a gate."""
    x = torch.zeros(2, 8, 5, 7)
    wide = torch.zeros(2, 24, 5, 7).contiguous(memory_format=torch.channels_last)
    assert kbn.row_stride(x.contiguous(memory_format=torch.channels_last)) == 8
    assert kbn.row_stride(wide[:, 8:16]) == 24 and kbn.row_stride(wide[:, 16:]) == 24
    assert kbn.row_stride(torch.zeros(8, 16, 1, 1)) == 16
    assert kbn.row_stride(x) is None and kbn.row_stride(wide[:, :, :, 1:]) is None
    assert kbn.row_stride(torch.zeros(2, 8, 1, 1).expand(2, 8, 4, 4)) is None
    assert kbn.row_stride(torch.zeros(8, 16)) is None


@pytest.mark.parametrize("make,match", [
    (lambda: torch.zeros(2, 8, 4, 4, dtype=torch.float16), "bf16 or f32"),
    (lambda: torch.zeros(2, 8, 4, 4, dtype=torch.float64), "bf16 or f32"),
    (lambda: torch.zeros(2, 8, 4, 4).transpose(2, 3), "channels_last memory"),
    (lambda: torch.zeros(8, 4, 4), "channels_last memory"),
    (lambda: torch.zeros(2, 8, 4, 4), "channels_last memory"),
    (lambda: torch.zeros(0, 8, 4, 4), "no empty"),
    (lambda: torch.zeros(2, 8, 4, 4).contiguous(memory_format=torch.channels_last), "CUDA tensors"),
])
def test_forward_refuses_what_the_kernels_do_not_take(make, match):
    vec = torch.zeros(8)
    with pytest.raises(ValueError, match=match):
        kbn.batch_norm_forward(make(), vec, vec, vec, vec, eps=EPS, momentum=MOMENTUM, update=True, relu=True)


def test_forward_refuses_per_channel_vectors_it_does_not_take():
    x = torch.zeros(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    for bad in (torch.zeros(7), torch.zeros(8, dtype=torch.float64), torch.zeros(16)[::2]):
        with pytest.raises(ValueError, match="per-channel vectors"):
            kbn.batch_norm_forward(x, bad, torch.zeros(8), torch.zeros(8), torch.zeros(8), eps=EPS,
                                   momentum=MOMENTUM, update=True, relu=True)


def test_plain_path_counts_nothing():
    before = (kbn.fwd_calls, kbn.bwd_calls, kbn.copies)
    x, weight, bias, stats, dy = _case(torch.bfloat16, "nchw", seed=19)
    _run(_plain, x, weight, bias, stats, dy, True, True)
    assert (kbn.fwd_calls, kbn.bwd_calls, kbn.copies) == before


def _kernel_names():
    return re.findall(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(", SOURCE.read_text())


def test_the_source_has_the_four_kernels():
    assert sorted(_kernel_names()) == ["batchnorm_finish_grad", "batchnorm_finish_stats", "batchnorm_map",
                                       "batchnorm_sums"]


@pytest.mark.parametrize("dtype", ["__nv_bfloat16", "float"])
@pytest.mark.parametrize("grad", ["false", "true"])
def test_kernel_names_fall_in_the_traces_elementwise_group(dtype, grad):
    """Each kernel's name as a trace shows it (demangled, with its template
    arguments and its argument type) files under ``elementwise``, so
    ``elementwise_ms.train`` keeps counting the layer's time."""
    for name in _kernel_names():
        templated = name in ("batchnorm_sums", "batchnorm_map")
        args = f"<{dtype}, 8, {grad}>" if templated else ""
        for shown in (name, f"void (anonymous namespace)::{name}{args}((anonymous namespace)::Args)"):
            assert group(shown) == "elementwise", shown
