"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Skips without a CUDA device. Imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: none, except the Lovász histogram's f32 error sums and the
4x4/s2 and 3x3 conv kernels' f32 sums, which add in another order (stated
at the tests); the kernels round like their plain versions.
"""

import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu_torch.kernels import conv3x3 as k4
from rtda_semanticsegmentation_tpu_torch.kernels import conv4x4 as kc
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov
from rtda_semanticsegmentation_tpu_torch.ops.losses import lovasz_softmax_binned

# (kernel, stride, pad, C, CO): BiSeNet-R18's quantized conv shapes, narrowed
# (on 15x17 maps, so stride 2 meets odd sizes and a 128-pixel tile straddles
# the two images), the FFM's N = 24 tile with stride 2, and C not a multiple
# of 16 (the padded copy of xq)
SHAPES = [(3, 1, 1, 128, 128), (3, 2, 1, 32, 48), (1, 2, 0, 32, 48), (3, 1, 1, 64, 19),
          (3, 2, 1, 64, 19), (3, 1, 1, 6, 5), (3, 2, 1, 16, 24), (3, 1, 1, 13, 19)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,p,C,CO", SHAPES)
def test_int8_conv_kernel_matches_plain_version(k, s, p, C, CO):
    """Bit-identical; each call from the HWIO weights makes its K-major copy
    (and a padded xq where launch_plan says so), a call given
    ``kmajor_weights`` makes none but that xq."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(k * 1000 + C + CO)
    dev = torch.device("cuda")
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 15, 17, C)).astype(np.int8)).to(dev)
    wq = torch.from_numpy(rng.randint(-127, 128, (k, k, C, CO)).astype(np.int8)).to(dev)
    a = torch.from_numpy(rng.rand(CO).astype(np.float32) * 1e-4).to(dev)
    b = torch.from_numpy(rng.randn(CO).astype(np.float32)).to(dev)
    inv = torch.from_numpy((rng.rand(CO).astype(np.float32) + 0.5) * 50).to(dev)
    kmajor = k3.kmajor_weights(wq)
    copy_x = int(k3.launch_plan(C, CO)[1])
    before = (k3.launches, k3.copies)
    for inv_out, relu, dt in ((None, False, torch.bfloat16), (None, True, torch.float32),
                              (inv, True, torch.bfloat16)):
        kw = dict(stride=s, padding=p, relu=relu, out_dtype=dt)
        want = k3.int8_conv_plain(xq, wq, a, b, inv_out, **kw)
        for prepared in (None, kmajor):
            got = k3.int8_conv(xq, wq, a, b, inv_out, kmajor=prepared, **kw)
            torch.cuda.synchronize()
            assert got.device == xq.device and got.dtype == want.dtype
            assert torch.equal(got, want), (relu, dt, inv_out is not None, prepared is None)
    assert k3.launches == before[0] + 6
    assert k3.copies == before[1] + 3 * (1 + 2 * copy_x)


# (stride, dilation, C, CO): DeepLabV2's dilated 3x3 convs (padding =
# dilation), narrowed, at both strides, on the N = 128 and N = 24 tiles
DILATED = [(1, 2, 128, 128), (1, 4, 64, 48), (2, 2, 32, 19), (2, 4, 48, 24), (1, 4, 16, 19)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,C,CO", DILATED)
def test_int8_conv_kernel_dilated_matches_plain_version(s, d, C, CO):
    """Bit-identical at dilation 2 and 4 (the taps d apart, the zero-code
    border correction over the dilated taps), bf16 and s8 outputs; a
    dilation whose im2col box corner leaves the 8-bit range is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(7000 + 10 * d + s + C)
    dev = torch.device("cuda")
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 15, 17, C)).astype(np.int8)).to(dev)
    wq = torch.from_numpy(rng.randint(-127, 128, (3, 3, C, CO)).astype(np.int8)).to(dev)
    a = torch.from_numpy(rng.rand(CO).astype(np.float32) * 1e-4).to(dev)
    b = torch.from_numpy(rng.randn(CO).astype(np.float32)).to(dev)
    inv = torch.from_numpy((rng.rand(CO).astype(np.float32) + 0.5) * 50).to(dev)
    kmajor = k3.kmajor_weights(wq)
    for inv_out, relu, dt in ((None, False, torch.bfloat16), (inv, True, torch.bfloat16)):
        kw = dict(stride=s, padding=d, dilation=d, relu=relu, out_dtype=dt)
        want = k3.int8_conv_plain(xq, wq, a, b, inv_out, **kw)
        got = k3.int8_conv(xq, wq, a, b, inv_out, kmajor=kmajor, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), (relu, inv_out is not None)
    with pytest.raises(ValueError, match="dilation"):
        k3.int8_conv(xq, wq, a, b, stride=1, padding=127, dilation=129, relu=False, kmajor=kmajor)


def _lovasz_case(seed, n, ignore_frac, kind="spread"):
    """(2, 19, n) probabilities and labels: ``spread`` a softmax of
    3 * randn logits; ``uniform`` p = 1/C everywhere (every background pixel
    of a class in one bucket); ``one-hot`` a near one-hot softmax on a random
    class (errors in bucket 0 and bucket bins - 1)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 19, n).astype(np.float32) * 3.0
    if kind == "uniform":
        logits[:] = 0.0
    elif kind == "one-hot":
        np.put_along_axis(logits, rng.randint(0, 19, (2, 1, n)), 30.0, axis=1)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    labels = rng.randint(0, 19, (2, n)).astype(np.int32)
    labels[rng.rand(2, n) < ignore_frac] = 255
    dev = torch.device("cuda")
    return torch.from_numpy(p.astype(np.float32)).to(dev), torch.from_numpy(labels).to(dev)


# (pixels per image, ignore share, ignore label, distribution): a full tile,
# a ragged count (one pixel a thread), all ignored, no ignore label, the
# state at initialisation, a confident model, and more than 2^20 pixels
LOVASZ_CASES = [(6144, 0.1, 255, "spread"), (1001, 0.1, 255, "spread"), (777, 1.0, 255, "spread"),
                (513, 0.1, -1, "spread"), (6144, 0.1, 255, "uniform"), (6144, 0.1, 255, "one-hot"),
                (600000, 0.1, 255, "spread")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,ignore_frac,ignore,kind", LOVASZ_CASES)
def test_lovasz_hist_kernel_matches_plain_version(n, ignore_frac, ignore, kind):
    """Counts exact; error sums within their fixed-point rounding (rtol
    1e-5, atol 1e-5); the same bits on a second run (integer sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, labels = _lovasz_case(n, n, ignore_frac, kind)
    before = klov.hist_launches
    got = klov.lovasz_hist(p, labels, 256, ignore)
    want = klov.lovasz_hist_plain(p, labels, 256, ignore)
    torch.cuda.synchronize()
    assert klov.hist_launches == before + 1
    assert torch.equal(got[:, :2], want[:, :2])
    torch.testing.assert_close(got[:, 2], want[:, 2], rtol=1e-5, atol=1e-5)
    assert torch.equal(klov.lovasz_hist(p, labels, 256, ignore), got)
    if ignore_frac == 1.0:
        assert not bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("interp", [True, False])
@pytest.mark.parametrize("n,ignore_frac,ignore,kind", LOVASZ_CASES)
def test_lovasz_bwd_kernel_matches_plain_version(interp, n, ignore_frac, ignore, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, labels = _lovasz_case(n + 1, n, ignore_frac, kind)
    g = torch.Generator(device="cuda").manual_seed(n)
    table = torch.randn((19, 2, 256) if interp else (19, 256), generator=g, device="cuda") * 0.01
    before = klov.bwd_launches
    got = klov.lovasz_bwd(p, labels, table, 256, ignore, interp)
    want = klov.lovasz_bwd_plain(p, labels, table, 256, ignore, interp)
    torch.cuda.synchronize()
    assert klov.bwd_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bins", [1024, 2048])
def test_lovasz_hist_kernel_splits_classes_past_shared_memory(bins):
    """19 classes at 1024 and 2048 bins overflow one block's shared memory,
    so K1 bins groups of classes in separate blocks: still one launch,
    counts exact, error sums within f32 reordering (rtol 1e-5, atol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert klov.class_groups(19, bins)[1] > 1
    p, labels = _lovasz_case(bins, 6144, 0.1)
    before = klov.hist_launches
    got = klov.lovasz_hist(p, labels, bins, 255)
    want = klov.lovasz_hist_plain(p, labels, bins, 255)
    torch.cuda.synchronize()
    assert klov.hist_launches == before + 1
    assert torch.equal(got[:, :2], want[:, :2])
    torch.testing.assert_close(got[:, 2], want[:, 2], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bins,interp", [(2048, True), (4096, True), (4096, False)])
def test_lovasz_bwd_kernel_splits_classes_past_shared_memory(bins, interp):
    """19 classes' (2, bins) tables outgrow one block's shared memory from
    2048 bins on, so K2 writes groups of classes in separate blocks: still
    one launch, bit-identical to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert klov.bwd_class_groups(19, bins, interp)[1] > 1
    p, labels = _lovasz_case(bins + 1, 6144, 0.1)
    g = torch.Generator(device="cuda").manual_seed(bins)
    table = torch.randn((19, 2, bins) if interp else (19, bins), generator=g, device="cuda") * 0.01
    before = klov.bwd_launches
    got = klov.lovasz_bwd(p, labels, table, bins, 255, interp)
    want = klov.lovasz_bwd_plain(p, labels, table, bins, 255, interp)
    torch.cuda.synchronize()
    assert klov.bwd_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lovasz_kernels_take_more_than_32_classes():
    """40 classes at 256 bins: two groups of 20 in both kernels; K1's counts
    exact and error sums within f32 reordering, K2 bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(40)
    logits = rng.randn(2, 40, 3000).astype(np.float32) * 3.0
    q = np.exp(logits - logits.max(1, keepdims=True))
    q /= q.sum(1, keepdims=True)
    labels = rng.randint(0, 40, (2, 3000)).astype(np.int32)
    labels[rng.rand(2, 3000) < 0.1] = 255
    p, lab = torch.from_numpy(q).cuda(), torch.from_numpy(labels).cuda()
    got = klov.lovasz_hist(p, lab, 256, 255)
    want = klov.lovasz_hist_plain(p, lab, 256, 255)
    table = torch.from_numpy(rng.randn(40, 2, 256).astype(np.float32) * 0.01).cuda()
    grad = klov.lovasz_bwd(p, lab, table, 256, 255, True)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :2], want[:, :2])
    torch.testing.assert_close(got[:, 2], want[:, 2], rtol=1e-5, atol=1e-5)
    assert torch.equal(grad, klov.lovasz_bwd_plain(p, lab, table, 256, 255, True))


@pytest.mark.cuda
def test_binned_lovasz_launches_each_kernel_once_and_matches_the_cpu():
    """One forward and backward of the loss on the card, at 256, 1024 and
    2048 bins (where K2 splits its classes): one K1 and one K2 launch; loss
    and gradient equal the CPU's (rtol 1e-6: the error sums add in another
    order; the tables, from exact counts, are the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, labels = _lovasz_case(9, 64 * 96, 0.1)
    for bins in (256, 1024, 2048):
        _binned_lovasz_card_vs_cpu(p, labels, bins)


def _binned_lovasz_card_vs_cpu(p, labels, bins):
    out = {}
    for dev in ("cuda", "cpu"):
        q = p.reshape(2, 19, 64, 96).to(dev).requires_grad_(True)
        before = (klov.hist_launches, klov.bwd_launches)
        loss = lovasz_softmax_binned(q, labels.reshape(2, 64, 96).to(dev), bins=bins)
        loss.backward()
        torch.cuda.synchronize()
        launched = (klov.hist_launches - before[0], klov.bwd_launches - before[1])
        out[dev] = (loss.detach().cpu(), q.grad.cpu(), launched)
    assert out["cuda"][2] == (1, 1) and out["cpu"][2] == (0, 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-6, atol=0)


# (B, C, H, W, CO): the discriminator's conv1 at a small size, an odd
# channel count, a width with ragged tiles (bf16 rows of 300 and 20: the
# copy route; K5c's 150 dy columns straddle two 128-column strips), a width
# straddling two K5a tiles (and four K5b tiles), one output row (B = 1,
# H = 2), an odd number of output rows; for K5c an odd number of row pairs
# (the last tile's band half used) with a ragged strip of 4 dy columns, and
# three images of exactly one strip and 7 row pairs each
CONV4_SHAPES = [(2, 19, 64, 96, 64), (1, 7, 12, 20, 16), (1, 19, 36, 300, 64), (1, 19, 20, 400, 64),
                (1, 19, 2, 96, 64), (2, 19, 22, 96, 64), (1, 19, 28, 264, 64), (3, 19, 12, 256, 64)]


def _assert_conv4_close(got, want, bf16: bool):
    """f32 output: max |diff| <= 1e-5 * max |want| (the same f32 products,
    summed in another order); bf16 output: within one bf16 ulp of the plain
    version plus that (two f32 sums a few ulps apart can round to
    neighbouring bf16 values, and an output that cancels to far below its
    terms moves by more than its own ulp before it is rounded)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    f32_tol = 1e-5 * want.abs().max().item()
    if bf16:
        _, e = torch.frexp(want)
        assert bool(((got - want).abs() <= torch.ldexp(torch.ones_like(want), e - 8) + f32_tol).all())
    else:
        assert (got - want).abs().max().item() <= f32_tol


def _conv4_case(b, c, h, w, co, dtype):
    g = torch.Generator(device="cuda").manual_seed(b * 1000 + c * 10 + co)
    x = torch.softmax(torch.randn((b, c, h, w), generator=g, device="cuda") * 3.0, dim=1).to(dtype)
    wt = torch.randn((co, c, 4, 4), generator=g, device="cuda") * 0.02
    dy = (torch.randn((b, co, h // 2, w // 2), generator=g, device="cuda") * 1e-3).to(dtype)
    return x, wt, dy


@pytest.fixture
def no_tf32():
    """The plain versions' f32 convs on cuDNN in full f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,h,w,co", CONV4_SHAPES)
def test_conv4x4_kernels_match_plain_versions(b, c, h, w, co, dtype, no_tf32):
    """K5a and K5c at the module's tolerance; K5b (f32) within
    1e-5 * max |want|: its sums over every pixel run in another order. The
    wrappers copy exactly the operands ``launch_plan`` names; K5b and K5c
    give the same bits twice."""
    x, wt, dy = _conv4_case(b, c, h, w, co, dtype)
    bf16 = dtype == torch.bfloat16
    before = (kc.fwd_launches, kc.dw_launches, kc.dx_launches)
    copies = kc.copies + sum(sum(kc.launch_plan("fwd", x.shape, dtype, out)[1:])
                             for out in (torch.bfloat16, torch.float32))
    copies += sum(kc.launch_plan("dw", x.shape, dtype, dtype)[1:])
    copies += sum(kc.launch_plan("dx", x.shape, dtype, dtype)[1:])  # an f32 dy, a row off 16 bytes
    for out_dtype in (torch.bfloat16, torch.float32):
        _assert_conv4_close(kc.conv4x4s2p1(x, wt, out_dtype), kc.conv4x4s2p1_plain(x, wt, out_dtype),
                            out_dtype == torch.bfloat16)
    dw = kc.conv4x4s2p1_dw(x, dy)
    want_dw = kc.conv4x4s2p1_dw_plain(x, dy)
    assert dw.dtype == torch.float32 and dw.shape == (co, c, 4, 4)
    assert (dw - want_dw).abs().max().item() <= 1e-5 * want_dw.abs().max().item()
    _assert_conv4_close(kc.conv4x4s2p1_dx(dy, wt, dtype), kc.conv4x4s2p1_dx_plain(dy, wt, dtype), bf16)
    torch.cuda.synchronize()
    assert (kc.fwd_launches, kc.dw_launches, kc.dx_launches) == (before[0] + 2, before[1] + 1, before[2] + 1)
    assert kc.copies == copies  # exactly what launch_plan names
    # the weight gradient is summed in a fixed order: the same bits twice
    assert torch.equal(kc.conv4x4s2p1_dw(x, dy), dw)
    assert torch.equal(kc.conv4x4s2p1_dx(dy, wt, dtype), kc.conv4x4s2p1_dx(dy, wt, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("x_grad,w_grad", [(True, True), (False, True), (True, False)])
def test_fused_conv4x4_launches_only_the_needed_kernels(x_grad, w_grad, no_tf32):
    """One forward and backward of the autograd Function: one K5a launch,
    K5b only for a weight gradient and K5c only for an input gradient."""
    x, wt, _ = _conv4_case(2, 19, 64, 96, 64, torch.bfloat16)
    x.requires_grad_(x_grad)
    wt.requires_grad_(w_grad)
    before = (kc.fwd_launches, kc.dw_launches, kc.dx_launches)
    kc.fused_conv4x4s2p1(x, wt, torch.bfloat16).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (kc.fwd_launches, kc.dw_launches, kc.dx_launches) == (
        before[0] + 1, before[1] + int(w_grad), before[2] + int(x_grad))
    assert (x.grad is not None) == x_grad and (wt.grad is not None) == w_grad


# (B, H, W, C, CO, dilation, x dtype): the serve paths' cases, narrowed (C and
# CO multiples of 8: no operand copy), DeepLab's odd sizes and dilations, the
# FFM's ragged CO = 19 on the N = 24 tile, more than one N tile, a 128-pixel
# tile straddling two images (B = 2, 5x7), DeepLab's widths 257 and 129, the
# R101 FFM's C = 3328, and the padded-copy routes (f32 x, C = 13 and 6, CO = 5)
CONV3_SHAPES = [(2, 16, 32, 64, 64, 1, torch.bfloat16), (1, 17, 33, 128, 128, 1, torch.bfloat16),
                (2, 9, 17, 64, 256, 2, torch.bfloat16), (1, 9, 17, 32, 64, 4, torch.bfloat16),
                (2, 8, 16, 104, 19, 1, torch.bfloat16), (1, 7, 5, 24, 5, 1, torch.float32),
                (1, 6, 10, 13, 19, 2, torch.bfloat16), (2, 5, 7, 64, 64, 1, torch.bfloat16),
                (1, 3, 257, 64, 64, 1, torch.bfloat16), (1, 5, 129, 128, 128, 2, torch.bfloat16),
                (1, 4, 8, 3328, 19, 1, torch.bfloat16), (1, 6, 9, 6, 8, 1, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,d,x_dtype", CONV3_SHAPES)
def test_conv3x3_kernel_matches_plain_version(b, h, w, c, co, d, x_dtype, no_tf32):
    """K4 with and without its epilogue, bf16 and f32 out, with the port's
    bf16 weights padded to a multiple of 8 in CO and with plain f32 HWIO
    weights: the 4x4/s2 kernels' tolerance (``_assert_conv4_close``). The
    wrapper copies exactly the operands ``launch_plan`` names."""
    g = torch.Generator(device="cuda").manual_seed(b * 100 + c + co + d)
    x = torch.randn((b, h, w, c), generator=g, device="cuda").to(x_dtype)
    wt = torch.randn((3, 3, c, co), generator=g, device="cuda") * (2.0 / (9 * c)) ** 0.5
    scale = torch.rand(co, generator=g, device="cuda") + 0.5
    shift = torch.randn(co, generator=g, device="cuda") * 0.1
    padded = torch.nn.functional.pad(wt, (0, -co % 8)).to(torch.bfloat16)[..., :co]
    before = (k4.launches, k4.copies)
    calls = copies = 0
    for weights in (padded, wt):
        for epilogue in ((), (scale, shift)):
            for relu in (False, True):
                for out_dtype in (torch.bfloat16, torch.float32):
                    kw = dict(relu=relu, dilation=d, out_dtype=out_dtype)
                    got = k4.conv3x3(x, weights, *epilogue, **kw)
                    want = k4.conv3x3_plain(x, weights, *epilogue, **kw)
                    calls += 1
                    copies += sum(k4.launch_plan(c, co, weights.stride(2), x.dtype, weights.dtype)[1:])
                    assert got.is_contiguous()
                    _assert_conv4_close(got, want.contiguous(), out_dtype == torch.bfloat16)
    torch.cuda.synchronize()
    assert (k4.launches, k4.copies) == (before[0] + calls, before[1] + copies)


@pytest.mark.cuda
def test_conv3x3_kernel_refuses_a_non_contiguous_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros((1, 8, 4, 6), device="cuda", dtype=torch.bfloat16)  # NCHW, not channels_last
    w = torch.zeros((3, 3, 8, 8), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        k4.conv3x3(x.permute(0, 2, 3, 1), w)


@pytest.mark.cuda
def test_artifact_exported_on_the_cpu_runs_k3_on_the_card(tmp_path):
    """An int8 R18 artifact traced on the CPU, loaded onto the card: one K3
    launch per QuantConv (15) with no operand copy, and masks equal to the
    eager int8 path's on the card. The graph holds the op, not the CPU's
    plain conv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.config import AugmentConfig, ModelConfig
    from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model
    from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate, freeze
    from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
    from rtda_semanticsegmentation_tpu_torch.serving import (
        export_serving,
        load_artifact,
        make_serving_fn,
        save_artifact,
    )

    cfg, aug = ModelConfig(compute_dtype="bfloat16"), AugmentConfig()
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    frames = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 64, 128, 3), np.uint8))
    # frozen once, on the CPU: the card's f32 sums would round the constants
    # in another order
    frozen = freeze(cfg, calibrate(cfg, variables, [normalize_u8(frames, aug)], device="cpu"))
    exported, meta = export_serving(cfg, aug, frozen, 64, 128, precision="int8", device="cpu")
    save_artifact(str(tmp_path), exported, meta)
    fn, meta = load_artifact(str(tmp_path), device="cuda")
    assert meta["platforms"] == ["cpu"]
    eager = make_serving_fn(cfg, aug, {k: v.cuda() for k, v in frozen.items()}, "int8", device="cuda")
    want = eager(frames.cuda())
    before = (k3.launches, k3.copies)
    got = fn(frames.numpy())
    torch.cuda.synchronize()
    assert (k3.launches - before[0], k3.copies - before[1]) == (15, 0)
    assert got.device.type == "cuda" and torch.equal(got, want)
