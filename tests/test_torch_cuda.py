"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Skips without a CUDA device. Imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This is where the kernels are checked: at small shapes chosen for their
edges and at the main path's shapes, which ``chip_smoke.py`` keeps in its
tables (``SHAPES``, ``CONV3_SHAPES``, ``UPSAMPLE_SITES``, ``BN_SHAPES``,
``LN_SHAPES``) and times the kernels at.

Tolerance: none, except the Lovász histogram's f32 error sums, the
4x4/s2 and 3x3 conv kernels' f32 sums, the resize backward's f32 sums,
the train-mode BatchNorm's statistics and gradients and the LayerNorm's,
which add in another order (stated at the tests); the kernels round like
their plain versions.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from rtda_semanticsegmentation_tpu_torch.kernels import conv3x3 as k4
from rtda_semanticsegmentation_tpu_torch.kernels import conv4x4 as kc
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov
from rtda_semanticsegmentation_tpu_torch.kernels import upsample as kup
from rtda_semanticsegmentation_tpu_torch.ops.losses import lovasz_softmax_binned

# (kernel, stride, pad, C, CO): BiSeNet-R18's quantized conv shapes, narrowed
# (on 15x17 maps, so stride 2 meets odd sizes and a 128-pixel tile straddles
# the two images), the FFM's N = 24 tile with stride 2, and C not a multiple
# of 16 (the padded copy of xq)
SHAPES = [(3, 1, 1, 128, 128), (3, 2, 1, 32, 48), (1, 2, 0, 32, 48), (3, 1, 1, 64, 19),
          (3, 2, 1, 64, 19), (3, 1, 1, 6, 5), (3, 2, 1, 16, 24), (3, 1, 1, 13, 19)]
# The quantized convs of a BiSeNet-R101 and of a DeepLabV2 int8 request at b8
# 512x1024 (chip_smoke.R101_K3_SHAPES): (cin, cout, h, w, kernel, stride,
# padding, dilation, launches a request)
R101_K3_SHAPES = list(dict.fromkeys(row[:-1] for rows in chip_smoke.R101_K3_SHAPES.values() for row in rows))
# (batch, h, w, kernel, stride, pad, C, CO): the narrowed shapes, then every
# undilated quantized conv of the three int8 models at b8 512x1024
K3_CASES = list(dict.fromkeys(
    [(2, 15, 17, k, s, p, C, CO) for k, s, p, C, CO in SHAPES]
    + [(8, h, w, k, s, p, C, CO) for _, C, CO, h, w, k, s, p, _ in chip_smoke.SHAPES]
    + [(8, h, w, k, s, p, C, CO) for C, CO, h, w, k, s, p, d in R101_K3_SHAPES if d == 1]))


def _k3_operands(seed, b, h, w, k, C, CO):
    """s8 codes and weights and the f32 epilogue. At the narrowed (2, 15,
    17) numpy-seeded, ``a`` rand * 1e-4; at the main path's shapes drawn
    on the card, the epilogue scaled so that z = acc * a + b spans a few
    units and the requantized codes fill the grid instead of clipping:
    std(acc) ~ 73.3^2 * sqrt(k * k * C)."""
    if (b, h, w) == (2, 15, 17):
        rng = np.random.RandomState(seed)
        dev = torch.device("cuda")
        xq = torch.from_numpy(rng.randint(-127, 128, (b, h, w, C)).astype(np.int8)).to(dev)
        wq = torch.from_numpy(rng.randint(-127, 128, (k, k, C, CO)).astype(np.int8)).to(dev)
        a = torch.from_numpy(rng.rand(CO).astype(np.float32) * 1e-4).to(dev)
        bias = torch.from_numpy(rng.randn(CO).astype(np.float32)).to(dev)
        inv = torch.from_numpy((rng.rand(CO).astype(np.float32) + 0.5) * 50).to(dev)
        return xq, wq, a, bias, inv
    g = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, (b, h, w, C), generator=g, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, k, C, CO), generator=g, device="cuda", dtype=torch.int8)
    a = torch.rand(CO, generator=g, device="cuda") * 2.0 / (73.3 ** 2 * (k * k * C) ** 0.5)
    bias = torch.randn(CO, generator=g, device="cuda") * 0.5
    inv = (torch.rand(CO, generator=g, device="cuda") + 0.5) * 100.0
    return xq, wq, a, bias, inv


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,k,s,p,C,CO", K3_CASES)
def test_int8_conv_kernel_matches_plain_version(b, h, w, k, s, p, C, CO):
    """Bit-identical; each call from the HWIO weights makes its K-major copy
    (and a padded xq where launch_plan says so), a call given
    ``kmajor_weights`` makes none but that xq."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = k * 1000 + C + CO + (0 if b == 2 else h)
    xq, wq, a, bias, inv = _k3_operands(seed, b, h, w, k, C, CO)
    kmajor = k3.kmajor_weights(wq)
    copy_x = int(k3.launch_plan(C, CO)[1])
    before = (k3.launches, k3.copies)
    for inv_out, relu, dt in ((None, False, torch.bfloat16), (None, True, torch.float32),
                              (inv, True, torch.bfloat16)):
        kw = dict(stride=s, padding=p, relu=relu, out_dtype=dt)
        want = k3.int8_conv_plain(xq, wq, a, bias, inv_out, **kw)
        for prepared in (None, kmajor):
            got = k3.int8_conv(xq, wq, a, bias, inv_out, kmajor=prepared, **kw)
            torch.cuda.synchronize()
            assert got.device == xq.device and got.dtype == want.dtype
            assert torch.equal(got, want), (relu, dt, inv_out is not None, prepared is None)
    assert k3.launches == before[0] + 6
    assert k3.copies == before[1] + 3 * (1 + 2 * copy_x)


# (batch, h, w, stride, dilation, C, CO): DeepLabV2's dilated 3x3 convs
# (padding = dilation), narrowed, at both strides, on the N = 128 and N = 24
# tiles, then the two of a b8 512x1024 request
DILATED = ([(2, 15, 17, s, d, C, CO)
            for s, d, C, CO in ((1, 2, 128, 128), (1, 4, 64, 48), (2, 2, 32, 19), (2, 4, 48, 24), (1, 4, 16, 19))]
           + [(8, h, w, s, d, C, CO) for C, CO, h, w, k, s, p, d in R101_K3_SHAPES if d > 1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,s,d,C,CO", DILATED)
def test_int8_conv_kernel_dilated_matches_plain_version(b, h, w, s, d, C, CO):
    """Bit-identical at dilation 2 and 4 (the taps d apart, the zero-code
    border correction over the dilated taps), bf16 and s8 outputs; a
    dilation whose im2col box corner leaves the 8-bit range is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = 7000 + 10 * d + s + C + (0 if b == 2 else h)
    xq, wq, a, bias, inv = _k3_operands(seed, b, h, w, 3, C, CO)
    kmajor = k3.kmajor_weights(wq)
    for inv_out, relu, dt in ((None, False, torch.bfloat16), (inv, True, torch.bfloat16)):
        kw = dict(stride=s, padding=d, dilation=d, relu=relu, out_dtype=dt)
        want = k3.int8_conv_plain(xq, wq, a, bias, inv_out, **kw)
        got = k3.int8_conv(xq, wq, a, bias, inv_out, kmajor=kmajor, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), (relu, inv_out is not None)
    with pytest.raises(ValueError, match="dilation"):
        k3.int8_conv(xq, wq, a, bias, stride=1, padding=127, dilation=129, relu=False, kmajor=kmajor)


def _lovasz_case(seed, n, ignore_frac, kind="spread", b=2):
    """(b, 19, n) probabilities and labels: ``spread`` a softmax of
    3 * randn logits; ``uniform`` p = 1/C everywhere (every background pixel
    of a class in one bucket); ``one-hot`` a near one-hot softmax on a random
    class (errors in bucket 0 and bucket bins - 1)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, 19, n).astype(np.float32) * 3.0
    if kind == "uniform":
        logits[:] = 0.0
    elif kind == "one-hot":
        np.put_along_axis(logits, rng.randint(0, 19, (b, 1, n)), 30.0, axis=1)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    labels = rng.randint(0, 19, (b, n)).astype(np.int32)
    labels[rng.rand(b, n) < ignore_frac] = 255
    dev = torch.device("cuda")
    return torch.from_numpy(p.astype(np.float32)).to(dev), torch.from_numpy(labels).to(dev)


# (images, pixels per image, ignore share, ignore label, distribution, bins):
# a full tile, a ragged count (one pixel a thread), all ignored, no ignore
# label, the state at initialisation, a confident model, and more than 2^20
# pixels; then the source-only step's (8, 19, 512 * 1024) on the three
# distributions at 256 bins and at 1024 and 2048 bins, where K1 (and, at
# 2048, K2's interpolated table) split the classes into groups
MAIN_PIXELS = chip_smoke.H * chip_smoke.W
LOVASZ_CASES = [(2, 6144, 0.1, 255, "spread", 256), (2, 1001, 0.1, 255, "spread", 256),
                (2, 777, 1.0, 255, "spread", 256), (2, 513, 0.1, -1, "spread", 256),
                (2, 6144, 0.1, 255, "uniform", 256), (2, 6144, 0.1, 255, "one-hot", 256),
                (2, 600000, 0.1, 255, "spread", 256)] + [
    (8, MAIN_PIXELS, 0.1, 255, kind, 256) for kind in chip_smoke.LOVASZ_DISTRIBUTIONS] + [
    (8, MAIN_PIXELS, 0.1, 255, "spread", bins) for bins in (1024, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,ignore_frac,ignore,kind,bins", LOVASZ_CASES)
def test_lovasz_hist_kernel_matches_plain_version(b, n, ignore_frac, ignore, kind, bins):
    """Counts exact; error sums within their fixed-point rounding (rtol
    1e-5, atol 1e-5); the same bits on a second run (integer sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, labels = _lovasz_case(n, n, ignore_frac, kind, b)
    before = klov.hist_launches
    got = klov.lovasz_hist(p, labels, bins, ignore)
    want = klov.lovasz_hist_plain(p, labels, bins, ignore)
    torch.cuda.synchronize()
    assert klov.hist_launches == before + 1
    assert torch.equal(got[:, :2], want[:, :2])
    torch.testing.assert_close(got[:, 2], want[:, 2], rtol=1e-5, atol=1e-5)
    assert torch.equal(klov.lovasz_hist(p, labels, bins, ignore), got)
    if ignore_frac == 1.0:
        assert not bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,launches", [(17, 2**20, 2), (1, 2**24 + 8, 2)])
def test_lovasz_hist_above_max_pixels_is_the_same_bits(b, n, launches):
    """More than 2**24 - 1 pixels: K1 cuts the call into launches (along B;
    along N for one image), adds their integer histograms and finalizes
    once: the same bits as its plain version; and the integer histograms of
    two halves (two ranks' rows) add to the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(b)
    p = torch.softmax(torch.randn((b, 19, n), generator=g, device="cuda") * 3.0, dim=1)
    labels = torch.randint(0, 19, (b, n), generator=g, device="cuda", dtype=torch.int32)
    labels[torch.rand((b, n), generator=g, device="cuda") < 0.1] = 255
    before = klov.hist_launches
    got = klov.lovasz_hist(p, labels, 256, 255)
    assert klov.hist_launches == before + launches
    assert torch.equal(got, klov.lovasz_hist_plain(p, labels, 256, 255))
    half = n // 2
    raw = klov.lovasz_hist_raw(p[:, :, :half].contiguous(), labels[:, :half].contiguous(), 256, 255) + \
        klov.lovasz_hist_raw(p[:, :, half:].contiguous(), labels[:, half:].contiguous(), 256, 255)
    assert torch.equal(klov.finalize_hist(raw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("interp", [True, False])
@pytest.mark.parametrize("b,n,ignore_frac,ignore,kind,bins", LOVASZ_CASES)
def test_lovasz_bwd_kernel_matches_plain_version(interp, b, n, ignore_frac, ignore, kind, bins):
    """Bit-identical, in both table forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, labels = _lovasz_case(n + 1, n, ignore_frac, kind, b)
    g = torch.Generator(device="cuda").manual_seed(n)
    table = torch.randn((19, 2, bins) if interp else (19, bins), generator=g, device="cuda") * 0.01
    before = klov.bwd_launches
    got = klov.lovasz_bwd(p, labels, table, bins, ignore, interp)
    want = klov.lovasz_bwd_plain(p, labels, table, bins, ignore, interp)
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
@pytest.mark.parametrize("b,h,w", [(2, 64, 96), (8, chip_smoke.H, chip_smoke.W)])
def test_binned_lovasz_launches_each_kernel_once_and_matches_the_cpu(b, h, w):
    """One forward and backward of the loss on the card, at 256, 1024 and
    2048 bins (where K2 splits its classes), small and at the source-only
    step's shape: one K1 and one K2 launch; loss and gradient equal the
    CPU's (rtol 1e-6: the error sums add in another order; the tables, from
    exact counts, are the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, labels = _lovasz_case(9, h * w, 0.1, b=b)
    for bins in (256, 1024, 2048):
        _binned_lovasz_card_vs_cpu(p.reshape(b, 19, h, w), labels.reshape(b, h, w), bins)


def _binned_lovasz_card_vs_cpu(p, labels, bins):
    out = {}
    for dev in ("cuda", "cpu"):
        q = p.detach().to(dev).requires_grad_(True)
        before = (klov.hist_launches, klov.bwd_launches)
        loss = lovasz_softmax_binned(q, labels.to(dev), bins=bins)
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
# three images of exactly one strip and 7 row pairs each; then the
# flagship's source and target softmax maps
CONV4_SHAPES = [(2, 19, 64, 96, 64), (1, 7, 12, 20, 16), (1, 19, 36, 300, 64), (1, 19, 20, 400, 64),
                (1, 19, 2, 96, 64), (2, 19, 22, 96, 64), (1, 19, 28, 264, 64), (3, 19, 12, 256, 64)] + [
    (chip_smoke.BATCH, chip_smoke.CLASSES, *hw, chip_smoke.NDF) for hw in (chip_smoke.SOURCE_HW, chip_smoke.TARGET_HW)]


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
# R101 FFM's C = 3328, and the padded-copy routes (f32 x, C = 13 and 6, CO = 5);
# then every 3x3 conv shape of the three serve paths at b8 512x1024
CONV3_SHAPES = [(2, 16, 32, 64, 64, 1, torch.bfloat16), (1, 17, 33, 128, 128, 1, torch.bfloat16),
                (2, 9, 17, 64, 256, 2, torch.bfloat16), (1, 9, 17, 32, 64, 4, torch.bfloat16),
                (2, 8, 16, 104, 19, 1, torch.bfloat16), (1, 7, 5, 24, 5, 1, torch.float32),
                (1, 6, 10, 13, 19, 2, torch.bfloat16), (2, 5, 7, 64, 64, 1, torch.bfloat16),
                (1, 3, 257, 64, 64, 1, torch.bfloat16), (1, 5, 129, 128, 128, 2, torch.bfloat16),
                (1, 4, 8, 3328, 19, 1, torch.bfloat16), (1, 6, 9, 6, 8, 1, torch.bfloat16)] + [
    (chip_smoke.BATCH, h, w, c, co, d, torch.bfloat16) for _, c, co, h, w, d, _ in chip_smoke.CONV3_SHAPES]


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


# The resize's sites on the train paths at batch 8 (chip_smoke.UPSAMPLE_SITES),
# (C, in_hw, out_hw, the layout of the gradient there): the flagship's source
# and target logits (contiguous NCHW from the loss), its ARM features cx1 and
# cx2 (channel slices of the FFM concatenation's channels_last gradient, 1024
# channels: cx1 at 256, cx2 at 512), DeepLabV2's logits.
UPSAMPLE_SITES = [(c, in_hw, out_hw, layout) for _, c, in_hw, out_hw, layout, *_ in chip_smoke.UPSAMPLE_SITES]
UPSAMPLE_IDS = [where.replace(" ", "_") for where, *_ in chip_smoke.UPSAMPLE_SITES]


def _upsample_dy(c, out_hw, layout, dtype, seed, n=8):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "slice":
        lo = 256 if c == 256 else 512
        big = torch.randn((n, 1024, *out_hw), generator=g, device="cuda").to(dtype)
        return big.contiguous(memory_format=torch.channels_last)[:, lo:lo + c]
    dy = torch.randn((n, c, *out_hw), generator=g, device="cuda").to(dtype)
    return dy.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else dy


def _within_bf16_ulp(got, want) -> bool:
    """Within one bf16 ulp of the f64 ``want``, plus 1e-6 of its largest
    value: the f32 sum of an element that cancels to far below its terms
    is off by more than that element's own ulp before it is rounded."""
    _, e = torch.frexp(want)
    return bool(((got.double() - want).abs() <= torch.ldexp(torch.ones_like(want), e - 8)
                 + 1e-6 * want.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,in_hw,out_hw,layout", UPSAMPLE_SITES, ids=UPSAMPLE_IDS)
def test_upsample_bwd_kernel_matches_plain_version(c, in_hw, out_hw, layout, dtype):
    """At each site, in the main path's layout, against the plain version's
    exact sums (the forward's f32 weights, f64 products): bf16 within one
    bf16 ulp (f32 sums, rounded once; ``_within_bf16_ulp``), f32 within
    1e-6 of the largest value (f32 sums in another order), and the largest
    error
    against f64 no larger than PyTorch's own backward's (bf16 atomics for a
    bf16 gradient); channels_last out, as the model's resize asks; the same
    bits on a second call; no copy of the gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dy = _upsample_dy(c, out_hw, layout, dtype, c + in_hw[0])
    copies = kup.copies
    got = kup.upsample_bilinear_bwd(dy, in_hw, torch.channels_last)
    again = kup.upsample_bilinear_bwd(dy, in_hw, torch.channels_last)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again) and kup.copies == copies
    want = kup.upsample_bilinear_bwd_plain(dy, in_hw, exact=True)
    aten = torch.ops.aten.upsample_bilinear2d_backward(dy, list(out_hw), [8, c, *in_hw], False)
    err = (got.double() - want).abs()
    if dtype == torch.bfloat16:
        assert _within_bf16_ulp(got, want)
    else:
        assert err.max().item() <= 1e-6 * want.abs().max().item()
    assert err.max().item() <= (aten.double() - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c,in_hw,out_hw,layout", [UPSAMPLE_SITES[0], UPSAMPLE_SITES[3]],
                         ids=["src_logits", "src_cx2"])
def test_upsample_bwd_kernel_is_the_same_bits_on_a_repeat(c, in_hw, out_hw, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dy = _upsample_dy(c, out_hw, layout, torch.bfloat16, 11)
    first = kup.upsample_bilinear_bwd(dy, in_hw)
    assert torch.equal(first, kup.upsample_bilinear_bwd(dy, in_hw))


@pytest.mark.cuda
@pytest.mark.parametrize("out_format", ["contiguous", "channels_last"])
@pytest.mark.parametrize("c,layout,want", [(19, "nchw", kup.ROWS), (19, "channels_last", kup.MERGED),
                                           (24, "channels_last", kup.TILED), (256, "slice", kup.TILED),
                                           (40, "nchw", kup.ROWS)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upsample_bwd_kernel_takes_both_layouts(c, layout, want, out_format, dtype):
    """Each way the kernel reads a row (ROWS; MERGED at 19 channels; TILED;
    a channel slice; 40 channels in two ROWS tiles) at DeepLabV2's odd
    9x17 -> 65x129, either memory format out, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dy = _upsample_dy(c, (65, 129), layout, dtype, c, n=2)
    assert kup.layout_of(dy) == want
    fmt = {"contiguous": torch.contiguous_format, "channels_last": torch.channels_last}[out_format]
    got = kup.upsample_bilinear_bwd(dy, (9, 17), fmt)
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=fmt)
    ref = kup.upsample_bilinear_bwd_plain(dy, (9, 17), exact=True)
    if dtype == torch.bfloat16:
        assert _within_bf16_ulp(got, ref)
    else:
        assert (got.double() - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.cuda
def test_upsample_bwd_counts_each_launch_and_each_copy():
    """One launch a call, and one a backward of the model's resize, which
    copies only a gradient in a layout the kernel does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.models.layers import resize_bilinear

    dy = _upsample_dy(19, (64, 128), "nchw", torch.bfloat16, 3, n=2)
    before = (kup.bwd_launches, kup.copies)
    for _ in range(3):
        kup.upsample_bilinear_bwd(dy, (8, 16))
    assert (kup.bwd_launches - before[0], kup.copies - before[1]) == (3, 0)
    x = torch.randn((2, 19, 8, 16), device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    resize_bilinear(x, (64, 128)).backward(dy)
    assert (kup.bwd_launches - before[0], kup.copies - before[1]) == (4, 0)
    assert x.grad.is_contiguous(memory_format=torch.channels_last)
    odd = torch.randn((2, 19, 128, 64), device="cuda").to(torch.bfloat16).transpose(2, 3)
    x.grad = None
    resize_bilinear(x, (64, 128)).backward(odd)
    torch.cuda.synchronize()
    assert (kup.bwd_launches - before[0], kup.copies - before[1]) == (5, 1)
    ref = kup.upsample_bilinear_bwd_plain(odd, (8, 16), exact=True)
    assert _within_bf16_ulp(x.grad, ref)
    x.grad = None
    resize_bilinear(x, (64, 128)).sum().backward()  # an expanded gradient: every stride 0
    torch.cuda.synchronize()
    assert (kup.bwd_launches - before[0], kup.copies - before[1]) == (6, 2)
    ones = torch.ones((2, 19, 64, 128), device="cuda", dtype=torch.bfloat16)
    assert _within_bf16_ulp(x.grad, kup.upsample_bilinear_bwd_plain(ones, (8, 16), exact=True))


@pytest.mark.cuda
def test_upsample_bwd_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dy = torch.zeros((2, 19, 64, 128), device="cuda", dtype=torch.bfloat16)
    for bad in (dy.half(), dy.double()):
        with pytest.raises(ValueError, match="bf16 or f32"):
            kup.upsample_bilinear_bwd(bad, (8, 16))
    with pytest.raises(ValueError, match="channel stride 1 or W stride 1"):
        kup.upsample_bilinear_bwd(dy.transpose(2, 3), (16, 8))
    with pytest.raises(ValueError, match="channel stride 1 or W stride 1"):
        kup.upsample_bilinear_bwd(dy.contiguous(memory_format=torch.channels_last)[:, 3:], (8, 16))
    with pytest.raises(ValueError, match="upsample only"):
        kup.upsample_bilinear_bwd(dy, (65, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segformer_encoder_graphs_replay_the_eager_encoder(dtype):
    """A bf16 train-mode forward on the card replays the encoder's CUDA
    graphs (``models/segformer.py``; f32 stays eager and captures none): on
    two inputs in turn (the graph's static input takes each), the same
    tokens and, through a backward, the same parameter gradients as the
    eager encoder; 5 ``attention.calls`` a forward at blocks 1/1/2/1.
    Tolerance: the replay runs the kernels the eager pass runs, but cuBLAS
    may pick another split of a product under capture: f32 to 1e-5, bf16
    to 2e-2, of the largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.config import ModelConfig
    from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model
    from rtda_semanticsegmentation_tpu_torch.obs import spans

    cfg = ModelConfig(name="segformer", compute_dtype=dtype, mit_embed_dims=(32, 64, 160, 256),
                      mit_depths=(1, 1, 2, 1), decoder_dim=64)
    model = build_model(cfg, "cuda", train=True)
    init_model(model, torch.Generator().manual_seed(0))
    params = list(model.backbone.parameters())
    gen = torch.Generator().manual_seed(1)
    tol = 1e-5 if dtype == "float32" else 2e-2

    def close(a, b):
        return (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()

    for i in range(2):
        x = torch.randn((2, 64, 128, 3), generator=gen).to("cuda", getattr(torch, dtype)).permute(0, 3, 1, 2)
        weights = None
        outs = {}
        # the graph first: a capture may not meet a live eager graph of the same
        # parameters (its gradient accumulators would sit on another stream)
        for path in ("graph", "eager"):
            before = spans.counter("attention.calls")
            tokens = [t for t, _ in (model.backbone(x) if path == "eager" else model._encode(x))]
            calls = spans.counter("attention.calls") - before
            if weights is None:
                weights = [torch.randn(t.shape, generator=gen).to("cuda") for t in tokens]
            loss = sum((t.float() * w).sum() for t, w in zip(tokens, weights))
            outs[path] = ([t.detach().clone() for t in tokens], torch.autograd.grad(loss, params), calls)
            del tokens, loss
        torch.cuda.synchronize()
        (te, ge, _), (tg, gg, calls) = outs["eager"], outs["graph"]
        # the first call also captures (three warm-up passes and the capture)
        assert len(model._graphs) == (dtype == "bfloat16") and (i == 0 or calls == 5)
        assert all(close(a, b) for a, b in zip(tg, te))
        assert all(close(a, b) for a, b in zip(gg, ge))
    # two forwards of one shape before a backward (the adversarial step's
    # two domains at one size): the second runs eager, so each backward
    # reads its own forward's activations
    xa, xb = (torch.randn((2, 64, 128, 3), generator=gen).to("cuda", getattr(torch, dtype)).permute(0, 3, 1, 2)
              for _ in range(2))
    before = spans.counter("attention.calls")
    ta, tb = ([t for t, _ in model._encode(v)] for v in (xa, xb))
    assert spans.counter("attention.calls") - before == 10
    for v, tokens in ((xa, ta), (xb, tb)):
        want = [t for t, _ in model.backbone(v)]
        assert all(close(a, b) for a, b in zip(tokens, want))
        got_g = torch.autograd.grad(sum((t.float() * w).sum() for t, w in zip(tokens, weights)), params)
        want_g = torch.autograd.grad(sum((t.float() * w).sum() for t, w in zip(want, weights)), params)
        assert all(close(a, b) for a, b in zip(got_g, want_g))


# Train-mode BatchNorm (kernels/batchnorm.py): shapes in channels_last, the
# main path's layout: 256 channels (16-byte vectors), 19 (one element a
# thread), 2048 (eight channel tiles); the ARM's gate (B, C, 1, 1); then the
# main path's of chip_smoke.BN_SHAPES (DeepLabV2's layer3 at 256 and 1024
# channels, the flagship's stem, SegFormer's linear_fuse).
BN_MAIN = {(chip_smoke.BATCH, c, h, w): where.replace(" ", "_") for where, c, h, w, *_ in chip_smoke.BN_SHAPES}
BN_SHAPES = [(8, 256, 33, 65), (8, 19, 33, 65), (8, 2048, 9, 17), (8, 512, 1, 1)]
BN_IDS = ["cl256", "cl19", "cl2048", "gate"] + [i for shape, i in BN_MAIN.items() if shape not in BN_SHAPES]
BN_SHAPES += [shape for shape in BN_MAIN if shape not in BN_SHAPES]
BN_EPS, BN_MOMENTUM = 1e-5, 0.9


def _bn_case(shape, dtype, seed, rows=None):
    """x off-centre per channel (as a conv's output is), weight, bias,
    running statistics and an output gradient, on the card, channels_last;
    ``rows``: x and dy cut into that many parts of the batch (a rank's
    rows), of other means."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device="cuda") * 1.5
         + torch.randn((1, c, 1, 1), generator=g, device="cuda"))
    if rows:
        x = x + torch.randn((rows, 1, c, 1, 1), generator=g, device="cuda").repeat_interleave(
            shape[0] // rows, 0).flatten(0, 1)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    weight = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    stats = (0.1 * torch.randn(c, generator=g, device="cuda"), 1 + 0.1 * torch.rand(c, generator=g, device="cuda"))
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype).contiguous(memory_format=torch.channels_last)
    return x, weight, bias, stats, dy


def _bn_forward(x, weight, bias, stats, update=True, relu=True, mesh=None):
    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    rm, rv = stats[0].clone(), stats[1].clone()
    y, coef = kbn.batch_norm_forward(x, weight, bias, rm, rv, eps=BN_EPS, momentum=BN_MOMENTUM, update=update,
                                     relu=relu, mesh=mesh)
    return y, coef, rm, rv


def _bn_stats_errors(x, coef, stats, rm, rv):
    """The mean's error against f64 sums as a share of E|x|, invstd's
    relative error, and the running statistics' (mean: of E|x|; var:
    relative) against the f64 update by n / (n - 1)."""
    x64 = x.double()
    mean64 = x64.mean(dim=(0, 2, 3))
    var64 = x64.square().mean(dim=(0, 2, 3)) - mean64.square()
    scale = x64.abs().mean().item()
    invstd64 = torch.rsqrt(var64 + BN_EPS)
    n = x.numel() // x.shape[1]
    want_rm = BN_MOMENTUM * stats[0].double() + (1 - BN_MOMENTUM) * mean64
    want_rv = BN_MOMENTUM * stats[1].double() + (1 - BN_MOMENTUM) * var64 * n / max(n - 1, 1)
    return ((coef[0].double() - mean64).abs().max().item() / scale,
            ((coef[1].double() - invstd64) / invstd64).abs().max().item(),
            (rm.double() - want_rm).abs().max().item() / scale,
            ((rv.double() - want_rv) / want_rv).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES, ids=BN_IDS)
def test_batchnorm_statistics_match_plain_version(shape, dtype):
    """The kernels' mean and invstd against f64 sums, within f32 summation
    order (1e-5 of E|x| for the mean, 2e-5 relative for invstd), no
    further than that from the plain version's, the same bits on a second
    run; mul and add the plain expressions' bits from them; the running
    statistics moved toward the batch's (f64, n / (n - 1)) and held without
    ``update``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    x, weight, bias, stats, _ = _bn_case(shape, dtype, 1)
    y, coef, rm, rv = _bn_forward(x, weight, bias, stats)
    _, coef_again, _, _ = _bn_forward(x, weight, bias, stats)
    plain = kbn.coefficients_plain(x, weight, bias, BN_EPS)
    torch.cuda.synchronize()
    assert torch.equal(coef_again, coef)
    mean_err, invstd_err, rm_err, rv_err = _bn_stats_errors(x, coef, stats, rm, rv)
    assert mean_err <= 1e-5 and invstd_err <= 2e-5 and rm_err <= 2e-6 and rv_err <= 2e-6
    scale = x.double().abs().mean().item()
    assert (plain[0].double() - coef[0].double()).abs().max().item() <= 2e-5 * scale
    assert torch.equal(coef[2], weight * coef[1]) and torch.equal(coef[3], bias - coef[0] * coef[2])
    _, _, rm_held, rv_held = _bn_forward(x, weight, bias, stats, update=False)
    assert torch.equal(rm_held, stats[0]) and torch.equal(rv_held, stats[1])


def _bn_plain_apply(x, coef, relu):
    import torch.nn.functional as F

    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    out = kbn.apply_scale_shift(x, coef[2], coef[3])
    return F.relu(out) if relu else out


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES, ids=BN_IDS)
def test_batchnorm_forward_is_the_plain_apply_bit_for_bit(shape, dtype, relu):
    """Given the same mul and add, the plain version's bits: the forward
    against the plain expressions on its own coefficients; y in x's
    layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, weight, bias, stats, _ = _bn_case(shape, dtype, 2)
    y, coef, _, _ = _bn_forward(x, weight, bias, stats, relu=relu)
    assert y.dtype == dtype and y.stride() == x.stride()
    assert torch.equal(y, _bn_plain_apply(x, coef, relu))


def _bn_f64_grads(dy, x, weight, bias, mask):
    """f64 autograd of the forward's expressions without rounding, the
    ReLU's mask fixed (None: no ReLU)."""
    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    x64 = x.detach().double().requires_grad_(True)
    w64, b64 = weight.detach().double().requires_grad_(True), bias.detach().double().requires_grad_(True)
    mean, var, _ = kbn.statistics(x64)
    z = kbn.apply_scale_shift(x64, *kbn.scale_shift(w64, b64, mean, var, BN_EPS))
    z.backward(dy.double() if mask is None else dy.double() * mask)
    return x64.grad, w64.grad, b64.grad


def _bn_grad_errors(runs, dy, x, weight, bias, relu):
    """For each path of ``runs`` (y, dx, dweight, dbias): the largest error
    of each gradient against f64 autograd (the ReLU's mask of the path's
    own y), and that gradient's largest magnitude."""
    errs = {}
    for path, (y, *grads) in runs.items():
        want = _bn_f64_grads(dy, x, weight, bias, (y > 0) if relu else None)
        errs[path] = [((g.double() - w).abs().max().item(), w.abs().max().item()) for g, w in zip(grads, want)]
    return errs


def _bn_no_worse(errs, path, dtype):
    """``path``'s errors no larger than the plain autograd chain's, plus one
    bf16 ulp of the largest gradient (bf16; 1e-5 of it in f32)."""
    for (err, top), (plain_err, _) in zip(errs[path], errs["plain"]):
        slack = 2.0 ** (math.frexp(top)[1] - 9) if dtype == torch.bfloat16 else 1e-5 * top
        assert err <= plain_err + slack, (path, errs, slack)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES, ids=BN_IDS)
def test_batchnorm_backward_against_f64(shape, dtype, relu):
    """Through the autograd Function: dx, dweight and dbias against f64
    autograd of the forward (the ReLU's mask of each path's own output),
    their largest error no larger than autograd of the plain version's on
    the card, plus one bf16 ulp of the largest gradient (bf16; 1e-5 of it
    in f32, sums in another order); the same bits on a second run; no copy
    of a channels_last input or gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    x, weight, bias, stats, dy = _bn_case(shape, dtype, 3)
    copies = kbn.copies
    runs = {}
    for path, fn in (("kernel", kbn.batch_norm_train), ("kernel_again", kbn.batch_norm_train),
                     ("plain", kbn.batch_norm_train_plain)):
        xg = x.clone().requires_grad_(True)
        wg, bg = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        y = fn(xg, wg, bg, stats[0].clone(), stats[1].clone(), eps=BN_EPS, momentum=BN_MOMENTUM, update=True,
               relu=relu)
        y.backward(dy)
        runs[path] = (y.detach(), xg.grad, wg.grad, bg.grad)
    torch.cuda.synchronize()
    assert kbn.copies == copies
    assert all(torch.equal(a, b) for a, b in zip(runs["kernel"], runs["kernel_again"]))
    assert runs["kernel"][1].dtype == dtype and runs["kernel"][1].stride() == x.stride()
    del runs["kernel_again"]
    _bn_no_worse(_bn_grad_errors(runs, dy, x, weight, bias, relu), "kernel", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batchnorm_data_parallel_is_one_process_on_the_whole_batch(dtype, relu):
    """Two ranks as threads (``tests/thread_mesh.py``), each calling the
    kernels' forward and backward on its half of the batch: the whole
    batch's statistics within f32 summation order of f64 sums, the running
    statistics moved by the global count, each rank's y the plain apply's
    bits from its coefficients, the same coefficients on both ranks; the
    ranks' dx (rows) and dweight and dbias (summed, as the step sums them)
    no further from f64 autograd on the whole batch than the plain
    autograd chain's, plus one bf16 ulp (1e-5 in f32); the same bits on a
    second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from thread_mesh import run_ranks

    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    kbn._library()  # built once, before the ranks' threads
    x, weight, bias, stats, dy = _bn_case((8, 256, 33, 65), dtype, 6, rows=2)
    halves = [(x[:4], dy[:4]), (x[4:], dy[4:])]

    def rank(mesh, xr, dyr):
        y, coef, rm, rv = _bn_forward(xr, weight, bias, stats, relu=relu, mesh=mesh)
        dx, dweight, dbias = kbn.batch_norm_backward(dyr, xr, weight, coef, relu=relu, mesh=mesh)
        torch.cuda.synchronize()
        return y, coef, rm, rv, dx, dweight, dbias

    got = run_ranks(rank, halves)
    again = run_ranks(rank, halves)
    assert all(torch.equal(a, b) for r, s in zip(got, again) for a, b in zip(r, s))
    (y0, coef, rm, rv, *_), (y1, coef1, rm1, rv1, *_) = got
    assert torch.equal(coef, coef1) and torch.equal(rm, rm1) and torch.equal(rv, rv1)
    mean_err, invstd_err, rm_err, rv_err = _bn_stats_errors(x, coef, stats, rm, rv)
    assert mean_err <= 1e-5 and invstd_err <= 2e-5 and rm_err <= 2e-6 and rv_err <= 2e-6
    for (xr, _), (yr, *_) in zip(halves, got):
        assert torch.equal(yr, _bn_plain_apply(xr, coef, relu))
    xg = x.clone().requires_grad_(True)
    wg, bg = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    y = kbn.batch_norm_train_plain(xg, wg, bg, stats[0].clone(), stats[1].clone(), eps=BN_EPS,
                                   momentum=BN_MOMENTUM, update=True, relu=relu)
    y.backward(dy)
    runs = {"ranks": (torch.cat([y0, y1]), torch.cat([got[0][4], got[1][4]]), got[0][5] + got[1][5],
                      got[0][6] + got[1][6]),
            "plain": (y.detach(), xg.grad, wg.grad, bg.grad)}
    _bn_no_worse(_bn_grad_errors(runs, dy, x, weight, bias, relu), "ranks", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lo", [0, 256])
def test_batchnorm_backward_reads_a_channel_slice_in_place(lo):
    """The gradient of one part of a torch.cat (a channel slice of the
    concatenation's channels_last gradient, as the FFM hands the spatial
    path's last ConvBN) is read in place, with no copy, to the bits of a
    dense copy of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    x, weight, bias, stats, _ = _bn_case((8, 256, 33, 65), torch.bfloat16, 4)
    _, coef, _, _ = _bn_forward(x, weight, bias, stats)
    g = torch.Generator(device="cuda").manual_seed(5)
    wide = torch.randn((8, 1024, 33, 65), generator=g, device="cuda").to(torch.bfloat16)
    dy = wide.contiguous(memory_format=torch.channels_last)[:, lo:lo + 256]
    assert not kbn.takes(dy) and kbn.row_stride(dy) == 1024
    before = kbn.copies
    got = kbn.batch_norm_backward(dy, x, weight, coef, relu=True)
    assert kbn.copies == before
    want = kbn.batch_norm_backward(dy.contiguous(memory_format=torch.channels_last), x, weight, coef, relu=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batchnorm_copies_a_contiguous_nchw_input(dtype):
    """A contiguous NCHW input (no layer of the main path gives one) is
    copied into channels_last once, counted, and gives the bits of the
    channels_last input: output, running statistics and gradients; an NCHW
    gradient of a channels_last input is copied once too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn

    x, weight, bias, stats, dy = _bn_case((8, 64, 33, 65), dtype, 7)
    runs = []
    for xin, dyin, copies in ((x, dy, 0), (x.contiguous(), dy, 1), (x, dy.contiguous(), 1)):
        before = kbn.copies
        xg = xin.clone().requires_grad_(True)
        wg, bg = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        rm, rv = stats[0].clone(), stats[1].clone()
        y = kbn.batch_norm_train(xg, wg, bg, rm, rv, eps=BN_EPS, momentum=BN_MOMENTUM, update=True, relu=True)
        y.backward(dyin)
        torch.cuda.synchronize()
        assert kbn.copies - before == copies
        runs.append((y.detach(), rm, rv, xg.grad, wg.grad, bg.grad))
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(run, runs[0]))


@pytest.mark.cuda
def test_batchnorm_counts_each_call_and_each_copy():
    """One forward and one backward call a ConvBN in train mode on the
    card, no copy in the layout the kernels take; an input in another
    layout is copied once, a gradient in another layout than its input's
    once; the running statistics held inside ``running_stats_held``; what
    the kernels refuse raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import batchnorm as kbn
    from rtda_semanticsegmentation_tpu_torch.models.layers import ConvBN, running_stats_held

    block = ConvBN(16, 64, 3, 1, 1, dtype=torch.bfloat16).cuda().train()
    for p in block.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1)
    x = torch.randn((4, 16, 24, 40), device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)

    def counts():
        return kbn.fwd_calls, kbn.bwd_calls, kbn.copies

    before = counts()
    block(x).sum().backward()  # an expanded gradient: every stride 0, copied
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1)
    before = counts()
    y = block(x)
    y.backward(torch.ones_like(y))
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0)
    stats = (block.bn.running_mean.clone(), block.bn.running_var.clone())
    with running_stats_held(block):
        block(x)
    torch.cuda.synchronize()
    assert torch.equal(block.bn.running_mean, stats[0]) and torch.equal(block.bn.running_var, stats[1])
    before = counts()
    xt = torch.randn((4, 64, 40, 24), device="cuda").to(torch.bfloat16).transpose(2, 3)
    kbn.batch_norm_train(xt, block.bn.weight, block.bn.bias, *stats, eps=BN_EPS, momentum=BN_MOMENTUM,
                         update=False, relu=True)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 1)
    with pytest.raises(ValueError, match="bf16 or f32"):
        kbn.batch_norm_train(xt.half(), block.bn.weight, block.bn.bias, *stats, eps=BN_EPS,
                             momentum=BN_MOMENTUM, update=False, relu=True)


# LayerNorm (kernels/layernorm.py): SegFormer-B5's seven (rows, C) of a train
# step (chip_smoke.LN_SHAPES), then edges: a ragged last block (1000 rows, no
# multiple of a block's groups), fewer rows than a block's groups (3) and
# three vectors a thread (96)
LN_CASES = [(rows, c) for _, rows, c, _ in chip_smoke.LN_SHAPES] + [(1000, 320), (3, 64), (77, 96)]
LN_IDS = [where.replace(" ", "_") for where, *_ in chip_smoke.LN_SHAPES] + ["ragged", "few_rows", "c96"]
LN_EPS = 1e-6


def _ln_case(rows, c, dtype, seed):
    """x with rows off-centre each (as a residual stream's are), weight,
    bias and an output gradient, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, c), generator=g, device="cuda") * 1.5
         + torch.randn((rows, 1), generator=g, device="cuda")).to(dtype)
    weight = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    dy = torch.randn((rows, c), generator=g, device="cuda").to(dtype)
    return x, weight, bias, dy


def _ln_run(x, weight, bias, dy):
    from rtda_semanticsegmentation_tpu_torch.kernels import layernorm as kln

    y, mean, rstd = kln.layer_norm_forward(x, weight, bias, LN_EPS)
    return (y, mean, rstd, *kln.layer_norm_backward(dy, x, weight, mean, rstd))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", LN_CASES, ids=LN_IDS)
def test_layernorm_kernels_match_plain_version(rows, c, dtype):
    """Against the plain version and f64: y within one bf16 ulp of
    ``layer_norm_plain``'s (f32: 1e-6 of the largest, its Welford
    statistics against the kernel's two passes); each row's mean within
    1e-5 of E|x| and rstd within 2e-5 relative of f64 (f32 sums in another
    order); dx within one bf16 ulp, plus 1e-6 of the largest, of the
    backward's expressions in f64 on the f64 statistics (f32: 1e-5 of the
    largest: its f32 sums cancel); dweight and dbias within 1e-5 of the f64
    sums of their terms' magnitudes, per channel (f32 sums in blocks, then
    f64); the same bits on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import layernorm as kln

    x, weight, bias, dy = _ln_case(rows, c, dtype, rows + c)
    got = _ln_run(x, weight, bias, dy)
    again = _ln_run(x, weight, bias, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    y, mean, rstd, dx, dweight, dbias = got
    assert y.dtype == dx.dtype == dtype and dweight.dtype == dbias.dtype == torch.float32
    plain = kln.layer_norm_plain(x, weight, bias, LN_EPS)
    mean64, rstd64 = kln.row_stats_plain(x, LN_EPS)
    want = kln.layer_norm_grad_plain(dy, x, weight, mean64, rstd64)
    if dtype == torch.bfloat16:
        assert _within_bf16_ulp(y, plain.double())
        assert _within_bf16_ulp(dx, want[0])
    else:
        assert (y - plain).abs().max().item() <= 1e-6 * plain.abs().max().item()
        assert (dx.double() - want[0]).abs().max().item() <= 1e-5 * want[0].abs().max().item()
    assert (mean.double() - mean64).abs().max().item() <= 1e-5 * x.double().abs().mean().item()
    assert ((rstd.double() - rstd64) / rstd64).abs().max().item() <= 2e-5
    xh = (x.double() - mean64.unsqueeze(-1)) * rstd64.unsqueeze(-1)
    for got_p, want_p, scale in zip((dweight, dbias), want[1:], ((dy.double() * xh).abs().sum(0),
                                                                dy.double().abs().sum(0))):
        assert ((got_p.double() - want_p).abs() <= 1e-5 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_module_runs_the_kernels(dtype):
    """``layers.LayerNorm`` on a card: one forward and one backward call of
    the kernels through the autograd Function, its outputs and gradients
    the bits of the kernels called directly (the f32 parameters' gradients
    in f32), no copy of dense rows; the module runs no ``F.layer_norm``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import layernorm as kln
    from rtda_semanticsegmentation_tpu_torch.models.layers import LayerNorm

    x, weight, bias, dy = _ln_case(2 * 33 * 65, 320, dtype, 11)
    norm = LayerNorm(320, LN_EPS, dtype=dtype).cuda()
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    x3 = x.view(2, 33 * 65, 320).clone().requires_grad_(True)
    before = (kln.fwd_calls, kln.bwd_calls, kln.copies)
    with _FunctionsSeen() as seen:
        y = norm(x3)
    y.backward(dy.view_as(y))
    torch.cuda.synchronize()
    assert (kln.fwd_calls - before[0], kln.bwd_calls - before[1], kln.copies - before[2]) == (1, 1, 0)
    want = _ln_run(x, weight, bias, dy)
    assert torch.equal(y.view_as(want[0]), want[0]) and torch.equal(x3.grad.view_as(want[3]), want[3])
    assert torch.equal(norm.weight.grad, want[4]) and torch.equal(norm.bias.grad, want[5])
    assert seen.names and "layer_norm" not in seen.names, seen.names


class _FunctionsSeen(torch.overrides.TorchFunctionMode):
    """The names of the torch functions called inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_copies_rows_that_are_not_dense(dtype):
    """An input whose rows are not dense (a transposed view), or that starts
    off a 16-byte boundary, is copied once, counted, and gives the bits of
    its dense copy, output and gradients; a gradient whose rows are not
    dense is copied once too; fp16 and f64 on a card raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.kernels import layernorm as kln

    x, weight, bias, dy = _ln_case(4096, 128, dtype, 12)
    xt = x.t().contiguous().t()
    xo = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view_as(x).copy_(x)
    dyt = dy.t().contiguous().t()
    assert not kln.takes(xt) and not kln.takes(xo) and torch.equal(xt, x) and torch.equal(xo, x)
    runs = []
    for xin, dyin, copies in ((x, dy, 0), (xt, dy, 1), (xo, dy, 1), (x, dyt, 1)):
        before = kln.copies
        xg = xin.detach().requires_grad_(True)
        wg, bg = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        y = kln.layer_norm(xg, wg, bg, LN_EPS)
        y.backward(dyin)
        torch.cuda.synchronize()
        assert kln.copies - before == copies
        runs.append((y.detach(), xg.grad, wg.grad, bg.grad))
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(run, runs[0]))
    for bad in (x.half(), x.double()):
        with pytest.raises(ValueError, match="bf16 or f32"):
            kln.layer_norm(bad, weight, bias, LN_EPS)


@pytest.mark.cuda
def test_layernorm_in_a_cuda_graph_is_the_eager_run():
    """``layers.LayerNorm`` captured by ``torch.cuda.make_graphed_callables``
    (as SegFormer's encoder is) gives the eager run's bits, output and
    gradients, on two inputs in turn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtda_semanticsegmentation_tpu_torch.models.layers import LayerNorm

    norm = LayerNorm(320, LN_EPS, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.2)
        norm.bias.normal_(0.0, 0.1)
    shape = (2, 16384 // 2, 320)
    x0, *_ = _ln_case(16384, 320, torch.bfloat16, 13)
    graphed = torch.cuda.make_graphed_callables(norm, (x0.view(shape).clone().requires_grad_(True),))
    for seed in (14, 15):
        x, _, _, dy = _ln_case(16384, 320, torch.bfloat16, seed)
        out = {}
        for path, fn in (("graph", graphed), ("eager", norm)):
            xg = x.view(shape).clone().requires_grad_(True)
            y = fn(xg)
            out[path] = (y.detach().clone(), *torch.autograd.grad(y, (xg, norm.weight, norm.bias), dy.view(shape)))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out["graph"], out["eager"]))


@pytest.mark.cuda
def test_segformer_counts_its_layernorms_on_replay():
    """A replay of the encoder's graphs counts each of its LayerNorms once
    forward and, when the backward reaches it, once backward (22 at
    blocks 1/1/2/1: 10 block norms, 4 key reductions, 4 patch embeddings,
    4 stage norms), as the eager encoder counts them call by call. The
    pass that captures the graphs calls the kernels' autograd Function for
    each of them in each of ``make_graphed_callables``' warm-up iterations
    and in its capture, forward and backward, so the 22 a replay counts
    are the calls the graphs hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import inspect

    from rtda_semanticsegmentation_tpu_torch.config import ModelConfig
    from rtda_semanticsegmentation_tpu_torch.kernels import layernorm as kln
    from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model

    cfg = ModelConfig(name="segformer", compute_dtype="bfloat16", mit_embed_dims=(32, 64, 160, 256),
                      mit_depths=(1, 1, 2, 1), decoder_dim=64)
    model = build_model(cfg, "cuda", train=True)
    init_model(model, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 128, 3)).to("cuda", torch.bfloat16).permute(0, 3, 1, 2)
    warmup = inspect.signature(torch.cuda.make_graphed_callables).parameters["num_warmup_iters"].default
    for path in ("capture", "graph", "eager"):
        before = (kln.fwd_calls, kln.bwd_calls)
        tokens = [t for t, _ in (model.backbone(x) if path == "eager" else model._encode(x))]
        fwd = kln.fwd_calls - before[0]
        sum(t.float().sum() for t in tokens).backward()
        torch.cuda.synchronize()
        # the capture pass: warm-up and capture calls, then the replay's own count
        want = 22 * (warmup + 2) if path == "capture" else 22
        assert (fwd, kln.bwd_calls - before[1]) == (want, want), path
    assert len(model._graphs) == 1
