"""The port's losses and its Lovász kernels' plain versions against the JAX
package, on numpy-seeded inputs.

Shapes: B = 2 images of 64 x 96 (plus ragged pixel counts for the kernels),
the real 19 classes, about 10% ignore labels. The port's probabilities are
NCHW, (B, C, N) for the kernels; the JAX package's are channel-last, (C, P)
for its kernels with P = B * N in image-major order.

Tolerances, each with its reason:

- K1 (``lovasz_hist_plain``): count and fg rows exact (integers); the
  error-sum row adds the same bf16-rounded errors in f32 in another order:
  rtol 1e-5, atol 1e-5. K1's integer histograms of the pieces of a call,
  added and finalized: the same bits as one call.
- K2 (``lovasz_bwd_plain``): exact. Both pick one bf16-rounded table entry
  per pixel and flip its sign for foreground; nothing is summed.
- binned loss: rtol 1e-6 (the error sums above enter the loss); its
  gradient exact to rtol 1e-6: the tables come from the exact counts by the
  same f32 operations, so they round to the same bf16 values.
- exact-sort Lovász and cross-entropy, f32: rtol 1e-5 on the loss and
  atol 1e-7 on the gradient (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu.ops import losses as jlosses
from rtda_semanticsegmentation_tpu.ops.pallas_lovasz import lovasz_radix_bwd, lovasz_radix_hist
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov
from rtda_semanticsegmentation_tpu_torch.ops import losses as tlosses

B, H, W, C, BINS = 2, 64, 96, 19, 256


def _case(seed, n=H * W, ignore_frac=0.1, scale=3.0):
    """(B, C, N) f32 softmax probabilities and (B, N) int32 labels."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, C, n).astype(np.float32) * scale
    p = np.exp(logits - logits.max(1, keepdims=True))
    p = (p / p.sum(1, keepdims=True)).astype(np.float32)
    labels = rng.randint(0, C, (B, n)).astype(np.int32)
    labels[rng.rand(B, n) < ignore_frac] = 255
    return p, labels


def _jax_rows(p, labels):
    """The JAX kernels' (C, P) / (P,) operands of the same pixels."""
    return jnp.asarray(p.transpose(1, 0, 2).reshape(C, -1)), jnp.asarray(labels.reshape(-1))


def _assert_hist(got, want):
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,ignore_frac,ignore", [
    (H * W, 0.1, 255),
    (1000, 0.1, 255),  # ragged: the Pallas kernel pads to its chunk, the port masks
    (H * W, 1.0, 255),  # all ignored
    (777, 0.1, None),  # no ignore label: every pixel counts, 255 included
])
def test_hist_plain_matches_pallas_and_xla(n, ignore_frac, ignore):
    p, labels = _case(1, n, ignore_frac)
    got = klov.lovasz_hist_plain(torch.from_numpy(p), torch.from_numpy(labels), BINS,
                                 -1 if ignore is None else ignore).numpy()
    pt, lt = _jax_rows(p, labels)
    k_ignore = -1 if ignore is None else ignore
    pallas = np.asarray(lovasz_radix_hist(pt, lt, BINS, k_ignore, interpret=True))
    valid = lt != k_ignore
    xla = np.asarray(jlosses._binned_hists_xla(pt, lt, valid, BINS))
    _assert_hist(got, pallas)
    _assert_hist(got, xla)
    assert got[:, 0].sum() == C * int(np.asarray(valid).sum())
    if ignore_frac == 1.0:
        assert not got.any()


@pytest.mark.parametrize("interp", [True, False])
@pytest.mark.parametrize("n,ignore", [(H * W, 255), (1000, 255), (777, None)])
def test_bwd_plain_matches_pallas_exactly(interp, n, ignore):
    p, labels = _case(2, n)
    rng = np.random.RandomState(3)
    table = (rng.randn(*((C, 2, BINS) if interp else (C, BINS))) * 0.01).astype(np.float32)
    k_ignore = -1 if ignore is None else ignore
    got = klov.lovasz_bwd_plain(torch.from_numpy(p), torch.from_numpy(labels),
                                torch.from_numpy(table), BINS, k_ignore, interp).numpy()
    pt, lt = _jax_rows(p, labels)
    want = np.asarray(lovasz_radix_bwd(pt, lt, jnp.asarray(table), BINS, k_ignore,
                                       interp=interp, interpret=True))
    np.testing.assert_array_equal(got.transpose(1, 0, 2).reshape(C, -1), want)


def test_wrappers_take_the_plain_version_on_the_cpu():
    p, labels = _case(4, 500)
    tp, tl = torch.from_numpy(p), torch.from_numpy(labels)
    table = torch.rand(C, 2, BINS)
    before = (klov.hist_launches, klov.bwd_launches)
    assert torch.equal(klov.lovasz_hist(tp, tl, BINS, 255), klov.lovasz_hist_plain(tp, tl, BINS, 255))
    assert torch.equal(klov.lovasz_bwd(tp, tl, table, BINS, 255, True),
                       klov.lovasz_bwd_plain(tp, tl, table, BINS, 255, True))
    assert (klov.hist_launches, klov.bwd_launches) == before  # plain versions never count
    with pytest.raises(ValueError, match="power of two"):
        klov.lovasz_hist(tp, tl, 100, 255)
    with pytest.raises(ValueError, match="int32"):
        klov.lovasz_hist(tp, tl.long(), BINS, 255)


@pytest.mark.parametrize("bins,hist,bwd", [
    (256, (19, 1, 3), (19, 1, 4)), (1024, (10, 2, 1), (19, 1, 1)), (2048, (7, 3, 1), (10, 2, 1)),
    (4096, (4, 5, 1), (7, 3, 1)), (16384, (1, 19, 1), (1, 19, 1))])
def test_class_group_plans_fit_a_block(bins, hist, bwd):
    """(classes per group, groups, blocks per SM) of K1 and K2 at 19 classes:
    the fewest groups whose (cg, bins) histogram of 12-byte entries and
    (2, cg, bins) f32 table fit a block's 232,448 bytes of shared memory."""
    assert klov.class_groups(C, bins) == hist
    assert klov.bwd_class_groups(C, bins) == bwd
    for (cg, groups, _), rows in ((hist, 3), (bwd, 2)):
        assert rows * cg * bins * 4 <= 232448 and cg * groups >= C
        assert groups == 1 or rows * -(-C // (groups - 1)) * bins * 4 > 232448


def test_class_groups_hold_at_most_32_classes_and_bins_stop_at_16384():
    """More than 32 classes take more groups (a thread keeps one group's
    probabilities in registers); above 16384 bins no class's table fits a
    block, and both plans raise, naming the limit."""
    assert klov.class_groups(40, 256) == (20, 2, 3)
    assert klov.class_groups(25, 256) == (25, 1, 2)  # a group of more than 20 classes: 2 blocks an SM
    assert klov.bwd_class_groups(40, 256) == (20, 2, 4)
    assert klov.bwd_class_groups(C, 2048, interp=False) == (19, 1, 1)
    assert klov.MAX_BINS == 16384
    for plan in (klov.class_groups, klov.bwd_class_groups):
        with pytest.raises(ValueError, match="at most 16384 bins"):
            plan(C, 32768)


def test_hist_plan_cuts_blocks_of_at_most_65535_pixels():
    """K1's launch on a 132-SM card: 4 pixels a thread where N is a multiple
    of 4 and the operands are aligned, else 1; one wave of blocks (3 an SM
    at 256 bins), more where a block would take more than 65535 pixels (its
    counts are 16 bits in shared memory), never more than one thread a
    load."""
    assert klov.hist_plan(8, C, 512 * 1024, 256, 132) == (4, 19, 1, 396)
    assert klov.hist_plan(8, C, 720 * 1280, 256, 132) == (4, 19, 1, 396)
    assert klov.hist_plan(8, C, 512 * 1024, 256, 132, aligned=False)[0] == 1
    assert klov.hist_plan(2, C, 1001, 256, 132) == (1, 19, 1, 8)
    assert klov.hist_plan(1, C, 4, 1024, 132) == (4, 10, 2, 1)
    for b, n, bins, aligned in ((8, 2_000_000, 2048, True), (16, 1_048_575, 256, False),
                                (1, 2**24 - 1, 1024, True), (4, 3_000_001, 256, True)):
        vec, cg, groups, blocks = klov.hist_plan(b, C, n, bins, 132, aligned)
        items = b * n // vec
        threads = 256
        per_block = -(-items // (blocks * threads)) * threads  # the grid stride's largest share
        assert per_block * vec <= 65535 and blocks >= 132 * klov.class_groups(C, bins)[2] // groups


def test_hist_plan_raises_above_its_pixel_limit():
    """K1's u64 error sums at 40 fixed-point bits hold 2**24 - 1 errors of
    at most 1.0: above that many pixels a launch raises, naming the limit."""
    assert klov.FIX_BITS == 40 and klov.MAX_PIXELS == 2**24 - 1
    assert klov.MAX_PIXELS * 2**klov.FIX_BITS < 2**64 <= (klov.MAX_PIXELS + 1) * 2**klov.FIX_BITS
    klov.hist_plan(1, C, 2**24 - 1, 256, 132)
    with pytest.raises(ValueError, match="at most 16777215 pixels"):
        klov.hist_plan(16, C, 2**20 + 4, 256, 132)
    with pytest.raises(ValueError, match="at most 16384 bins"):
        klov.hist_plan(1, C, 64, 32768, 132)


def test_hist_chunks_cut_a_call_above_max_pixels(monkeypatch):
    """Calls above ``MAX_PIXELS``: whole images spread evenly over the
    fewest launches, or one image cut along N into pieces of a multiple of
    4 pixels; every pixel in exactly one launch of at most the limit."""
    assert klov.hist_chunks(8, 720 * 1280) == [(0, 8, 0, 720 * 1280)]
    assert klov.hist_chunks(32, 512 * 1024) == [(0, 16, 0, 512 * 1024), (16, 32, 0, 512 * 1024)]
    assert klov.hist_chunks(19, 720 * 1280) == [(0, 10, 0, 921600), (10, 19, 0, 921600)]
    monkeypatch.setattr(klov, "MAX_PIXELS", 1000)
    for b, n in ((8, 300), (7, 1000), (3, 2500), (1, 4001), (2, 1001)):
        chunks = klov.hist_chunks(b, n)
        covered = np.zeros((b, n), np.int64)
        for b0, b1, n0, n1 in chunks:
            assert (b1 - b0) * (n1 - n0) <= 1000
            assert n0 % 4 == 0 and (n1 == n or (n1 - n0) % 4 == 0)
            covered[b0:b1, n0:n1] += 1
        assert (covered == 1).all(), (b, n)
    assert klov.hist_chunks(8, 300) == [(0, 3, 0, 300), (3, 6, 0, 300), (6, 8, 0, 300)]
    assert klov.hist_chunks(1, 2500) == [(0, 1, 0, 836), (0, 1, 836, 1672), (0, 1, 1672, 2500)]


def _fake_launch(launched):
    """K1's launch on the CPU: its plan (which raises above the per-launch
    limit) and its workspace, the u64 sums of the plain integer histogram
    laid out as the kernel leaves them (``count | fg << 32``, then the error
    sums, wrapping as u64 in int64)."""

    def launch(p, lab, bins, ignore, out):
        b, c, n = klov._check(p, lab, bins)
        klov.hist_plan(b, c, n, bins, 132)
        launched.append((b, n))
        raw = klov.lovasz_hist_raw_plain(p, lab, bins, ignore).reshape(klov.RAW_ROWS, -1)
        err = raw[2] + (raw[3] << 32)
        return torch.cat([raw[0] | raw[1] << 32, err, torch.zeros(1, dtype=torch.int64)])

    return launch


@pytest.mark.parametrize("b,n", [(6, 1000), (1, 6000)])
def test_hist_above_max_pixels_adds_its_launches_exactly(b, n, monkeypatch):
    """A call of more than ``MAX_PIXELS`` pixels (the limit patched small)
    no longer raises: the card's path cuts it into launches (along B, or
    along N for one image), adds their integer sums in int64 limbs and
    finalizes once: the same bits as the plain version of the whole call."""
    rng = np.random.RandomState(b)
    logits = rng.randn(b, C, n).astype(np.float32) * 3.0
    p = np.exp(logits - logits.max(1, keepdims=True))
    p = torch.from_numpy((p / p.sum(1, keepdims=True)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, C, (b, n)).astype(np.int32))
    labels[torch.from_numpy(rng.rand(b, n) < 0.1)] = 255
    want = klov.lovasz_hist_plain(p, labels, BINS, 255)
    monkeypatch.setattr(klov, "MAX_PIXELS", 2500)
    launched = []
    monkeypatch.setattr(klov, "_launch_hist", _fake_launch(launched))
    monkeypatch.setattr(klov, "_device_check", lambda probas, what: False)  # take the card's path
    got = klov.lovasz_hist(p, labels, BINS, 255)
    assert len(launched) == len(klov.hist_chunks(b, n)) > 1 and all(x * y <= 2500 for x, y in launched)
    assert torch.equal(got, want)


def test_raw_histograms_add_to_the_whole():
    """Integer histograms of any cut of the pixels add to the whole's: the
    finalized sum of two halves is the same bits as one call (the sum the
    ranks of a data-parallel step all-reduce)."""
    p, labels = _case(9)
    tp, tl = torch.from_numpy(p), torch.from_numpy(labels)
    whole = klov.lovasz_hist_plain(tp, tl, BINS, 255)
    raw = klov.lovasz_hist_raw(tp[:1].contiguous(), tl[:1].contiguous(), BINS, 255) + klov.lovasz_hist_raw(
        tp[1:].contiguous(), tl[1:].contiguous(), BINS, 255)
    assert torch.equal(klov.finalize_hist(raw), whole)
    cut = tp.shape[2] // 3
    raw = klov.lovasz_hist_raw(tp[:, :, :cut].contiguous(), tl[:, :cut].contiguous(), BINS, 255) + \
        klov.lovasz_hist_raw(tp[:, :, cut:].contiguous(), tl[:, cut:].contiguous(), BINS, 255)
    assert torch.equal(klov.finalize_hist(raw), whole)


def test_finalize_rounds_the_exact_total_once():
    """A total above 2**64 (several launches' sums) and one below, split
    into limbs however: one rounding to f64, then to f32, as the kernel's
    ``float(double(u64) * 2**-40)``."""
    totals = [2**64 + 2**40 + 12345, 3 * 2**40 + 1, 2**70 + 2**17 + 1, 0]
    raw = torch.zeros((klov.RAW_ROWS, 1, len(totals)), dtype=torch.int64)
    for i, t in enumerate(totals):
        raw[2, 0, i] = (t & (2**32 - 1)) + 2**33  # an unnormalized low limb
        raw[3, 0, i] = (t >> 32) - 2
    got = klov.finalize_hist(raw)[0, 2].tolist()
    assert got == [float(np.float32(float(t) * 2.0**-40)) for t in totals]


def _nchw(p, labels):
    """(B, C, H, W) port probabilities, (B, H, W) labels and the JAX
    channel-last copies of the same values."""
    tp = torch.from_numpy(p.reshape(B, C, H, W))
    tl = torch.from_numpy(labels.reshape(B, H, W))
    return tp, tl, jnp.asarray(p.reshape(B, C, H, W).transpose(0, 2, 3, 1)), jnp.asarray(tl.numpy())


@pytest.mark.parametrize("classes", ["present", "all"])
@pytest.mark.parametrize("force_pallas", [False, True])
def test_binned_loss_and_grad_match_jax(classes, force_pallas, monkeypatch):
    p, labels = _case(5)
    labels[:, : H * W // 3][labels[:, : H * W // 3] < 4] = 255  # a few absent classes
    tp, tl, jp, jl = _nchw(p, labels)
    monkeypatch.setattr(jlosses, "FORCE_PALLAS_INTERPRET", force_pallas)
    want, want_g = jax.value_and_grad(
        lambda q: jlosses.lovasz_softmax_binned(q, jl, 255, classes, BINS, interp=True))(jp)
    tp.requires_grad_(True)
    got = tlosses.lovasz_softmax_binned(tp, tl, 255, classes, BINS, interp=True)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(tp.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g), rtol=1e-6, atol=0)


def test_binned_interp_off_matches_jax():
    p, labels = _case(6)
    tp, tl, jp, jl = _nchw(p, labels)
    want, want_g = jax.value_and_grad(
        lambda q: jlosses.lovasz_softmax_binned(q, jl, None, "present", BINS, interp=False))(jp)
    tp.requires_grad_(True)
    got = tlosses.lovasz_softmax_binned(tp, tl, None, "present", BINS, interp=False)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(tp.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g), rtol=1e-6, atol=0)


@pytest.mark.parametrize("classes", ["present", "all"])
def test_exact_lovasz_matches_jax(classes):
    p, labels = _case(7)
    tp, tl, jp, jl = _nchw(p, labels)
    want, want_g = jax.value_and_grad(lambda q: jlosses.lovasz_softmax(q, jl, 255, classes))(jp)
    tp.requires_grad_(True)
    got = tlosses.lovasz_softmax(tp, tl, 255, classes)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(tp.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g), atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "mean_per_image", "none"])
@pytest.mark.parametrize("all_ignored", [False, True])
def test_cross_entropy_matches_jax(reduction, all_ignored):
    rng = np.random.RandomState(8)
    logits = (rng.randn(B, C, H, W) * 2).astype(np.float32)
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.1] = 255
    if all_ignored:
        labels[:] = 255
    jx = jnp.asarray(logits.transpose(0, 2, 3, 1))

    def jloss(x):
        out = jlosses.cross_entropy_with_ignore(x, jnp.asarray(labels), 255, reduction)
        return out.sum(), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(jx)
    tx = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.cross_entropy_with_ignore(tx, torch.from_numpy(labels), 255, reduction)
    got.sum().backward()
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g), atol=1e-7)
    if all_ignored:
        assert not got.detach().numpy().any()


def test_radix_factors_match_jax():
    for bins in (16, 128, 256, 1024):
        assert tlosses._radix_factors(bins) == jlosses._radix_factors(bins)
    with pytest.raises(ValueError):
        tlosses._radix_factors(48)
