"""The port's serving upsample against the JAX package's fused
``ops/upsample.py::upsample_bilinear_argmax``, and the resize's backward
(``kernels/upsample.py``: the plain version the CPU runs, the autograd
Function, the launch plan and the layouts the kernel takes) against
autograd of ``F.interpolate`` and JAX's VJP of ``jax.image.resize``.

The JAX package's phase-form upsample + argmax is a TPU rearrangement of
``argmax(resize_bilinear(logits))``; the port serves that plain form
(``models/layers.py::resize_bilinear``, ``F.interpolate`` with half-pixel
centres, then ``torch.argmax`` in ``serving.py``). These tests hold the
plain form against the JAX op on ``tests/test_upsample.py``'s factors and
shapes, so the port computes what the JAX op computes.

Tolerances, each with its reason:

- the interpolated field against JAX's ``_interp_axis`` field, and at a
  non-integer factor against ``jax.image.resize``: atol and rtol 1e-5, the
  JAX test's (f32, the same two-tap sums written another way);
- the predictions: equal to JAX's at every pixel (f32 inputs whose top two
  interpolated values are apart; the draws are seeded), and from bf16
  logits (the port interpolates them in bf16, the JAX op in f32) at more
  than 0.99 of the pixels, the JAX test's bar for near-ties;
- the resize's backward in f64 against autograd and JAX's VJP: 1e-12 of
  the largest gradient (the same two-tap weights, sums in another order);
  through the Function in f32: 1e-5 relative (f32 sums in another order);
  in bf16: within one bf16 ulp of the f64 gradient (f32 sums, one rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtda_semanticsegmentation_tpu.ops.upsample import _interp_axis as jinterp_axis
from rtda_semanticsegmentation_tpu.ops.upsample import upsample_bilinear_argmax as jupsample
from rtda_semanticsegmentation_tpu_torch.kernels import upsample as kup
from rtda_semanticsegmentation_tpu_torch.models.layers import resize_bilinear

FACTORS = [(8, 8), (2, 2), (4, 2), (1, 8)]


def _serve_argmax(x: torch.Tensor, out_hw) -> torch.Tensor:
    """The port's serving head on NCHW logits: the resize, then the argmax."""
    return torch.argmax(resize_bilinear(x, out_hw), dim=1)


@pytest.mark.parametrize("fh,fw", FACTORS)
def test_field_matches_jax_and_interpolate(fh, fw):
    x = np.random.RandomState(0).randn(2, 5, 7, 4).astype(np.float32)
    b, h, w, c = x.shape
    want = jinterp_axis(jinterp_axis(jnp.asarray(x), 1, fh), 3, fw).reshape(b, h * fh, w * fw, c)
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (h * fh, w * fw))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw", [((2, 6, 10, 19), (48, 80)), ((1, 8, 16, 19), (64, 128)),
                                          ((2, 5, 7, 4), (10, 56)), ((1, 4, 4, 3), (4, 4))])
def test_predictions_match_jax_and_the_plain_version(shape, out_hw):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = np.asarray(jupsample(jnp.asarray(x), out_hw))
    got = _serve_argmax(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    assert tuple(got.shape) == (shape[0], *out_hw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_logits_high_agreement_with_jax():
    x = np.random.RandomState(3).randn(2, 8, 8, 19).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jupsample(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), (64, 64)))
    got = _serve_argmax(xb.permute(0, 3, 1, 2), (64, 64)).numpy()
    assert (got == want).mean() > 0.99


def test_first_class_wins_a_tie():
    x = torch.zeros(1, 5, 3, 3)
    x[:, 2] = x[:, 4] = 1.0
    assert (_serve_argmax(x, (24, 24)) == 2).all()


def test_non_integer_factor_matches_jax_resize():
    """Where the JAX op raises (a factor that is not an integer: DeepLabV2's
    9 x 17 logits to 65 x 129), the port's resize is ``jax.image.resize``'s."""
    x = np.random.RandomState(4).randn(1, 9, 17, 5).astype(np.float32)
    with pytest.raises(ValueError, match="integer factors"):
        jupsample(jnp.asarray(x), (65, 129))
    want = jax.image.resize(jnp.asarray(x), (1, 65, 129, 5), method="bilinear")
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (65, 129))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# The resize's sites on the train paths, (C, in_hw, out_hw): the flagship's
# source and target logits and ARM features (cx1, cx2; 23 -> 90 is a ratio
# of 3.91), DeepLabV2's logits (ratios 7.88 and 7.94); then DeepLabV2's
# small-input shape and an identity size.
SITES = [
    (19, (90, 160), (720, 1280)), (19, (64, 128), (512, 1024)),
    (256, (45, 80), (90, 160)), (512, (23, 40), (90, 160)),
    (256, (32, 64), (64, 128)), (512, (16, 32), (64, 128)),
    (19, (65, 129), (512, 1024)),
    (19, (9, 17), (65, 129)), (7, (11, 13), (11, 13)),
]
SITE_IDS = ["src_logits", "tgt_logits", "src_cx1", "src_cx2", "tgt_cx1", "tgt_cx2", "dlv2_logits",
            "dlv2_small", "identity"]
LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}


def _dy(c, out_hw, seed, dtype=torch.float64, n=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, c, *out_hw)).to(dtype)


@functools.lru_cache(maxsize=None)
def _jax_vjp(site: int) -> np.ndarray:
    """JAX's VJP of ``jax.image.resize(..., "bilinear")`` at a site, f64,
    NCHW."""
    c, (hi, wi), (ho, wo) = SITES[site]
    dy = _dy(c, (ho, wo), site).permute(0, 2, 3, 1).numpy()
    jax.config.update("jax_enable_x64", True)
    try:
        x = jnp.zeros((1, hi, wi, c), jnp.float64)
        _, vjp = jax.vjp(lambda v: jax.image.resize(v, (1, ho, wo, c), method="bilinear"), x)
        return np.asarray(vjp(jnp.asarray(dy))[0]).transpose(0, 3, 1, 2)
    finally:
        jax.config.update("jax_enable_x64", False)


def _autograd(dy, in_hw, memory_format=torch.contiguous_format):
    x = torch.zeros((dy.shape[0], dy.shape[1], *in_hw), dtype=dy.dtype).contiguous(memory_format=memory_format)
    x.requires_grad_(True)
    F.interpolate(x, size=tuple(dy.shape[2:]), mode="bilinear", align_corners=False).backward(dy)
    return x.grad


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("site", range(len(SITES)), ids=SITE_IDS)
def test_plain_backward_matches_autograd_and_jax_vjp(site, layout):
    c, in_hw, out_hw = SITES[site]
    dy = _dy(c, out_hw, site).contiguous(memory_format=LAYOUTS[layout])
    got = kup.upsample_bilinear_bwd_plain(dy, in_hw)
    assert got.dtype == torch.float64 and tuple(got.shape) == (1, c, *in_hw)
    assert got.is_contiguous(memory_format=kup.memory_format_of(dy))
    scale = float(got.abs().max())
    np.testing.assert_allclose(got.numpy(), _autograd(dy, in_hw).numpy(), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(got.numpy(), _jax_vjp(site), rtol=0, atol=1e-12 * scale)


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``t`` (8 significant bits)."""
    mag = t.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_resize_gradient_through_the_function_matches_interpolate(dtype, layout):
    """``resize_bilinear``'s gradient (the Function, its plain backward on
    the CPU) against autograd of ``F.interpolate``, in the input's memory
    format; its forward is ``F.interpolate``'s, bit for bit."""
    fmt = LAYOUTS[layout]
    x64 = torch.from_numpy(np.random.RandomState(5).randn(2, 19, 9, 17)).contiguous(memory_format=fmt)
    dy64 = _dy(19, (65, 129), 6, n=2)
    x = x64.to(dtype).requires_grad_(True)
    y = resize_bilinear(x, (65, 129))
    assert type(y.grad_fn).__name__ == "_ResizeBilinearBackward"
    assert torch.equal(y.detach(), F.interpolate(x.detach(), size=(65, 129), mode="bilinear", align_corners=False))
    y.backward(dy64.to(dtype))
    assert x.grad.dtype == dtype and x.grad.is_contiguous(memory_format=fmt)
    want = _autograd(dy64, (9, 17))
    if dtype == torch.float64:
        np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=0, atol=1e-12 * float(want.abs().max()))
    elif dtype == torch.float32:
        np.testing.assert_allclose(x.grad.numpy(), _autograd(dy64.float(), (9, 17)).numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        want = _autograd(dy64.to(dtype).double(), (9, 17))
        assert ((x.grad.double() - want).abs() <= _bf16_ulp(want)).all()


def test_gradients_of_a_concatenation_reach_each_resize():
    """The ARM features' path: two resizes concatenated along the channels
    in channels_last memory, so each backward gets a channel slice of the
    concatenation's gradient (the layout the kernel reads in place)."""
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(2, 16, 3, 5)).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    b = torch.from_numpy(rng.randn(2, 24, 2, 3)).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    w = torch.from_numpy(rng.randn(2, 40, 6, 10)).contiguous(memory_format=torch.channels_last)
    seen = []
    for t in (a, b):
        t.register_hook(lambda g: seen.append(g))
    y = torch.cat([resize_bilinear(a, (6, 10)), resize_bilinear(b, (6, 10))], dim=1)
    (y * w).sum().backward()
    for t, lo, hi in ((a, 0, 16), (b, 16, 40)):
        want = _autograd(w[:, lo:hi].contiguous(), tuple(t.shape[2:]))
        np.testing.assert_allclose(t.grad.numpy(), want.numpy(), rtol=0, atol=1e-12 * float(want.abs().max()))
        assert t.grad.is_contiguous(memory_format=torch.channels_last)
    assert len(seen) == 2


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_requires_grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_without_grad_the_resize_is_interpolate_and_launches_nothing(mode, dtype):
    """Serving, eval and export: no Function in the graph, the same bits
    as ``F.interpolate``, and the kernel's counter does not move."""
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 19, 8, 16)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    want = F.interpolate(x, size=(64, 128), mode="bilinear", align_corners=False)
    before = (kup.bwd_launches, kup.copies)
    if mode == "no_grad":
        with torch.no_grad():
            y = resize_bilinear(x.requires_grad_(True), (64, 128))
    elif mode == "inference_mode":
        with torch.inference_mode():
            y = resize_bilinear(x, (64, 128))
    else:
        y = resize_bilinear(x, (64, 128))
    assert y.grad_fn is None
    assert torch.equal(y, want) and y.stride() == want.stride()
    assert (kup.bwd_launches, kup.copies) == before


def _touching(n_in: int, n_out: int) -> list:
    """Per input index, the output indices that read it, from the
    interpolation's lower indices (i0 or i0 + 1 is that index)."""
    i0 = kup.source_index(n_in, n_out)[0].numpy()
    i1 = np.minimum(i0 + 1, n_in - 1)
    return [np.flatnonzero((i0 == j) | (i1 == j)) for j in range(n_in)]


PLANS = [(site, layout) for site in range(len(SITES)) for layout in (kup.TILED, kup.MERGED, kup.ROWS)
         if layout != kup.TILED or SITES[site][0] % 8 == 0]  # TILED takes channels in runs of 16 bytes


@pytest.mark.parametrize("site,layout", PLANS,
                         ids=[f"{SITE_IDS[s]}-{('tiled', 'merged', 'rows')[lay]}" for s, lay in PLANS])
def test_launch_plan_covers_each_site(site, layout):
    """A flagship batch at each site: the tiles cover the channels and
    columns, the bands the rows, about one wave of blocks on 132 SMs, at
    most 8 elements a thread of at most 256, the shared memory within a
    block's, and ``taps`` and ``span`` equal to a direct count of the
    outputs that read each input column."""
    c, in_hw, out_hw = SITES[site]
    p = kup.launch_plan(8, c, in_hw, out_hw, layout, 2, 132)
    (hi, wi), (ho, wo) = in_hw, out_hw
    assert p["threads"] <= 256 and p["threads"] % 32 == 0 and p["e"] in (1, 2, 4, 8)
    assert p["e"] * p["threads"] >= p["tw"] * p["tc"]
    assert p["smem"] <= 232448 and p["stage_elems"] % 8 == 0
    assert {kup.TILED: c % p["tc"] == 0 and p["tc"] % 8 == 0, kup.MERGED: p["tc"] == c,
            kup.ROWS: p["tc"] <= 32}[layout]
    tiles = -(-wi // p["tw"]) * -(-c // p["tc"])
    bands = -(-hi // p["bh"])
    assert (bands - 1) * p["bh"] < hi <= bands * p["bh"] and 1 <= bands <= hi
    assert 8 * tiles * bands <= 2 * 132 * 8 or bands == 1
    touch = _touching(wi, wo)
    assert p["taps"] == max(len(t) for t in touch)
    assert p["span"] == max(touch[min(j + p["tw"], wi) - 1][-1] + 1 - touch[j][0] for j in range(0, wi, p["tw"]))
    if layout == kup.ROWS:
        assert p["pitch"] % 16 == 8 and p["pitch"] >= p["span"] + 7


@pytest.mark.parametrize("case,want", [
    ("nchw", kup.ROWS), ("channels_last_c19", kup.MERGED), ("channels_last_c256", kup.TILED),
    ("cat_slice", kup.TILED), ("f32_channels_last_c19", kup.MERGED), ("f32_channels_last_c12", kup.TILED),
    ("odd_slice", None), ("transposed", None), ("expanded", None), ("f16", None), ("f64", None),
])
def test_layout_of_reads_the_strides(case, want):
    def cl(c, dtype=torch.bfloat16):
        return torch.zeros(2, c, 6, 10, dtype=dtype).contiguous(memory_format=torch.channels_last)

    dy = {
        "nchw": lambda: torch.zeros(2, 19, 6, 10, dtype=torch.bfloat16),
        "channels_last_c19": lambda: cl(19),
        "channels_last_c256": lambda: cl(256),
        "cat_slice": lambda: cl(1024)[:, 256:512],
        "f32_channels_last_c19": lambda: cl(19, torch.float32),
        "f32_channels_last_c12": lambda: cl(12, torch.float32),
        "odd_slice": lambda: cl(64)[:, 3:35],
        "transposed": lambda: torch.zeros(2, 19, 10, 6, dtype=torch.bfloat16).transpose(2, 3),
        "expanded": lambda: torch.ones((), dtype=torch.bfloat16).expand(2, 19, 6, 10),  # the gradient of a sum
        "f16": lambda: torch.zeros(2, 19, 6, 10, dtype=torch.float16),
        "f64": lambda: torch.zeros(2, 19, 6, 10, dtype=torch.float64),
    }[case]()
    assert kup.layout_of(dy) == want
    assert kup.operand(dy) is dy  # on the CPU the plain version takes any layout


def test_backward_raises_on_a_downsample_and_a_wrong_rank():
    with pytest.raises(ValueError, match="upsample only"):
        kup.upsample_bilinear_bwd(torch.zeros(1, 3, 8, 8), (9, 8))
    with pytest.raises(ValueError, match="upsample only"):
        kup.upsample_bilinear_bwd_plain(torch.zeros(1, 3, 8, 8), (8, 16))
    with pytest.raises(ValueError, match=r"\(N, C, Ho, Wo\)"):
        kup.upsample_bilinear_bwd(torch.zeros(3, 8, 8), (4, 4))
