"""The port's augmentation against the JAX package's.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so each op is held in two ways:

- its deterministic core, fed the JAX op's own draws (the factors, fields
  and boxes the JAX op derives from its key), against the JAX op on the
  same numpy-seeded images, 2 x 32 x 48;
- its draws, in distribution: ranges, and the Poisson and CoarseDropout
  laws of ``tests/test_augment_dist.py``.

Tolerances, each with its reason:

- f32: atol 1e-5 on [0, 1] images (1e-3 degrees on hues): the same f32
  operations, with means and the luma dot product summed in another order;
- bf16 ``aug_dtype``: each op in bf16 rounds differently in the two
  frameworks (the luma dot product, the mean), and a one-ulp change of a
  bf16 hue (2 degrees near 360) moves the colour by up to a few ulps. So at
  least 99% of the values agree within 2 bf16 ulps of 1.0 (2 ** -7) and all
  within 0.1;
- uint8: at least 99% of the values equal, all within 2 codes (a rounding
  tie of the f32 step math can move a code by one per step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.ops import augment as jaug
from rtda_semanticsegmentation_tpu.ops import colorspace as jcs
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.ops import augment as taug
from rtda_semanticsegmentation_tpu_torch.ops import colorspace as tcs

B, H, W = 2, 32, 48
CFG = jconfig.AugmentConfig()
TCFG = tconfig.AugmentConfig()
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "uint8": (jnp.uint8, torch.uint8)}


def _images(seed, dtype):
    u8 = np.random.RandomState(seed).randint(0, 256, (B, H, W, 3), np.uint8)
    jdt, tdt = DTYPES[dtype]
    if dtype == "uint8":
        return jnp.asarray(u8), torch.from_numpy(u8)
    f = u8.astype(np.float32) / 255.0
    return jnp.asarray(f).astype(jdt), torch.from_numpy(f).to(tdt)


def _assert_close(got: torch.Tensor, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
        return
    diff = np.abs(got - want)
    tol, worst = (2.0 ** -7, 0.1) if dtype == "bfloat16" else (0.0, 2.0)
    assert (diff <= tol).mean() >= 0.99, (diff > tol).mean()
    assert diff.max() <= worst, diff.max()


def _stack(draws):
    return {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in draws])) for k in draws[0]}


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def _cj_draws(key, cfg):
    """The factors ``ops/augment.py::color_jitter`` draws from ``key``."""
    k_ord, k_b, k_c, k_s, k_h = jax.random.split(key, 5)
    return {
        "fb": jax.random.uniform(k_b, minval=1.0 - cfg.cj_brightness, maxval=1.0 + cfg.cj_brightness),
        "fc": jax.random.uniform(k_c, minval=1.0 - cfg.cj_contrast, maxval=1.0 + cfg.cj_contrast),
        "fs": jax.random.uniform(k_s, minval=1.0 - cfg.cj_saturation, maxval=1.0 + cfg.cj_saturation),
        "fh": jax.random.uniform(k_h, minval=-cfg.cj_hue, maxval=cfg.cj_hue),
        "order": jax.random.permutation(k_ord, 4),
    }


def _iso_draws(key, cfg):
    k_i, k_c, k_pois, k_norm = jax.random.split(key, 4)
    return {
        "intensity": jax.random.uniform(k_i, minval=cfg.iso_intensity[0], maxval=cfg.iso_intensity[1]),
        "color_shift": jax.random.uniform(k_c, minval=cfg.iso_color_shift[0], maxval=cfg.iso_color_shift[1]),
        "z_pois": jax.random.normal(k_pois, (H, W)),
        "z_color": jax.random.normal(k_norm, (H, W)),
    }


def _cd_draws(key, cfg):
    k_n, k_h, k_w, k_y, k_x = jax.random.split(key, 5)
    m, (lo, hi) = cfg.cd_max_holes, cfg.cd_hole_size
    return {
        "n": jax.random.randint(k_n, (), cfg.cd_min_holes, m + 1),
        "hh": jax.random.randint(k_h, (m,), lo, hi + 1),
        "ww": jax.random.randint(k_w, (m,), lo, hi + 1),
        "uy": jax.random.uniform(k_y, (m,)),
        "ux": jax.random.uniform(k_x, (m,)),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_colorspace_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rgb = np.random.RandomState(0).rand(B, H, W, 3).astype(np.float32)
    rgb[0, 0, :4] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 1, 1], [0.2, 0.7, 0.7]]  # grey, ties
    jrgb, trgb = jnp.asarray(rgb).astype(jdt), torch.from_numpy(rgb).to(tdt)
    for to, back in (("rgb_to_hsv", "hsv_to_rgb"), ("rgb_to_hls", "hls_to_rgb")):
        jmid, tmid = getattr(jcs, to)(jrgb), getattr(tcs, to)(trgb)
        scale = np.array([360.0, 1.0, 1.0], np.float32)  # hue in degrees
        _assert_close(tmid / torch.from_numpy(scale).to(tdt), np.asarray(jmid, np.float32) / scale, dtype)
        # the inverse on the same (JAX's) input
        _assert_close(getattr(tcs, back)(torch.from_numpy(np.array(jmid, np.float32)).to(tdt)),
                      getattr(jcs, back)(jmid), dtype)
        if dtype == "float32":  # round trip
            np.testing.assert_allclose(getattr(tcs, back)(tmid).numpy(), rgb, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_color_jitter_core_matches_jax(dtype):
    jimg, timg = _images(1, dtype)
    keys = _keys(2)
    want = np.stack([np.asarray(jaug.color_jitter(jimg[i], keys[i], CFG), np.float32) for i in range(B)])
    draws = _stack([_cj_draws(k, CFG) for k in keys])
    _assert_close(taug.color_jitter(timg, **draws), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_iso_noise_core_matches_jax(dtype):
    jimg, timg = _images(3, dtype)
    keys = _keys(4)
    want = np.stack([np.asarray(jaug.iso_noise(jimg[i], keys[i], CFG), np.float32) for i in range(B)])
    draws = _stack([_iso_draws(k, CFG) for k in keys])
    _assert_close(taug.iso_noise(timg, **draws), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_coarse_dropout_core_matches_jax_exactly(dtype):
    jimg, timg = _images(5, dtype)
    cfg = dataclasses.replace(CFG, cd_fill=0.25)
    keys = _keys(6)
    want = np.stack([np.asarray(jaug.coarse_dropout(jimg[i], keys[i], cfg)) for i in range(B)])
    draws = _stack([_cd_draws(k, cfg) for k in keys])
    got = taug.coarse_dropout(timg, **draws, fill=cfg.cd_fill)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want.astype(np.float32))


def test_poisson_core_matches_jax_exactly():
    z = np.random.RandomState(7).randn(4, 1000).astype(np.float32)
    lam = np.array([[0.0], [0.4], [3.0], [20.0]], np.float32)
    want = np.asarray(jnp.maximum(jnp.round(
        jnp.maximum(lam, 0) + jnp.sqrt(jnp.maximum(lam, 0)) * z
        + jnp.minimum(jnp.maximum(lam, 0), 1.0) * (z * z - 1.0) / 6.0), 0.0))
    key = jax.random.PRNGKey(8)
    jz = np.array(jax.random.normal(key, (1000,)))
    np.testing.assert_array_equal(
        taug._poisson_approx(torch.from_numpy(jz), torch.tensor(3.0)).numpy(),
        np.asarray(jaug._poisson_approx(key, 3.0, (1000,))))
    np.testing.assert_array_equal(taug._poisson_approx(torch.from_numpy(z), torch.from_numpy(lam)).numpy(), want)


def _ks_discrete(a, b):
    hi = int(max(a.max(), b.max())) + 1
    ca = np.bincount(a.astype(int), minlength=hi).cumsum() / len(a)
    cb = np.bincount(b.astype(int), minlength=hi).cumsum() / len(b)
    return float(np.abs(ca - cb).max())


@pytest.mark.parametrize("lam", [1.5, 3.0, 7.7, 20.0])
def test_poisson_draws_match_true_poisson(lam):
    """The port's draws through the skew-corrected Gaussian against numpy's
    true Poisson, with ``test_augment_dist.py``'s bounds."""
    n = 400_000
    z = torch.randn(n, generator=torch.Generator().manual_seed(1))
    ours = taug._poisson_approx(z, torch.tensor(lam)).numpy().astype(np.float64)
    ref = np.random.RandomState(0).poisson(lam, n).astype(np.float64)
    assert ours.mean() == pytest.approx(ref.mean(), rel=0.02)
    assert ours.var() == pytest.approx(ref.var(), rel=0.06)
    assert _ks_discrete(ours, ref) < 0.015


def test_draws_lie_in_the_configured_ranges():
    g = torch.Generator().manual_seed(3)
    n = 4000
    cj = taug.draw_color_jitter(g, n, TCFG)
    for k, width in (("fb", TCFG.cj_brightness), ("fc", TCFG.cj_contrast), ("fs", TCFG.cj_saturation)):
        assert float(cj[k].min()) >= 1 - width and float(cj[k].max()) <= 1 + width
        assert float(cj[k].mean()) == pytest.approx(1.0, abs=0.02)
    assert float(cj["fh"].abs().max()) <= TCFG.cj_hue
    assert torch.equal(cj["order"].sort(dim=1).values, torch.arange(4).expand(n, 4))
    first = torch.bincount(cj["order"][:, 0], minlength=4).float() / n
    assert float((first - 0.25).abs().max()) < 0.03  # the order is uniform
    iso = taug.draw_iso_noise(g, (n, 2, 2), TCFG)
    for k, (lo, hi) in (("intensity", TCFG.iso_intensity), ("color_shift", TCFG.iso_color_shift)):
        assert float(iso[k].min()) >= lo and float(iso[k].max()) <= hi
    cd = taug.draw_coarse_dropout(g, n, TCFG)
    assert set(cd["n"].unique().tolist()) == set(range(TCFG.cd_min_holes, TCFG.cd_max_holes + 1))
    lo, hi = TCFG.cd_hole_size
    assert int(cd["hh"].min()) == lo and int(cd["hh"].max()) == hi


def test_coarse_dropout_zero_rate_matches_oracle():
    """P(pixel filled) of the port's draws + core against
    ``test_augment_dist.py``'s numpy oracle of albumentations' boxes."""
    hh_img = ww_img = 96
    k = 300
    g = torch.Generator().manual_seed(19)
    img = torch.full((k, hh_img, ww_img, 3), 0.5)
    ours = taug.coarse_dropout(img, **taug.draw_coarse_dropout(g, k, TCFG), fill=TCFG.cd_fill)
    ours_rate = float((ours[..., 0] == TCFG.cd_fill).float().mean())
    rng = np.random.RandomState(23)
    lo, hi = TCFG.cd_hole_size
    zero = 0.0
    for _ in range(k):
        mask = np.zeros((hh_img, ww_img), bool)
        for _ in range(rng.randint(TCFG.cd_min_holes, TCFG.cd_max_holes + 1)):
            bh, bw = min(rng.randint(lo, hi + 1), hh_img), min(rng.randint(lo, hi + 1), ww_img)
            y, x = int(rng.uniform() * max(hh_img - bh, 0)), int(rng.uniform() * max(ww_img - bw, 0))
            mask[y:y + bh, x:x + bw] = True
        zero += mask.mean()
    assert ours_rate == pytest.approx(zero / k, rel=0.12)


@pytest.mark.parametrize("pipeline", ["no_new_aug", "hflip_only", "all_four_combined", "all_four_plus_hflip"])
@pytest.mark.parametrize("dtype", ["bfloat16", "uint8"])
def test_augment_batch(pipeline, dtype):
    rng = np.random.RandomState(9)
    u8 = torch.from_numpy(rng.randint(0, 256, (8, H, W, 3), np.uint8))
    labels = torch.from_numpy(rng.randint(0, 19, (8, H, W)).astype(np.int32))
    cfg = dataclasses.replace(TCFG, pipeline=pipeline, aug_dtype=dtype)
    x, y = taug.augment_batch(u8, labels, torch.Generator().manual_seed(0), cfg)
    assert x.dtype == torch.float32 and tuple(x.shape) == (8, H, W, 3) and bool(torch.isfinite(x).all())
    base = taug.normalize_u8(u8, cfg)
    if pipeline == "no_new_aug":
        assert torch.equal(x, base) and torch.equal(y, labels)
        return
    flipped = torch.all((y == labels.flip(2)).flatten(1), dim=1)
    kept = torch.all((y == labels).flatten(1), dim=1)
    assert bool((flipped | kept).all())
    if pipeline == "hflip_only":
        assert torch.equal(x, torch.where(flipped.view(-1, 1, 1, 1), base.flip(2), base))
        assert 0 < int(flipped.sum()) < 8
    else:
        assert not torch.equal(x, base)
    # a seed fixes every draw
    x2, y2 = taug.augment_batch(u8, labels, torch.Generator().manual_seed(0), cfg)
    assert torch.equal(x, x2) and torch.equal(y, y2)
