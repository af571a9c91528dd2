"""On-device, batched image augmentation and normalization (port of the
JAX ``ops/augment.py``).

The train pipeline takes a uint8 NHWC batch on the device: [HFlip] ->
ColorJitter -> ISONoise -> CoarseDropout, each firing per image with
probability ``cfg.prob``, then ImageNet normalization
(:func:`augment_batch`). The chain runs in ``cfg.aug_dtype``.

Each op is split into a draw (``draw_*``: its random factors, fields and
boxes, from a ``torch.Generator``) and a deterministic core that applies
them to a (B, H, W, 3) batch, so that the tests can feed the JAX op's own
draws to the core. ``torch.Generator`` and ``jax.random`` draw different
numbers from one seed; only the laws agree. Like the JAX ops under
``vmap``, a core computes its result for every image and a per-image flag
selects it.

Data parallel: a rank holding rows ``lo .. lo + b`` of a global batch of
``n`` (``rows=(lo, n)``) draws every factor and noise field for all ``n``
images from the same seeded generator, as the one process of an
unsharded run does, and keeps its rows; its augmented rows are then those
of the unsharded batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import AugmentConfig
from .colorspace import hls_to_rgb, hsv_to_rgb, rgb_to_hls, rgb_to_hsv

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R 601 luma (torchvision)


def normalize(images: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """ImageNet normalization of [0, 1] float images, channels last, in the
    images' own float dtype floored at f32."""
    dt = torch.promote_types(images.dtype, torch.float32)
    mean = torch.tensor(cfg.norm_mean, dtype=dt, device=images.device)
    std = torch.tensor(cfg.norm_std, dtype=dt, device=images.device)
    return (images.to(dt) - mean) / std


def normalize_u8(images_u8: torch.Tensor, cfg: AugmentConfig, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalized float NHWC (the eval / no-aug path)."""
    return normalize(images_u8.to(dtype) / 255.0, cfg)


def aug_dtype(cfg: AugmentConfig) -> torch.dtype:
    """The storage dtype of the stochastic chain."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "uint8": torch.uint8}[cfg.aug_dtype]


def _per_image(v: torch.Tensor, dims: int = 4) -> torch.Tensor:
    return v.view(-1, *([1] * (dims - 1)))


def _uniform(generator, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=generator.device)


def _blend(a, b, ratio):
    return (ratio * a + (1.0 - ratio) * b).clamp(0.0, 1.0)


def _hue(img, shift):
    hsv = rgb_to_hsv(img)
    hsv = torch.stack([hsv[..., 0] + shift, hsv[..., 1], hsv[..., 2]], dim=-1)
    return hsv_to_rgb(hsv).clamp(0.0, 1.0)


def draw_color_jitter(generator, b: int, cfg: AugmentConfig) -> dict:
    """Per image: brightness, contrast and saturation factors, the hue shift
    (a fraction of a turn) and a uniformly random order of the four ops."""
    return {
        "fb": _uniform(generator, (b,), 1.0 - cfg.cj_brightness, 1.0 + cfg.cj_brightness),
        "fc": _uniform(generator, (b,), 1.0 - cfg.cj_contrast, 1.0 + cfg.cj_contrast),
        "fs": _uniform(generator, (b,), 1.0 - cfg.cj_saturation, 1.0 + cfg.cj_saturation),
        "fh": _uniform(generator, (b,), -cfg.cj_hue, cfg.cj_hue),
        "order": torch.rand((b, 4), generator=generator, device=generator.device).argsort(dim=1),
    }


def color_jitter(img, fb, fc, fs, fh, order):
    """torchvision/albumentations ColorJitter on a (B, H, W, 3) batch in
    [0, 1] (float) or [0, 255] (uint8): step ``i`` applies op ``order[:, i]``
    (0 brightness, 1 contrast, 2 saturation, 3 hue). A uint8 batch is
    rounded back to uint8 after every step, with the step's math in f32."""
    u8 = img.dtype == torch.uint8
    dt = torch.float32 if u8 else img.dtype
    fb, fc, fs = (_per_image(f.to(dt)) for f in (fb, fc, fs))
    shift = _per_image((fh.to(torch.float32) * 360.0).to(dt), 3)
    w = torch.tensor(_GRAY_WEIGHTS, dtype=dt, device=img.device)
    for i in range(4):
        im = img.to(torch.float32) / 255.0 if u8 else img
        gray = im @ w
        mean = _per_image(gray.to(torch.float32).mean(dim=(1, 2)).to(dt))
        o = _per_image(order[:, i])
        out = torch.where(o == 0, (im * fb).clamp(0.0, 1.0),
              torch.where(o == 1, _blend(im, mean, fc),
              torch.where(o == 2, _blend(im, gray.unsqueeze(-1), fs), _hue(im, shift))))
        img = torch.round(out * 255.0).to(torch.uint8) if u8 else out
    return img


def _poisson_approx(z: torch.Tensor, lam) -> torch.Tensor:
    """Poisson(lam) from standard normal draws ``z``: the skew-corrected
    (Cornish-Fisher) Gaussian ``lam + sqrt(lam) z + min(lam, 1) (z^2 - 1)/6``,
    rounded and clamped at 0."""
    lam = torch.clamp_min(lam, 0.0)
    w = torch.clamp_max(lam, 1.0)
    x = lam + torch.sqrt(lam) * z + w * (z * z - 1.0) / 6.0
    return torch.clamp_min(torch.round(x), 0.0)


def draw_iso_noise(generator, shape, cfg: AugmentConfig) -> dict:
    """Per image: intensity and colour shift; per pixel of ``shape`` (B, H,
    W): the normal draws of the luminance (Poisson) and the hue noise."""
    b = shape[0]
    return {
        "intensity": _uniform(generator, (b,), *cfg.iso_intensity),
        "color_shift": _uniform(generator, (b,), *cfg.iso_color_shift),
        "z_pois": torch.randn(shape, generator=generator, device=generator.device),
        "z_color": torch.randn(shape, generator=generator, device=generator.device),
    }


def iso_noise(img, intensity, color_shift, z_pois, z_color):
    """albumentations ISONoise on a (B, H, W, 3) batch in [0, 1] (float) or
    [0, 255] (uint8), in f32 inside:
    L += Poisson(std(L) * intensity * 255) / 255 * (1 - L);
    H += Normal(0, color_shift * 360 * intensity) degrees."""
    dt = img.dtype
    u8 = dt == torch.uint8
    x = img.to(torch.float32)
    if u8:
        x = x / 255.0
    hls = rgb_to_hls(x)
    stddev = hls[..., 1].std(dim=(1, 2), correction=0)
    lam = _per_image(stddev * intensity * 255.0, 3)
    pois = _poisson_approx(z_pois, lam)
    noise = z_color * _per_image(color_shift, 3) * 360.0 * _per_image(intensity, 3)
    h = torch.remainder(hls[..., 0] + noise, 360.0)
    l = (hls[..., 1] + (pois / 255.0) * (1.0 - hls[..., 1])).clamp(0.0, 1.0)
    out = hls_to_rgb(torch.stack([h, l, hls[..., 2]], dim=-1)).clamp(0.0, 1.0)
    if u8:
        return torch.round(out * 255.0).to(torch.uint8)
    return out.to(dt)


def draw_coarse_dropout(generator, b: int, cfg: AugmentConfig) -> dict:
    """Per image: the number of holes, and for each of ``cd_max_holes``
    boxes its height, width and uniform draws for its origin."""
    m = cfg.cd_max_holes
    lo, hi = cfg.cd_hole_size
    dev = generator.device
    return {
        "n": torch.randint(cfg.cd_min_holes, m + 1, (b,), generator=generator, device=dev),
        "hh": torch.randint(lo, hi + 1, (b, m), generator=generator, device=dev),
        "ww": torch.randint(lo, hi + 1, (b, m), generator=generator, device=dev),
        "uy": torch.rand((b, m), generator=generator, device=dev),
        "ux": torch.rand((b, m), generator=generator, device=dev),
    }


def coarse_dropout(img, n, hh, ww, uy, ux, fill: float = 0.0):
    """albumentations CoarseDropout on a (B, H, W, 3) batch: the first
    ``n`` of each image's boxes, clamped to the image, take ``fill`` (scaled
    to 255 for uint8)."""
    h_img, w_img = img.shape[1], img.shape[2]
    hh = hh.clamp_max(h_img)
    ww = ww.clamp_max(w_img)
    y1 = (uy * (h_img - hh).clamp_min(0)).to(torch.int32)
    x1 = (ux * (w_img - ww).clamp_min(0)).to(torch.int32)
    active = torch.arange(hh.shape[1], device=img.device) < n.unsqueeze(1)  # (B, m)
    rows = torch.arange(h_img, device=img.device).view(1, 1, -1)
    cols = torch.arange(w_img, device=img.device).view(1, 1, -1)
    in_rows = active.unsqueeze(-1) & (rows >= y1.unsqueeze(-1)) & (rows < (y1 + hh).unsqueeze(-1))
    in_cols = (cols >= x1.unsqueeze(-1)) & (cols < (x1 + ww).unsqueeze(-1))
    inside = (in_rows.unsqueeze(-1) & in_cols.unsqueeze(-2)).any(dim=1)  # (B, H, W)
    value = round(fill * 255.0) if img.dtype == torch.uint8 else fill
    return torch.where(inside.unsqueeze(-1), torch.full((), value, dtype=img.dtype, device=img.device), img)


def _mine(draws: dict, rows, b: int) -> dict:
    """This rank's rows of draws made for the whole batch."""
    return {k: v[rows[0]: rows[0] + b] for k, v in draws.items()}


def augment_batch(images_u8, labels, generator, cfg: AugmentConfig, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train pipeline on a (B, H, W, 3) uint8 batch and its (B, H, W)
    labels; returns (normalized f32 images, labels). Labels change only
    under the horizontal flip. ``generator`` lives on the batch's device.
    ``rows=(lo, n)``: the batch is rows ``lo .. lo + B`` of a global batch
    of ``n``, whose draws are made and cut to these rows."""
    hflip, cj, iso, cd = cfg.flags
    b = images_u8.shape[0]
    rows = rows or (0, b)
    n, dev = rows[1], generator.device

    def fires():
        """The images whose draw fires (probability ``cfg.prob``)."""
        return _per_image(_mine({"on": torch.rand((n,), generator=generator, device=dev) < cfg.prob}, rows, b)["on"])

    if hflip:
        flip = fires()
        images_u8 = torch.where(flip, images_u8.flip(2), images_u8)
        labels = torch.where(flip[..., 0], labels.flip(2), labels)
    if not (cj or iso or cd):
        return normalize(images_u8.to(torch.float32) / 255.0, cfg), labels
    dt = aug_dtype(cfg)
    imgs = images_u8 if dt == torch.uint8 else (images_u8.to(torch.float32) / 255.0).to(dt)
    if cj:
        on = fires()
        imgs = torch.where(on, color_jitter(imgs, **_mine(draw_color_jitter(generator, n, cfg), rows, b)), imgs)
    if iso:
        on = fires()
        draws = _mine(draw_iso_noise(generator, (n,) + tuple(imgs.shape[1:3]), cfg), rows, b)
        imgs = torch.where(on, iso_noise(imgs, **draws), imgs)
    if cd:
        on = fires()
        draws = _mine(draw_coarse_dropout(generator, n, cfg), rows, b)
        imgs = torch.where(on, coarse_dropout(imgs, **draws, fill=cfg.cd_fill), imgs)
    imgs = imgs.to(torch.float32)
    if dt == torch.uint8:
        imgs = imgs / 255.0
    return normalize(imgs, cfg), labels
