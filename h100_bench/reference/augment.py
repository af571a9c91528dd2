"""The train augmentation in float32: [HFlip] -> ColorJitter -> ISONoise ->
CoarseDropout, each firing per image with probability ``prob``, then
ImageNet normalization, on (B, H, W, 3) frames.

The random draws come from the generator handed in, in this order: per op
the firing draw, then the op's own draws (ColorJitter: brightness,
contrast, saturation and hue factors, then the order of its four ops;
ISONoise: intensity, colour shift, then two per-pixel normal fields;
CoarseDropout: hole count, heights, widths, then the two origin draws).
Colour spaces follow OpenCV's float conventions (H in degrees).
"""

from __future__ import annotations

import torch

_LUMA = (0.299, 0.587, 0.114)


def _u(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _img(v, dims=4):
    return v.view(-1, *([1] * (dims - 1)))


def _hue_of(r, g, b, mx, delta):
    d = torch.where(delta > 0, delta, torch.ones_like(delta))
    h = torch.where(mx == r, torch.remainder((g - b) / d, 6.0),
                    torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0))
    return torch.where(delta > 0, h * 60.0, torch.zeros_like(h))


def _from_chroma(h, c, m):
    """RGB from hue (degrees), chroma and the offset ``m``."""
    hp = torch.remainder(h, 360.0) / 60.0
    x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    z = torch.zeros_like(c)
    s = torch.floor(hp).clamp(0, 5)
    r = torch.where((s == 0) | (s == 5), c, torch.where((s == 1) | (s == 4), x, z))
    g = torch.where((s == 1) | (s == 2), c, torch.where((s == 0) | (s == 3), x, z))
    b = torch.where((s == 3) | (s == 4), c, torch.where((s == 2) | (s == 5), x, z))
    return torch.stack([r + m, g + m, b + m], dim=-1)


def rgb_to_hsv(x):
    r, g, b = x.unbind(-1)
    mx, mn = x.amax(-1), x.amin(-1)
    delta = mx - mn
    s = torch.where(mx > 0, delta / torch.where(mx > 0, mx, torch.ones_like(mx)), torch.zeros_like(mx))
    return _hue_of(r, g, b, mx, delta), s, mx


def hsv_to_rgb(h, s, v):
    c = v * s
    return _from_chroma(h, c, v - c)


def rgb_to_hls(x):
    r, g, b = x.unbind(-1)
    mx, mn = x.amax(-1), x.amin(-1)
    delta = mx - mn
    l = (mx + mn) / 2.0
    den = torch.where(l < 0.5, mx + mn, 2.0 - mx - mn)
    s = torch.where(delta > 0, delta / torch.where(den > 0, den, torch.ones_like(den)), torch.zeros_like(den))
    return _hue_of(r, g, b, mx, delta), l, s


def hls_to_rgb(h, l, s):
    c = (1.0 - (2.0 * l - 1.0).abs()) * s
    return _from_chroma(h, c, l - c / 2.0)


def _blend(a, b, r):
    return (r * a + (1.0 - r) * b).clamp(0.0, 1.0)


def color_jitter(x, fb, fc, fs, fh, order):
    """torchvision's ColorJitter: op ``order[:, i]`` at step ``i`` (0
    brightness, 1 contrast, 2 saturation, 3 hue)."""
    w = torch.tensor(_LUMA, dtype=x.dtype, device=x.device)
    for i in range(4):
        gray = x @ w
        mean = _img(gray.mean(dim=(1, 2)))
        h, s, v = rgb_to_hsv(x)
        hued = hsv_to_rgb(h + _img(fh * 360.0, 3), s, v).clamp(0.0, 1.0)
        o = _img(order[:, i])
        x = torch.where(o == 0, (x * _img(fb)).clamp(0.0, 1.0),
            torch.where(o == 1, _blend(x, mean, _img(fc)),
            torch.where(o == 2, _blend(x, gray.unsqueeze(-1), _img(fs)), hued)))
    return x


def iso_noise(x, intensity, color_shift, z_pois, z_color):
    """ISONoise: the lightness gains Poisson(std(L) * intensity * 255) / 255
    of its headroom (the Poisson draw from a normal one, skew-corrected
    and rounded); the hue moves by Normal(0, color_shift * 360 *
    intensity) degrees."""
    h, l, s = rgb_to_hls(x)
    lam = _img(l.std(dim=(1, 2), correction=0) * intensity * 255.0, 3).clamp_min(0.0)
    pois = torch.round(lam + lam.sqrt() * z_pois + lam.clamp_max(1.0) * (z_pois * z_pois - 1.0) / 6.0).clamp_min(0.0)
    h = torch.remainder(h + z_color * _img(color_shift * 360.0 * intensity, 3), 360.0)
    l = (l + pois / 255.0 * (1.0 - l)).clamp(0.0, 1.0)
    return hls_to_rgb(h, l, s).clamp(0.0, 1.0)


def coarse_dropout(x, n, hh, ww, uy, ux, fill):
    """The first ``n`` of each image's boxes, clamped to the image, take
    ``fill``."""
    H, W = x.shape[1:3]
    hh, ww = hh.clamp_max(H), ww.clamp_max(W)
    y1 = (uy * (H - hh).clamp_min(0)).long()
    x1 = (ux * (W - ww).clamp_min(0)).long()
    on = torch.arange(hh.shape[1], device=x.device) < n.unsqueeze(1)
    ys = torch.arange(H, device=x.device).view(1, 1, H)
    xs = torch.arange(W, device=x.device).view(1, 1, W)
    rows = on.unsqueeze(-1) & (ys >= y1.unsqueeze(-1)) & (ys < (y1 + hh).unsqueeze(-1))
    cols = (xs >= x1.unsqueeze(-1)) & (xs < (x1 + ww).unsqueeze(-1))
    inside = (rows.unsqueeze(-1) & cols.unsqueeze(-2)).any(dim=1)
    return torch.where(inside.unsqueeze(-1), torch.full_like(x, fill), x)


def normalize(x, aug: dict):
    mean = torch.tensor(aug["norm_mean"], dtype=x.dtype, device=x.device)
    std = torch.tensor(aug["norm_std"], dtype=x.dtype, device=x.device)
    return (x - mean) / std


def flags(pipeline: str):
    """(hflip, colorjitter, isonoise, coarsedropout) of a pipeline name."""
    return (pipeline in ("hflip_only", "all_four_plus_hflip"),
            pipeline in ("colorjitter_only", "all_four_combined", "all_four_plus_hflip"),
            pipeline in ("isonoise_only", "all_four_combined", "all_four_plus_hflip"),
            pipeline in ("coarsedropout_only", "all_four_combined", "all_four_plus_hflip"))


def augment(images_u8, labels, gen, aug: dict):
    """Normalized float32 (B, H, W, 3) frames and their labels."""
    hflip, cj, iso, cd = flags(aug["pipeline"])
    b, H, W = images_u8.shape[:3]
    dev = gen.device

    def fires():
        return _img(torch.rand((b,), generator=gen, device=dev) < aug["prob"])

    if hflip:
        on = fires()
        images_u8 = torch.where(on, images_u8.flip(2), images_u8)
        labels = torch.where(on[..., 0], labels.flip(2), labels)
    x = images_u8.float() / 255.0
    if cj:
        on = fires()
        f = [_u(gen, (b,), 1.0 - aug[k], 1.0 + aug[k]) for k in ("cj_brightness", "cj_contrast", "cj_saturation")]
        fh = _u(gen, (b,), -aug["cj_hue"], aug["cj_hue"])
        order = torch.rand((b, 4), generator=gen, device=dev).argsort(dim=1)
        x = torch.where(on, color_jitter(x, *f, fh, order), x)
    if iso:
        on = fires()
        inten = _u(gen, (b,), *aug["iso_intensity"])
        shift = _u(gen, (b,), *aug["iso_color_shift"])
        z1 = torch.randn((b, H, W), generator=gen, device=dev)
        z2 = torch.randn((b, H, W), generator=gen, device=dev)
        x = torch.where(on, iso_noise(x, inten, shift, z1, z2), x)
    if cd:
        on = fires()
        m, (lo, hi) = aug["cd_max_holes"], aug["cd_hole_size"]
        n = torch.randint(aug["cd_min_holes"], m + 1, (b,), generator=gen, device=dev)
        hh = torch.randint(lo, hi + 1, (b, m), generator=gen, device=dev)
        ww = torch.randint(lo, hi + 1, (b, m), generator=gen, device=dev)
        uy = torch.rand((b, m), generator=gen, device=dev)
        ux = torch.rand((b, m), generator=gen, device=dev)
        x = torch.where(on, coarse_dropout(x, n, hh, ww, uy, ux, aug["cd_fill"]), x)
    return normalize(x, aug), labels
