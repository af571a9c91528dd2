"""RGB <-> HSV / HLS on (..., 3) tensors (port of the JAX
``ops/colorspace.py``): OpenCV float conventions, H in degrees [0, 360),
S / L / V in [0, 1]. Each op runs in the input's dtype, in the JAX
package's order of operations."""

from __future__ import annotations

import torch


def _hue(r, g, b, maxc, delta):
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    h = torch.where(
        maxc == r,
        torch.remainder((g - b) / safe, 6.0),
        torch.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    return torch.where(delta == 0, torch.zeros_like(h), h)


def _sectors(hp, c, x):
    """RGB before the offset ``m``, from the sector of ``hp = h / 60``."""
    z = torch.zeros_like(c)
    sector = torch.remainder(torch.floor(hp).to(torch.int32), 6)
    table = {  # sector: (r, g, b); sector 5 is the default
        0: (c, x, z), 1: (x, c, z), 2: (z, c, x), 3: (z, x, c), 4: (x, z, c),
    }
    r, g, b = c, z, x
    for s in (4, 3, 2, 1, 0):
        on = sector == s
        tr, tg, tb = table[s]
        r, g, b = torch.where(on, tr, r), torch.where(on, tg, g), torch.where(on, tb, b)
    return r, g, b


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    h = _hue(r, g, b, maxc, delta) * 60.0
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, torch.ones_like(maxc)),
                    torch.zeros_like(maxc))
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = torch.remainder(hsv[..., 0], 360.0), hsv[..., 1], hsv[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    m = v - c
    r, g, b = _sectors(hp, c, x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def rgb_to_hls(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (..., 3) HLS (OpenCV channel order H, L, S)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    l = (maxc + minc) / 2.0
    denom = torch.where(l < 0.5, maxc + minc, 2.0 - maxc - minc)
    s = torch.where(delta == 0, torch.zeros_like(delta),
                    delta / torch.where(denom > 0, denom, torch.ones_like(denom)))
    h = _hue(r, g, b, maxc, delta)
    return torch.stack([h * 60.0, l, s], dim=-1)


def hls_to_rgb(hls: torch.Tensor) -> torch.Tensor:
    h, l, s = torch.remainder(hls[..., 0], 360.0), hls[..., 1], hls[..., 2]
    c = (1.0 - (2.0 * l - 1.0).abs()) * s
    hp = h / 60.0
    x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    m = l - c / 2.0
    r, g, b = _sectors(hp, c, x)
    return torch.stack([r + m, g + m, b + m], dim=-1)
