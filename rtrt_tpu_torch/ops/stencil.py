"""2D stencil helpers and resampling (port of rtrt_tpu/ops/stencil.py::
shifted, neighborhood, bilinear_sample, bicubic_catmull_rom_sample,
gaussian_weights; `clamp_rows` and `crop_rows` serve the row-sharded
frame).  Images are (H, W, C) or (H, W)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.consts import device_const


def _edge_pad(img, py: int, px: int):
    """img padded by py rows and px columns on each side, edges repeated
    (two index_selects, any dtype)."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(-py, h + py, device=img.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-px, w + px, device=img.device), 0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def clamp_rows(img, lo: int, hi: int):
    """Rows lo .. hi - 1 of an (H, ...) image, each clamped to [0, H - 1]:
    a band of rows with the rows around it that a stencil reads, the
    image's edge rows repeated beyond its edges as the stencils clamp."""
    ys = torch.clamp(torch.arange(lo, hi, device=img.device), 0,
                     img.shape[0] - 1)
    return img.index_select(0, ys)


def crop_rows(img, pad: int):
    """img without its first and last `pad` rows (itself for pad 0): a
    stage's own rows of planes that carry its stencil's rows around them."""
    return img if pad == 0 else img[pad:img.shape[0] - pad]


def shifted(img, dy: int, dx: int):
    """Image translated by (dy, dx) with edge-clamp boundary:
    out[y, x] = img[clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape[0], img.shape[1]
    p = _edge_pad(img, abs(dy), abs(dx))
    return p[abs(dy) + dy:abs(dy) + dy + h, abs(dx) + dx:abs(dx) + dx + w]


def neighborhood(img, radius: int, stride: int = 1):
    """All (2r+1)^2 shifted copies, dy outer and dx inner: returns the
    (K, H, W, ...) stack and the matching (K, 2) integer offsets.  The
    image is edge-padded once; every tap is a view of the padded copy."""
    h, w = img.shape[0], img.shape[1]
    r = radius * stride
    p = _edge_pad(img, r, r)
    taps, offsets = [], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            y0, x0 = r + dy * stride, r + dx * stride
            taps.append(p[y0:y0 + h, x0:x0 + w])
            offsets.append((dy, dx))
    return torch.stack(taps, dim=0), torch.tensor(offsets, dtype=torch.int32)


def _texel_coords(img, uv):
    """Continuous texel coordinates of uv (..., 2) in [0,1]^2, clamped to
    the pixel centres: (x, y)."""
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    return x, y


def bilinear_sample(img, uv):
    """Bilinear sample at continuous uv in [0,1]^2 (clamped); img (H,W,C),
    uv (...,2) -> (...,C)."""
    h, w = img.shape[0], img.shape[1]
    x, y = _texel_coords(img, uv)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    c00 = img[y0i, x0i]
    c01 = img[y0i, x1i]
    c10 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) \
        + (c10 * (1 - fx) + c11 * fx) * fy


def _catmull_rom_w(f):
    """Catmull-Rom weights for fractional position f (...,): 4 taps."""
    f2 = f * f
    f3 = f2 * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3


def bicubic_catmull_rom_sample(img, uv):
    """16-tap Catmull-Rom bicubic; img (H,W,C), uv (...,2) clamped.  Taps
    summed in the JAX module's order: four taps along x a row, rows
    along y."""
    h, w = img.shape[0], img.shape[1]
    x, y = _texel_coords(img, uv)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = _catmull_rom_w(x - x0)
    wy = _catmull_rom_w(y - y0)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    acc = 0.0
    for j in range(4):
        yy = torch.clamp(y0i + (j - 1), 0, h - 1)
        row = 0.0
        for i in range(4):
            xx = torch.clamp(x0i + (i - 1), 0, w - 1)
            row = row + img[yy, xx] * wx[i][..., None]
        acc = acc + row * wy[j][..., None]
    return acc


def gaussian_weights_np(radius: int, sigma: float | None = None):
    """Normalized (2r+1)^2 gaussian tap weights, flattened (K,): computed in
    float64 and rounded to float32 once."""
    if sigma is None:
        sigma = radius * 0.5 + 0.25
    ax = np.arange(-radius, radius + 1)
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k2 = np.outer(k, k)
    return (k2 / k2.sum()).reshape(-1).astype(np.float32)


def gaussian_weights(radius: int, device, sigma: float | None = None):
    """gaussian_weights_np as a float32 tensor on `device` (copied there
    once)."""
    return device_const(tuple(gaussian_weights_np(radius, sigma).tolist()),
                        device)
