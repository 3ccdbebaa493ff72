"""Image resampling (port of rtrt_tpu/ops/resize.py::box_pool, downsample2,
downsample4, upsample_linear, upscale_catmull_rom)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stencil import _catmull_rom_w


def box_pool(img, k: int):
    """k x k mean pool of an (H, W, C) image (truncates ragged edges)."""
    h, w = (img.shape[0] // k) * k, (img.shape[1] // k) * k
    x = img[:h, :w].reshape(h // k, k, w // k, k, *img.shape[2:])
    return x.sum(dim=(1, 3)) / (k * k)


def downsample2(img):
    """2x2 box average; (H,W,C)->(H/2,W/2,C) (truncates odd edges)."""
    return box_pool(img, 2)


def downsample4(img):
    """4x4 box average — the reference's DownScale4 unit."""
    return box_pool(img, 4)


def upsample_linear(img, out_h: int, out_w: int):
    """Bilinear resize of an (H, W, C) image to (out_h, out_w): half-pixel
    centres, edge samples clamped.  For an upsample this is the function
    of jax.image.resize(..., "linear"), whose triangle kernel drops the
    taps outside the image and renormalises the rest."""
    x = img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False)
    return y[0].permute(1, 2, 0)


def _cr_axis(n_in: int, n_out: int, device):
    """Per output pixel of one axis: the 4 clamped tap indices and their
    Catmull-Rom weights, at pixel centres (i + 0.5) / n_out."""
    u = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        / n_out
    t = torch.clamp(u * n_in - 0.5, 0.0, n_in - 1.0)
    t0 = torch.floor(t)
    i0 = t0.to(torch.int64)
    idx = [torch.clamp(i0 + (k - 1), 0, n_in - 1) for k in range(4)]
    return idx, _catmull_rom_w(t - t0)


def upscale_catmull_rom(img, out_h: int, out_w: int, out_rows=None,
                        row0: int = 0, in_h: int | None = None):
    """Catmull-Rom bicubic resample of an (H, W, ...) image to (out_h,
    out_w) — the reference's render-res -> screen-res BicubicScale.

    The function of ops/stencil.py::bicubic_catmull_rom_sample on the
    output grid's pixel centres (the JAX module's form), computed
    separably: the four x taps of every input row first, then four of
    those rows.  Each output value takes the same products and sums in
    the same order as the 16-tap form.

    Some rows of the image (a band of the row-sharded frame): out_rows
    (lo, hi) are the output rows lo .. hi - 1 (clamped to out_h) of the
    upscale of an image of in_h rows, of which img holds rows row0, row0
    + 1, ... (each clamped to it; 2 rows beyond the output rows' own
    suffice)."""
    h, w = img.shape[0], img.shape[1]
    tail = (1,) * (img.ndim - 2)
    xi, wx = _cr_axis(w, out_w, img.device)
    if out_rows is None:
        yi, wy = _cr_axis(h, out_h, img.device)
        n = out_h
    else:
        lo, hi = out_rows
        yi, wy = _cr_axis(h if in_h is None else in_h, out_h, img.device)
        sel = torch.clamp(torch.arange(lo, hi, device=img.device), 0,
                          out_h - 1)
        yi = [y.index_select(0, sel) - row0 for y in yi]
        wy = [x.index_select(0, sel) for x in wy]
        n = hi - lo
    rows = 0.0
    for i in range(4):
        rows = rows + img.index_select(1, xi[i]) * wx[i].reshape(
            (1, out_w) + tail)
    acc = 0.0
    for j in range(4):
        acc = acc + rows.index_select(0, yi[j]) * wy[j].reshape(
            (n, 1) + tail)
    return acc
