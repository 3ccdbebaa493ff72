"""Temporal reprojection filter (port of rtrt_tpu/denoise/temporal.py:
`temporal_filter` with its three history fetches, the tile noise estimate
and its debug overlay).

The history reaches `temporal_filter` in one of three ways, as in JAX:
  * `reproj`: resampled at uv + motion by denoise/reproject.py (K5 or its
    plain version) — the product path;
  * `bicubic=True`: a 16-tap Catmull-Rom gather of the history colour at
    uv + motion (ops/stencil.py), nearest material, depth and count;
  * otherwise the ±1 px shift stencil: the history colour as 9 bilinearly
    weighted shifted copies, the nearest-shift material, depth and count,
    and motion beyond one pixel rejected (the second pass of a frame with
    FeatureFlags(temporal_filter=False), and both passes of
    denoise(..., reproject_mode="stencil")).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.color import luminance, rgb_to_ycocg, ycocg_to_rgb
from ..ops.resize import box_pool
from ..ops.stencil import (bicubic_catmull_rom_sample, crop_rows,
                           neighborhood, shifted)
from ..utils.config import DenoiseParams
from ..utils.consts import device_const

_SHIFTS = (-1, 0, 1)


def _uv_grid(h, w, device, row0: int = 0, full_h: int | None = None):
    """Pixel-centre uv of rows row0 .. row0 + h - 1 of an image of full_h
    (default h) rows and w columns: (h, w, 2)."""
    ys = (torch.arange(row0, row0 + h, dtype=torch.float32, device=device)
          + 0.5) / (h if full_h is None else full_h)
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)  # (H,W,2)


def count_cap(p: DenoiseParams) -> float:
    """1 / max(temporal_blend, 1e-3), rounded as float32 arithmetic."""
    return float(np.float32(1.0) / np.maximum(np.float32(p.temporal_blend),
                                              np.float32(1e-3)))


def _shift_pick(img, ry, rx, pad: int = 0):
    """Per pixel, `shifted(img, ry, rx)` with the pixel's own shift (ry, rx
    in {-1, 0, 1}): the nearest-shift history of JAX's 9 selects, as one
    gather.  pad: rows of img above (and below) the pixels' rows."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    yy = torch.arange(pad, pad + ry.shape[0], device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    return img[torch.clamp(yy + ry, 0, h - 1), torch.clamp(xx + rx, 0, w - 1)]


def temporal_filter(color, normal, depth, mat_id, motion, hist_valid: bool,
                    p: DenoiseParams, reproj=None, *, hist_color=None,
                    hist_depth=None, hist_mat=None, bicubic: bool = False,
                    hist_count=None, row0: int = 0, full_h: int | None = None,
                    pad: int = 0):
    """One temporal accumulation pass.

    color/normal (H,W,3); depth (H,W); mat_id (H,W) i32; motion (H,W,2) uv
    offsets (prev - cur); hist_valid: host bool, False on the first frame.
    reproj: (hist_rgb, hist_depth, hist_mat, hist_count, ok) of the history
    resampled at uv + motion; without it the pass fetches from the float32
    history planes hist_color (H,W,3), hist_depth, hist_mat (and
    hist_count), by the bicubic gather when `bicubic`, else by the ±1 px
    shift stencil.

    With a count (reproj's, or hist_count) the blend is 1/N accumulation,
    alpha = max(1/(N+1), temporal_blend), and the pass returns (filtered,
    new_count); without one (hist_count=None and no reproj) it is the
    luma-weighted EMA and returns the filtered colour alone.

    Some rows of an image of full_h rows (a rank's band of the row-sharded
    frame): the H rows of normal, depth, mat_id, motion and reproj are
    image rows row0, row0 + 1, ...; color, which the neighbourhood clamp
    reads, and the stencil fetch's history planes carry `pad` (1) rows on
    each side of them (the image's edge rows repeated beyond its edges).
    The result is the H rows.  row0 0, pad 0 and full_h None are the whole
    image."""
    h, w = normal.shape[0], normal.shape[1]
    full_h = h if full_h is None else full_h
    if pad and bicubic:
        raise ValueError("the bicubic history fetch takes the whole image")
    if pad not in (0, 1):
        raise ValueError(f"pad={pad}: the pass reads 1 row on each side")
    prev_uv = _uv_grid(h, w, color.device, row0, full_h) + motion
    ext, color = color, crop_rows(color, pad)
    counted = reproj is not None or hist_count is not None

    # --- history fetch ---
    if reproj is not None:
        hist, hd, hist_mat_s, n_prev_raw, small_motion = reproj
    elif bicubic:
        hist = bicubic_catmull_rom_sample(hist_color, prev_uv)
        # nearest texel; the integer cast truncates toward zero, as JAX's
        hx = torch.clamp((prev_uv[..., 0] * w).to(torch.int64), 0, w - 1)
        hy = torch.clamp((prev_uv[..., 1] * h).to(torch.int64), 0, h - 1)
        hist_mat_s = hist_mat[hy, hx]
        hd = hist_depth[hy, hx]
        if counted:
            n_prev_raw = hist_count[hy, hx]
        small_motion = None
    else:
        mx, my = motion[..., 0] * w, motion[..., 1] * full_h  # pixels
        small_motion = (torch.abs(mx) <= 1.0) & (torch.abs(my) <= 1.0)
        fx = torch.clamp(mx, -1.0, 1.0)
        fy = torch.clamp(my, -1.0, 1.0)
        # separable bilinear weights over the shifts {-1, 0, +1}
        wx = [torch.clamp(1.0 - torch.abs(fx - s), min=0.0) for s in _SHIFTS]
        wy = [torch.clamp(1.0 - torch.abs(fy - s), min=0.0) for s in _SHIFTS]
        hist = 0.0
        for iy, sy in enumerate(_SHIFTS):
            for ix, sx in enumerate(_SHIFTS):
                wgt = (wy[iy] * wx[ix])[..., None]
                tap = crop_rows(shifted(hist_color, sy, sx), pad)
                hist = hist + wgt * tap
        # nearest shift for material, depth and count (round half to even)
        rx = torch.round(fx).to(torch.int64)
        ry = torch.round(fy).to(torch.int64)
        hist_mat_s = _shift_pick(hist_mat, ry, rx, pad)
        hd = _shift_pick(hist_depth, ry, rx, pad)
        if counted:
            n_prev_raw = _shift_pick(hist_count, ry, rx, pad)

    # --- neighbourhood min/max clamp in YCoCg ---
    taps, _ = neighborhood(rgb_to_ycocg(ext), 1)  # (9,H,W,3)
    box_min = crop_rows(taps.amin(0), pad)
    box_max = crop_rows(taps.amax(0), pad)
    center = 0.5 * (box_min + box_max)
    extent = 0.5 * (box_max - box_min) * p.anti_flicker + 1e-4
    clamped = torch.minimum(torch.maximum(rgb_to_ycocg(hist),
                                          center - extent), center + extent)
    hist = ycocg_to_rgb(clamped)

    # --- history validity ---
    in_bounds = ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0))
    if small_motion is not None:
        in_bounds = in_bounds & small_motion
    mat_ok = hist_mat_s == mat_id
    fin, hfin = torch.isfinite(depth), torch.isfinite(hd)
    depth_ok = torch.where(
        fin & hfin,
        torch.abs(hd - depth)
        <= p.sigma_depth * torch.clamp(depth, min=1.0) * 4.0 + 1e-3,
        ~fin & ~hfin)  # both sky is fine
    ok = in_bounds & mat_ok & depth_ok & hist_valid

    # --- blend ---
    if counted:
        n_prev = torch.where(ok, n_prev_raw, 0.0)
        alpha = torch.clamp(1.0 / (n_prev + 1.0), min=p.temporal_blend)
        alpha = torch.where(ok, alpha, 1.0)
        out = color * alpha[..., None] + hist * (1.0 - alpha[..., None])
        new_count = torch.clamp(n_prev + 1.0, max=count_cap(p))
        return out, new_count
    # luma-weighted EMA: darker pixels get more history
    blend = torch.clamp(p.temporal_blend * (1.0 + luminance(color) * 0.5),
                        0.0, 1.0)
    blend = torch.where(ok, blend, 1.0)[..., None]
    return color * blend + hist * (1.0 - blend)


def tile_noise_level(color, depth, tile: int = 8):
    """Per-tile luminance relative variance, scaled by the non-sky ratio.
    Returns (H//tile, W//tile)."""
    lum = luminance(color)
    not_sky = torch.isfinite(depth).to(torch.float32)
    mean = box_pool(lum, tile)
    meansq = box_pool(lum * lum, tile)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    ratio = box_pool(not_sky, tile)
    return var / torch.clamp(mean * mean, min=1e-4) * ratio


def tile_noise_downsample(noise):
    """8x8 -> 16x16 tile noise (2x2 average)."""
    return box_pool(noise, 2)


def noise_level_visualize(img, noise, threshold, tile: int = 8):
    """Debug overlay: tiles whose noise exceeds `threshold` tinted orange
    (half the image, half [1, 0.5, 0.1]); img (H,W,3), noise the tile map
    (edge-padded where the tiles do not cover the image)."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    ys = torch.clamp(torch.arange(h, device=dev) // tile,
                     max=noise.shape[0] - 1)
    xs = torch.clamp(torch.arange(w, device=dev) // tile,
                     max=noise.shape[1] - 1)
    up = noise.index_select(0, ys).index_select(1, xs)
    mask = (up > threshold)[..., None]
    tint = device_const((1.0, 0.5, 0.1), img.device)
    return torch.where(mask, img * 0.5 + tint * 0.5, img)
