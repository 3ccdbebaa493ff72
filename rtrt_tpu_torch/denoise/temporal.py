"""Temporal reprojection filter (port of rtrt_tpu/denoise/temporal.py:
`temporal_filter` on pre-reprojected history, the tile noise estimate).

The history arrives resampled at uv + motion by denoise/reproject.py (K5 or
its plain version); the JAX module's in-function ±1 px shift-stencil and
bicubic history fetches are not on the product path and are not ported
(ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.color import luminance, rgb_to_ycocg, ycocg_to_rgb
from ..ops.resize import box_pool
from ..ops.stencil import neighborhood
from ..utils.config import DenoiseParams


def _uv_grid(h, w, device):
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)  # (H,W,2)


def count_cap(p: DenoiseParams) -> float:
    """1 / max(temporal_blend, 1e-3), rounded as float32 arithmetic."""
    return float(np.float32(1.0) / np.maximum(np.float32(p.temporal_blend),
                                              np.float32(1e-3)))


def temporal_filter(color, normal, depth, mat_id, motion, hist_valid: bool,
                    p: DenoiseParams, reproj):
    """One temporal accumulation pass with 1/N blending.

    color/normal (H,W,3); depth (H,W); mat_id (H,W) i32; motion (H,W,2) uv
    offsets (prev - cur); hist_valid: host bool, False on the first frame;
    reproj: (hist_rgb, hist_depth, hist_mat, hist_count, ok) of the history
    resampled at uv + motion.  Returns (filtered, new_count)."""
    h, w = color.shape[0], color.shape[1]
    prev_uv = _uv_grid(h, w, color.device) + motion
    hist, hd, hist_mat_s, n_prev_raw, rep_ok = reproj

    # neighbourhood min/max clamp in YCoCg
    taps, _ = neighborhood(rgb_to_ycocg(color), 1)  # (9,H,W,3)
    box_min = taps.amin(0)
    box_max = taps.amax(0)
    center = 0.5 * (box_min + box_max)
    extent = 0.5 * (box_max - box_min) * p.anti_flicker + 1e-4
    clamped = torch.minimum(torch.maximum(rgb_to_ycocg(hist),
                                          center - extent), center + extent)
    hist = ycocg_to_rgb(clamped)

    # history validity
    in_bounds = ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0)
                 & rep_ok)
    mat_ok = hist_mat_s == mat_id
    fin, hfin = torch.isfinite(depth), torch.isfinite(hd)
    depth_ok = torch.where(
        fin & hfin,
        torch.abs(hd - depth)
        <= p.sigma_depth * torch.clamp(depth, min=1.0) * 4.0 + 1e-3,
        ~fin & ~hfin)  # both sky is fine
    ok = in_bounds & mat_ok & depth_ok & hist_valid

    # blend
    n_prev = torch.where(ok, n_prev_raw, 0.0)
    alpha = torch.clamp(1.0 / (n_prev + 1.0), min=p.temporal_blend)
    alpha = torch.where(ok, alpha, 1.0)
    out = color * alpha[..., None] + hist * (1.0 - alpha[..., None])
    new_count = torch.clamp(n_prev + 1.0, max=count_cap(p))
    return out, new_count


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
