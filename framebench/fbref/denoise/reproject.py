# Frozen copy of rtrt_tpu_torch/denoise/reproject.py
# (framebench's plain reference), cut to what framebench's frames reach.
"""History reprojection at uv + motion — K5's plain twin (port of
rtrt_tpu/denoise/reproject.py: `reproject_gather`, the function the JAX
package's Pallas tile-shift kernel `_reproject_kernel` computes on every
lane it resolves).

Per pixel, the history sample sits at (y + motion_y * h, x + motion_x * w):
  * colour and colour2: 16 Catmull-Rom (a = -1/2) taps -1..2 around the
    point's floor, indices clamped to the image, weights (wy * wx) * img
    summed ky outer, kx inner (the port's default history filter);
  * depth, count, material id: nearest (round half to even), clamped;
  * ok: the point lies inside [0, h-1] x [0, w-1].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Reprojection(NamedTuple):
    """History resampled at uv + motion for every pixel (float32; garbage
    where ~ok)."""

    color: torch.Tensor    # (H,W,3) pass-1 history
    color2: torch.Tensor   # (H,W,3) pass-2 history
    depth: torch.Tensor    # (H,W)   nearest
    mat_id: torch.Tensor   # (H,W)   nearest i32
    count: torch.Tensor    # (H,W)   nearest accumulation count
    ok: torch.Tensor       # (H,W)   bool: sample point inside the image


def _w_catmull_rom(d):
    """1-D Catmull-Rom kernel (a = -1/2), support |d| < 2."""
    t = torch.abs(d)
    inner = (1.5 * t - 2.5) * t * t + 1.0
    outer = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    return torch.where(t <= 1.0, inner, torch.where(t < 2.0, outer, 0.0))


def reproject(color, color2, depth, mat_id, count, motion) -> Reprojection:
    """Resample the history set (colour, colour2 (H,W,3); depth, count
    (H,W); mat_id (H,W) int32), widened to float32, at uv + motion
    ((H,W,2) float32)."""
    f = lambda x: x.to(torch.float32)
    color, color2, depth, count = f(color), f(color2), f(depth), f(count)
    h, w = depth.shape
    dev = depth.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    yh = yy + motion[..., 1] * h
    xh = xx + motion[..., 0] * w
    y0f = torch.floor(yh)
    x0f = torch.floor(xh)
    fy = yh - y0f
    fx = xh - x0f
    y0i = y0f.to(torch.int64)
    x0i = x0f.to(torch.int64)

    def resample(img):
        acc = 0.0
        for ky in (-1, 0, 1, 2):
            yi = torch.clamp(y0i + ky, 0, h - 1)
            wy = _w_catmull_rom(fy - ky)[..., None]
            for kx in (-1, 0, 1, 2):
                xi = torch.clamp(x0i + kx, 0, w - 1)
                wx = _w_catmull_rom(fx - kx)[..., None]
                acc = acc + wy * wx * img[yi, xi]
        return acc

    nyi = torch.clamp(torch.round(yh).to(torch.int64), 0, h - 1)
    nxi = torch.clamp(torch.round(xh).to(torch.int64), 0, w - 1)
    ok = (yh >= 0.0) & (yh <= h - 1.0) & (xh >= 0.0) & (xh <= w - 1.0)
    return Reprojection(
        color=resample(color), color2=resample(color2),
        depth=depth[nyi, nxi], mat_id=mat_id[nyi, nxi],
        count=count[nyi, nxi], ok=ok)
