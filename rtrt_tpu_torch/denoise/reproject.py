"""History reprojection at uv + motion — kernel K5 and its plain twin (port
of rtrt_tpu/denoise/reproject.py: `reproject_gather`, the function the JAX
package's Pallas tile-shift kernel `_reproject_kernel` computes on every
lane it resolves).

Per pixel, the history sample sits at (y + motion_y * h, x + motion_x * w):
  * colour and colour2: 16-tap Catmull-Rom (a = -1/2) at that point, taps
    -1..2 around its floor, indices clamped to the image, weights
    (wy * wx) * img summed ky outer, kx inner;
  * depth, count, material id: nearest (round half to even), clamped;
  * ok: the point lies inside [0, h-1] x [0, w-1].

`reproject` launches, for CUDA tensors, K5 (csrc/reproject.cu), which reads
bfloat16 history directly and widens it in registers (widening is exact,
so the function is unchanged); for CPU tensors it widens the history and
runs `reproject_plain`.  The TPU kernel's extra ok=False where a lane's
motion falls outside its tile's window is an artifact of the windowed DMA
and is not carried over.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import cuda


class Reprojection(NamedTuple):
    """History resampled at uv + motion for every pixel (float32; garbage
    where ~ok)."""

    color: torch.Tensor    # (H,W,3) Catmull-Rom pass-1 history
    color2: torch.Tensor   # (H,W,3) Catmull-Rom pass-2 history
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


def reproject_plain(color, color2, depth, mat_id, count, motion
                    ) -> Reprojection:
    """Per-pixel gather form on float32 history (the XLA function of the
    JAX package's reproject_gather)."""
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
    taps = (-1, 0, 1, 2)

    def resample(img):
        acc = 0.0
        for ky in taps:
            yi = torch.clamp(y0i + ky, 0, h - 1)
            wy = _w_catmull_rom(fy - ky)[..., None]
            for kx in taps:
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


def reproject(color, color2, depth, mat_id, count, motion) -> Reprojection:
    """Resample the history set (colour, colour2 (H,W,3); depth, count
    (H,W), all bfloat16 or all float32; mat_id (H,W) int32) at uv + motion
    ((H,W,2) float32).  CPU tensors run the plain version on the widened
    history; CUDA tensors launch K5."""
    if color.device.type == "cpu":
        f = lambda x: x.to(torch.float32)
        return reproject_plain(f(color), f(color2), f(depth), mat_id,
                               f(count), motion)
    dev = color.device
    h, w = depth.shape
    dt = color.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K5 takes bfloat16 or float32 history, got {dt}")
    cuda.check_tensors(dev, color=(color, dt, (h, w, 3)),
                       color2=(color2, dt, (h, w, 3)),
                       depth=(depth, dt, (h, w)),
                       count=(count, dt, (h, w)),
                       mat_id=(mat_id, torch.int32, (h, w)),
                       motion=(motion, torch.float32, (h, w, 2)))
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    out = Reprojection(color=f32(h, w, 3), color2=f32(h, w, 3),
                       depth=f32(h, w),
                       mat_id=torch.empty((h, w), dtype=torch.int32,
                                          device=dev),
                       count=f32(h, w),
                       ok=torch.empty((h, w), dtype=torch.bool, device=dev))
    cuda.launch(cuda.library().rtrt_reproject, "reproject", dev,
                color, color2, depth, count, mat_id, motion, ctypes.c_int(h),
                ctypes.c_int(w), ctypes.c_int(int(dt == torch.bfloat16)),
                out.color, out.color2, out.depth, out.count, out.mat_id,
                out.ok)
    return out
