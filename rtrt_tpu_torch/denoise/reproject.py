"""History reprojection at uv + motion — kernel K5 and its plain twin (port
of rtrt_tpu/denoise/reproject.py: `reproject_gather`, the function the JAX
package's Pallas tile-shift kernel `_reproject_kernel` computes on every
lane it resolves).

Per pixel, the history sample sits at (y + motion_y * h, x + motion_x * w):
  * colour and colour2: by the history filter, indices clamped to the
    image, weights (wy * wx) * img summed ky outer, kx inner —
    "catmull_rom" (the default): 16 Catmull-Rom (a = -1/2) taps -1..2
    around the point's floor; "bilinear": the 4 taps 0..1, weights
    max(0, 1 - |d|);
  * depth, count, material id: nearest (round half to even), clamped;
  * ok: the point lies inside [0, h-1] x [0, w-1].

HISTORY_FILTER is RTRT_HISTORY_FILTER at import ("catmull_rom" unset), the
JAX package's switch; `reproject` and `reproject_plain` read it when their
`history_filter` is None.  Another value raises ValueError where JAX
quietly takes bilinear weights over the Catmull-Rom taps.

Band form (`row0`): the history is the whole (h, w) image and the motion
(rows, w) covers image rows [row0, row0 + rows); the result has the
motion's rows, each equal to the same row of the whole image's result.
A rank of the row-sharded frame (parallel/frame_spmd.py) reprojects its
own rows so.

`reproject` launches, for CUDA tensors, K5 (csrc/reproject.cu; one
instantiation per history dtype and filter), which reads bfloat16 history
directly and widens it in registers (widening is exact, so the function is
unchanged); for CPU tensors it widens the history and runs
`reproject_plain`.  The TPU kernel's extra ok=False where a lane's
motion falls outside its tile's window is an artifact of the windowed DMA
and is not carried over.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ..utils import cuda


HISTORY_FILTERS = ("catmull_rom", "bilinear")  # K5's filter argument
HISTORY_FILTER = os.environ.get("RTRT_HISTORY_FILTER", "catmull_rom")


class Reprojection(NamedTuple):
    """History resampled at uv + motion for every pixel (float32; garbage
    where ~ok)."""

    color: torch.Tensor    # (H,W,3) pass-1 history, by the filter
    color2: torch.Tensor   # (H,W,3) pass-2 history, by the filter
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


def _w_bilinear(d):
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _filter(history_filter):
    """The history filter's name (None: HISTORY_FILTER); another name than
    those of HISTORY_FILTERS raises ValueError."""
    f = HISTORY_FILTER if history_filter is None else history_filter
    if f not in HISTORY_FILTERS:
        raise ValueError(f"history filter {f!r} (RTRT_HISTORY_FILTER): "
                         f"expected one of {HISTORY_FILTERS}")
    return f


def reproject_plain(color, color2, depth, mat_id, count, motion,
                    history_filter: str | None = None,
                    row0: int = 0) -> Reprojection:
    """Per-pixel gather form on float32 history (the XLA function of the
    JAX package's reproject_gather); the motion's rows are image rows
    row0, row0 + 1, ..."""
    bilinear = _filter(history_filter) == "bilinear"
    h, w = depth.shape
    dev = depth.device
    rows = motion.shape[0]
    yy, xx = torch.meshgrid(torch.arange(row0, row0 + rows,
                                         dtype=torch.float32, device=dev),
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
    taps = (0, 1) if bilinear else (-1, 0, 1, 2)
    weight = _w_bilinear if bilinear else _w_catmull_rom

    def resample(img):
        acc = 0.0
        for ky in taps:
            yi = torch.clamp(y0i + ky, 0, h - 1)
            wy = weight(fy - ky)[..., None]
            for kx in taps:
                xi = torch.clamp(x0i + kx, 0, w - 1)
                wx = weight(fx - kx)[..., None]
                acc = acc + wy * wx * img[yi, xi]
        return acc

    nyi = torch.clamp(torch.round(yh).to(torch.int64), 0, h - 1)
    nxi = torch.clamp(torch.round(xh).to(torch.int64), 0, w - 1)
    ok = (yh >= 0.0) & (yh <= h - 1.0) & (xh >= 0.0) & (xh <= w - 1.0)
    return Reprojection(
        color=resample(color), color2=resample(color2),
        depth=depth[nyi, nxi], mat_id=mat_id[nyi, nxi],
        count=count[nyi, nxi], ok=ok)


def reproject(color, color2, depth, mat_id, count, motion,
              history_filter: str | None = None,
              row0: int = 0) -> Reprojection:
    """Resample the history set (colour, colour2 (H,W,3); depth, count
    (H,W), all bfloat16 or all float32; mat_id (H,W) int32) at uv + motion
    ((rows,W,2) float32, image rows row0 .. row0 + rows - 1; the whole
    image by default) with the history filter (None: HISTORY_FILTER).  CPU
    tensors run the plain version on the widened history; CUDA tensors
    launch K5's instantiation of the filter, its band instantiation where
    the rows are not the whole image (counted apart: "_band")."""
    filt = _filter(history_filter)
    h, w = depth.shape
    rows = motion.shape[0]
    if row0 < 0 or row0 + rows > h:
        raise ValueError(f"rows [{row0}, {row0 + rows}) leave the history's "
                         f"{h} rows")
    if color.device.type == "cpu":
        f = lambda x: x.to(torch.float32)
        return reproject_plain(f(color), f(color2), f(depth), mat_id,
                               f(count), motion, filt, row0)
    dev = color.device
    dt = color.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K5 takes bfloat16 or float32 history, got {dt}")
    cuda.check_tensors(dev, color=(color, dt, (h, w, 3)),
                       color2=(color2, dt, (h, w, 3)),
                       depth=(depth, dt, (h, w)),
                       count=(count, dt, (h, w)),
                       mat_id=(mat_id, torch.int32, (h, w)),
                       motion=(motion, torch.float32, (rows, w, 2)))
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    out = Reprojection(color=f32(rows, w, 3), color2=f32(rows, w, 3),
                       depth=f32(rows, w),
                       mat_id=torch.empty((rows, w), dtype=torch.int32,
                                          device=dev),
                       count=f32(rows, w),
                       ok=torch.empty((rows, w), dtype=torch.bool,
                                      device=dev))
    name = "reproject_bilinear" if filt == "bilinear" else "reproject"
    if rows != h:
        name += "_band"
    cuda.launch(cuda.library().rtrt_reproject, name,
                dev, color, color2, depth, count, mat_id, motion,
                ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(row0),
                ctypes.c_int(rows), ctypes.c_int(int(dt == torch.bfloat16)),
                ctypes.c_int(HISTORY_FILTERS.index(filt)), out.color,
                out.color2, out.depth, out.count, out.mat_id, out.ok)
    return out
