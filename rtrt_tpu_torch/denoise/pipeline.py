"""The SVGF-style denoising chain (port of rtrt_tpu/denoise/pipeline.py
with `reproject_mode="gather"`, the function the JAX frame runs off the
TPU):

    reproject history (K5) -> TemporalFilter -> tile noise 8
    -> SpatialFilter7x7 (K4) -> history colour -> tile noise 16
    -> 3x SpatialFilterGlobal5x5 at strides 3/6/12 (K4) -> x albedo
    -> TemporalFilter2 -> history colour2

History is stored as bfloat16 when FeatureFlags.half_history is on (the
default); all filter math runs in float32.  `valid` is a host bool (False
only on the first frame), so no device scalar and no host sync is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.resize import box_pool
from ..utils.config import DenoiseParams, FeatureFlags
from .reproject import reproject
from .spatial import spatial_filter_7x7, spatial_filter_wide
from .temporal import temporal_filter, tile_noise_downsample, tile_noise_level


class DenoiseHistory(NamedTuple):
    """Persistent history state + the accumulated sample count for 1/N
    temporal blending."""

    color: torch.Tensor    # (H,W,3) post-spatial accumulation (pass 1)
    color2: torch.Tensor   # (H,W,3) post-everything accumulation (pass 2)
    depth: torch.Tensor    # (H,W)
    mat_id: torch.Tensor   # (H,W) i32
    valid: bool            # False on the first frame
    count: torch.Tensor    # (H,W) accumulated samples


def init_history(h: int, w: int, half: bool = True,
                 device="cuda") -> DenoiseHistory:
    """Empty history; half=True stores colour/colour2/depth/count as
    bfloat16 (FeatureFlags.half_history)."""
    dt = torch.bfloat16 if half else torch.float32
    return DenoiseHistory(
        color=torch.zeros((h, w, 3), dtype=dt, device=device),
        color2=torch.zeros((h, w, 3), dtype=dt, device=device),
        depth=torch.full((h, w), float("inf"), dtype=dt, device=device),
        mat_id=torch.full((h, w), -1, dtype=torch.int32, device=device),
        valid=False,
        count=torch.zeros((h, w), dtype=dt, device=device))


def denoise(color, albedo, normal, depth, mat_id, motion,
            history: DenoiseHistory, p: DenoiseParams, flags: FeatureFlags,
            frame_parity: int = 0):
    """Run the chain on demodulated radiance.  Returns
    (final colour with albedo, new history)."""
    # the kernels take dense planes; the G-buffer's are views of K2's
    # (18, H, W) output
    color, albedo, normal, depth, mat_id, motion = (
        x.contiguous() for x in (color, albedo, normal, depth, mat_id,
                                 motion))
    c = color
    new_count = history.count.to(torch.float32)
    rep1 = rep2 = None
    if flags.temporal_filter:
        rep = reproject(history.color, history.color2, history.depth,
                        history.mat_id, history.count, motion)
        rep1 = (rep.color, rep.depth, rep.mat_id, rep.count, rep.ok)
        rep2 = (rep.color2, rep.depth, rep.mat_id, rep.count, rep.ok)
        c, new_count = temporal_filter(c, normal, depth, mat_id, motion,
                                       history.valid, p, rep1)

    # the noise estimate decays with accumulation (variance ~ 1/N)
    noise8 = tile_noise_level(c, depth, 8)
    if flags.temporal_filter:
        noise8 = noise8 / torch.clamp(box_pool(new_count, 8), min=1.0)

    if flags.spatial_filter:
        c = spatial_filter_7x7(c, normal, depth, mat_id, noise8, p,
                               frame_parity)
    hist_color = c

    if flags.spatial_filter:
        noise16 = tile_noise_downsample(tile_noise_level(c, depth, 8))
        for stride in (3, 6, 12):
            c = spatial_filter_wide(c, normal, depth, mat_id, noise16, p,
                                    stride)

    c = c * albedo  # remodulate

    if flags.second_temporal:
        if rep2 is None:
            raise NotImplementedError(
                "FeatureFlags.second_temporal without temporal_filter needs "
                "the ±1 px stencil history fetch, which is not ported to "
                "rtrt_tpu_torch yet (see ROADMAP.md)")
        c, _ = temporal_filter(c, normal, depth, mat_id, motion,
                               history.valid, p, rep2)

    store = (lambda x: x.to(torch.bfloat16)) if flags.half_history \
        else (lambda x: x)
    new_history = DenoiseHistory(
        color=store(hist_color), color2=store(c), depth=store(depth),
        mat_id=mat_id, valid=True, count=store(new_count))
    return c, new_history
