"""The SVGF-style denoising chain (port of rtrt_tpu/denoise/pipeline.py):

    reproject history (K5) -> TemporalFilter -> tile noise 8
    -> SpatialFilter7x7 (K4) -> history colour -> tile noise 16
    -> 3x SpatialFilterGlobal5x5 at strides 3/6/12 (K4) -> x albedo
    -> TemporalFilter2 -> history colour2

`reproject_mode="gather"` (the default, the function the JAX frame runs off
the TPU) resamples the history at uv + motion with K5 (or its plain
version on the CPU) when FeatureFlags.temporal_filter is on; "stencil"
skips the reprojection and both temporal passes fetch their history with
the ±1 px shift stencil (denoise/temporal.py).  With temporal_filter off
the second pass takes the stencil too, as in JAX.  The JAX package's
"tile_shift" mode is its TPU kernel, whose function K5 computes as
"gather"; any other mode raises ValueError.

History is stored as bfloat16 when FeatureFlags.half_history is on (the
default); all filter math runs in float32.  `valid` is a host bool (False
only on the first frame), so no device scalar and no host sync is needed.

With a band (a rank of the row-sharded frame, parallel/frame_spmd.py) the
planes and the history are the band's rows [r0, r1) of the image, and the
chain computes the same rows of the whole image's chain: K5 resamples the
band's rows from the whole history, each stencil reads the whole image's
planes of its input (one all-gather a stage: the G-buffer and history,
then the colour after the first temporal pass and each spatial pass),
and the tile-noise maps are the whole image's, computed on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.resize import box_pool
from ..utils.config import DenoiseParams, FeatureFlags
from ..utils.debug import nan_guard
from .reproject import reproject
from .spatial import spatial_filter_7x7, spatial_filter_wide
from .temporal import temporal_filter, tile_noise_downsample, tile_noise_level


REPROJECT_MODES = ("gather", "stencil")


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
            frame_parity: int = 0, reproject_mode: str = "gather",
            band=None, out: DenoiseHistory | None = None):
    """Run the chain on demodulated radiance.  Returns
    (final colour with albedo, new history).  band: the rank's RowMesh
    when the planes and the history are its band's rows (module
    docstring).  out: a DenoiseHistory whose planes receive the new
    history's, in their own dtypes, after the chain's last read of
    `history` (they may be its own planes); the new history then holds
    them."""
    if reproject_mode not in REPROJECT_MODES:
        raise ValueError(f"reproject_mode={reproject_mode!r}: expected one "
                         f"of {REPROJECT_MODES}")
    # the kernels take dense planes; the G-buffer's are views of K2's
    # (18, H, W) output
    color, albedo, normal, depth, mat_id, motion = (
        x.contiguous() for x in (color, albedo, normal, depth, mat_id,
                                 motion))
    c = color
    hist_count = new_count = history.count.to(torch.float32)
    # the whole image's colour, geometry and history (a band's gathered)
    color_whole, geo, hist = color, (normal, depth, mat_id), history
    if band is not None:
        planes = [color, normal, depth, mat_id]
        if flags.temporal_filter or flags.second_temporal:
            planes += [history.color, history.color2, history.depth,
                       history.mat_id, history.count]
        g = band.gather(planes)
        color_whole, geo = g[0], tuple(g[1:4])
        if len(g) > 4:
            hist = history._replace(color=g[4], color2=g[5], depth=g[6],
                                    mat_id=g[7], count=g[8])

    # a stage's planes and where they lie: the whole image, or the band
    # with the k rows on each side of it that the stage's stencil reads
    # (`at`: the stage's keywords that say so)
    if band is None:
        whole, ext = (lambda x: x), (lambda x, k: x)
        at = lambda k: {}
        t_at = {}
    else:
        whole = lambda x: band.gather([x])[0]
        ext = band.extend
        at = lambda k: dict(row0=band.r0, pad=k)
        t_at = dict(at(1), full_h=band.h)

    rep1 = rep2 = None
    if flags.temporal_filter and reproject_mode == "gather":
        rep = reproject(hist.color, hist.color2, hist.depth, hist.mat_id,
                        hist.count, motion,
                        row0=0 if band is None else band.r0)
        rep1 = (rep.color, rep.depth, rep.mat_id, rep.count, rep.ok)
        rep2 = (rep.color2, rep.depth, rep.mat_id, rep.count, rep.ok)

    def fetch(hist_color):
        """The stencil fetch's float32 history planes (unused with a
        reprojection)."""
        f = lambda x: x.to(torch.float32)
        return dict(hist_color=f(ext(hist_color, 1)),
                    hist_depth=f(ext(hist.depth, 1)),
                    hist_mat=ext(hist.mat_id, 1),
                    hist_count=hist_count if band is None
                    else f(ext(hist.count, 1)))

    if flags.temporal_filter:
        kw = fetch(hist.color) if rep1 is None else {}
        c, new_count = temporal_filter(ext(color_whole, 1), normal, depth,
                                       mat_id, motion, history.valid, p,
                                       rep1, **kw, **t_at)

    # the noise estimate decays with accumulation (variance ~ 1/N)
    c_whole, count_whole = color_whole, None
    if band is None:
        c_whole, count_whole = c, new_count
    elif flags.temporal_filter:
        c_whole, count_whole = band.gather([c, new_count])
    noise8 = tile_noise_level(c_whole, geo[1], 8)
    if flags.temporal_filter:
        noise8 = noise8 / torch.clamp(box_pool(count_whole, 8), min=1.0)

    if flags.spatial_filter:
        c = spatial_filter_7x7(*(ext(x, 3) for x in (c_whole, *geo)),
                               noise8, p, frame_parity, **at(3))
    hist_color = c

    if flags.spatial_filter:
        c_whole = whole(c)
        noise16 = tile_noise_downsample(tile_noise_level(c_whole, geo[1], 8))
        for i, stride in enumerate((3, 6, 12)):
            k = 2 * stride  # the 5x5 pass's reach
            c = spatial_filter_wide(
                *(ext(x, k) for x in (c_whole if i == 0 else whole(c),
                                      *geo)), noise16, p, stride, **at(k))

    c = nan_guard(c * albedo, "denoise.remodulated")  # remodulate

    if flags.second_temporal:
        kw = fetch(hist.color2) if rep2 is None else {}
        c, _ = temporal_filter(ext(whole(c), 1), normal, depth, mat_id,
                               motion, history.valid, p, rep2, **kw, **t_at)

    planes = dict(color=hist_color, color2=c, depth=depth, mat_id=mat_id,
                  count=new_count)
    if out is not None:
        planes = {k: getattr(out, k).copy_(x) for k, x in planes.items()}
    elif flags.half_history:
        planes.update({k: planes[k].to(torch.bfloat16)
                       for k in ("color", "color2", "depth", "count")})
    return c, DenoiseHistory(valid=True, **planes)
