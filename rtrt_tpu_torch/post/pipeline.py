"""Post-processing chain: pyramid -> exposure -> tail (port of
rtrt_tpu/post/pipeline.py::postprocess).

Bloom, lens flare and the render-to-screen upscale are not ported yet
(ROADMAP.md): they raise NotImplementedError rather than being skipped.
The sun's screen position and visibility, which only the lens flare reads,
are therefore not taken.
"""

from __future__ import annotations

import torch

from ..ops.resize import downsample4
from ..render.sampling import _to_unit_float, blue_noise_mask, hash_pcg, u32
from ..utils.config import FeatureFlags, PostParams
from .exposure import auto_exposure
from .tail import post_tail, tail_params


def dither_mask(device) -> torch.Tensor:
    """The (64, 64) blue-noise dither mask as a float32 tensor."""
    return torch.from_numpy(blue_noise_mask()[:, :, 0].copy()).to(device)


def postprocess(color, exposure_state, dt, p: PostParams,
                flags: FeatureFlags, out_h: int, out_w: int, frame_idx: int,
                mask=None):
    """color: (H,W,3) linear radiance at render size.
    Returns (u8 image (out_h, out_w, 3), new exposure state)."""
    h, w = color.shape[0], color.shape[1]
    small = color
    for _ in range(3):
        if min(small.shape[0], small.shape[1]) >= 8:
            small = downsample4(small)
    if flags.auto_exposure:
        exposure_state = auto_exposure(small, exposure_state, dt,
                                       p.exposure_gain)
        ev = exposure_state[0]
    else:
        ev = p.manual_exposure

    if flags.bloom:
        raise NotImplementedError(
            "FeatureFlags.bloom is not ported yet (see ROADMAP.md); "
            "use FeatureFlags(bloom=False)")
    if flags.lens_flare:
        raise NotImplementedError(
            "FeatureFlags.lens_flare is not ported yet (see ROADMAP.md); "
            "use FeatureFlags(lens_flare=False)")
    if (out_h, out_w) != (h, w):
        raise NotImplementedError(
            f"output upscale {w}x{h} -> {out_w}x{out_h} is not ported yet "
            "(see ROADMAP.md); render at the output size")

    fshift = float(_to_unit_float(hash_pcg(u32(frame_idx))))
    if mask is None:
        mask = dither_mask(color.device)
    params = tail_params(ev, p.tone_map, p.gamma, p.sharpen_amount, fshift,
                         color.device)
    u8 = post_tail(color.contiguous(), params, mask,
                   do_sharpen=flags.sharpen, do_dither=flags.dither)
    return u8, exposure_state
