# Frozen copy of rtrt_tpu_torch/post/pipeline.py
# (framebench's plain reference).
"""Post-processing chain: pyramid -> exposure -> bloom -> lens flare ->
tail (port of rtrt_tpu/post/pipeline.py::postprocess), at the screen size,
where the tail (tone map, sharpen, dither, u8) is K3's function.
"""

from __future__ import annotations

import torch

from ..ops.resize import downsample4
from ..render.sampling import _to_unit_float, blue_noise_mask, hash_pcg, u32
from ..utils.config import FeatureFlags, PostParams
from .bloom import bloom
from .exposure import auto_exposure
from .lensflare import lens_flare
from .tail import post_tail, tail_params


def dither_mask(device) -> torch.Tensor:
    """The (64, 64) blue-noise dither mask as a float32 tensor."""
    return torch.from_numpy(blue_noise_mask()[:, :, 0].copy()).to(device)


def postprocess(color, exposure_state, dt, sun_uv, sun_visible,
                p: PostParams, flags: FeatureFlags, frame_idx: int, mask):
    """color: (H,W,3) linear radiance at the screen size; sun_uv (2,) the
    sun's screen position and sun_visible a 0-d 0/1 tensor (lens flare
    only); mask the (64, 64) dither mask.  Returns (u8 image (H, W, 3), new
    exposure state)."""
    h, w = color.shape[0], color.shape[1]
    small = color
    for _ in range(3):
        if min(small.shape[0], small.shape[1]) >= 8:
            small = downsample4(small)
    exposure_state = auto_exposure(small, exposure_state, dt,
                                   p.exposure_gain)
    ev = exposure_state[0]
    bright = exposure_state[2]
    color = bloom(color, bright, p.bloom_strength)
    color = color + lens_flare(h, w, sun_uv, sun_visible,
                               p.flare_strength) / torch.clamp(ev, min=1e-6)
    fshift = float(_to_unit_float(hash_pcg(u32(frame_idx))))
    params = tail_params(ev, p.tone_map, p.gamma, p.sharpen_amount, fshift,
                         color.device)
    u8 = post_tail(color.contiguous(), params, mask,
                   do_sharpen=flags.sharpen, do_dither=flags.dither)
    return u8, exposure_state
