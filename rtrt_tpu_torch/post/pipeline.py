"""Post-processing chain: pyramid -> exposure -> bloom -> lens flare ->
tail (port of rtrt_tpu/post/pipeline.py::postprocess).

At the screen size the tail (tone map, sharpen, dither, u8) is the fused
kernel K3.  Below it, as in the JAX module, the tone map runs at render
size and a Catmull-Rom upscale takes the LDR image to the screen (torch
ops); K3's pre-mapped instantiation then sharpens, dithers and quantizes
at screen size.
"""

from __future__ import annotations

import torch

from ..ops.resize import downsample4, upscale_catmull_rom
from ..render.sampling import _to_unit_float, blue_noise_mask, hash_pcg, u32
from ..utils.config import FeatureFlags, PostParams
from .bloom import bloom
from .exposure import auto_exposure
from .lensflare import lens_flare
from .tail import post_tail, tail_params
from .tonemap import tonemap


def dither_mask(device) -> torch.Tensor:
    """The (64, 64) blue-noise dither mask as a float32 tensor."""
    return torch.from_numpy(blue_noise_mask()[:, :, 0].copy()).to(device)


def postprocess(color, exposure_state, dt, sun_uv, sun_visible,
                p: PostParams, flags: FeatureFlags, out_h: int, out_w: int,
                frame_idx: int, mask=None):
    """color: (H,W,3) linear radiance at render size; sun_uv (2,) the sun's
    screen position and sun_visible a 0-d 0/1 tensor (lens flare only).
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
        bright = exposure_state[2]
    else:
        ev = torch.tensor(p.manual_exposure, dtype=torch.float32,
                          device=color.device)
        bright = 2.0 / torch.clamp(ev, min=1e-6)

    if flags.bloom:
        color = bloom(color, bright, p.bloom_strength)
    if flags.lens_flare:
        color = color + lens_flare(h, w, sun_uv, sun_visible,
                                   p.flare_strength) \
            / torch.clamp(ev, min=1e-6)

    fshift = float(_to_unit_float(hash_pcg(u32(frame_idx))))
    if mask is None:
        mask = dither_mask(color.device)
    params = tail_params(ev, p.tone_map, p.gamma, p.sharpen_amount, fshift,
                         color.device)
    mapped = (out_h, out_w) != (h, w)
    if mapped:
        # tone map and gamma at render size from the device-side params
        # (no host copy), then the upscale to the screen, clamped
        ldr = tonemap(color * params[0], params[1], params[2])
        color = torch.clamp(upscale_catmull_rom(ldr, out_h, out_w), 0.0,
                            1.0)
    u8 = post_tail(color.contiguous(), params, mask,
                   do_sharpen=flags.sharpen, do_dither=flags.dither,
                   mapped=mapped)
    return u8, exposure_state
