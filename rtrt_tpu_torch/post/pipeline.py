"""Post-processing chain: pyramid -> exposure -> bloom -> lens flare ->
tail (port of rtrt_tpu/post/pipeline.py::postprocess).

At the screen size the tail (tone map, sharpen, dither, u8) is the fused
kernel K3.  Below it, as in the JAX module, the tone map runs at render
size and a Catmull-Rom upscale takes the LDR image to the screen (torch
ops); K3's pre-mapped instantiation then sharpens, dithers and quantizes
at screen size.

A rank of the row-sharded frame (parallel/frame_spmd.py) post-processes
its band: the pyramid, the exposure and the bloom's blurs take the whole
image (one all-gather of the denoised colour), so every rank holds the
same exposure state; bloom and the lens flare run on the band's render
rows and the rows around them that K3's 3x3 sharpen reads (1 row; below
the screen size those of the Catmull-Rom upscale, 2 + h / screen_h), and
K3 runs on the band's screen rows with one row on each side, cropped.
K3's dither reads its mask at the launch's own row mod 64, so the band's
mask comes rolled by the launch's first screen row (FrameConsts.mask,
engine/frame.py::make_frame_consts): no kernel change.
"""

from __future__ import annotations

import torch

from ..ops.resize import downsample4, upscale_catmull_rom
from ..ops.stencil import crop_rows
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


def band_halo(h: int, out_h: int) -> int:
    """Render rows that a band's post chain reads beyond the band on each
    side: the sharpen's row, or below the screen size the upscale's."""
    return 1 if out_h == h else 2 + -(-h // out_h)


def upscale_band(ldr, band, out_h: int, out_w: int, margin: int = 0):
    """The band's screen rows [s0 - margin, s1 + margin) (clamped to the
    screen; margin <= 1) of the whole render image's Catmull-Rom upscale,
    clamped to [0, 1].  ldr: the band's render rows with band_halo(band.h,
    out_h) rows on each side (band.extend of the whole image)."""
    k = band_halo(band.h, out_h)
    return torch.clamp(upscale_catmull_rom(
        ldr, out_h, out_w, out_rows=(band.s0 - margin, band.s1 + margin),
        row0=band.r0 - k, in_h=band.h), 0.0, 1.0)


def postprocess(color, exposure_state, dt, sun_uv, sun_visible,
                p: PostParams, flags: FeatureFlags, out_h: int, out_w: int,
                frame_idx, mask=None, band=None):
    """color: (H,W,3) linear radiance at render size; sun_uv (2,) the sun's
    screen position and sun_visible a 0-d 0/1 tensor (lens flare only).
    frame_idx: an int, or an integer tensor of one element holding the
    uint32 frame index, whose dither shift is then hashed on the device;
    dt: a float or a 0-d float32 tensor.
    Returns (u8 image (out_h, out_w, 3), new exposure state).  band: the
    rank's RowMesh when color is its band's render rows; the image is then
    the band's screen rows (module docstring)."""
    h, w = color.shape[0], color.shape[1]
    whole, row0, n = color, 0, None  # color: image rows row0 .. + n
    if band is not None:
        h = band.h
        k = band_halo(h, out_h)
        whole = band.gather([color])[0]
        color = band.extend(whole, k)
        row0, n = band.r0 - k, color.shape[0]
    small = whole
    for _ in range(3):
        if min(small.shape[0], small.shape[1]) >= 8:
            small = downsample4(small)
    if flags.auto_exposure:
        exposure_state = auto_exposure(small, exposure_state, dt,
                                       p.exposure_gain)
        ev = exposure_state[0]
        bright = exposure_state[2]
    else:
        ev = torch.full((), p.manual_exposure, dtype=torch.float32,
                        device=color.device)
        bright = 2.0 / torch.clamp(ev, min=1e-6)

    if flags.bloom:
        color = bloom(color, bright, p.bloom_strength,
                      None if band is None else whole, row0)
    if flags.lens_flare:
        color = color + lens_flare(h, w, sun_uv, sun_visible,
                                   p.flare_strength, row0, n) \
            / torch.clamp(ev, min=1e-6)

    if torch.is_tensor(frame_idx):
        frame_idx = frame_idx.reshape(())
    fshift = _to_unit_float(hash_pcg(u32(frame_idx)))
    if mask is None:
        mask = dither_mask(color.device)
    params = tail_params(ev, p.tone_map, p.gamma, p.sharpen_amount, fshift,
                         color.device)
    mapped = (out_h, out_w) != (h, w)
    if mapped:
        # tone map and gamma at render size from the device-side params
        # (no host copy), then the upscale to the screen, clamped
        ldr = tonemap(color * params[0], params[1], params[2])
        color = (torch.clamp(upscale_catmull_rom(ldr, out_h, out_w), 0.0,
                             1.0) if band is None
                 else upscale_band(ldr, band, out_h, out_w, margin=1))
    u8 = post_tail(color.contiguous(), params, mask,
                   do_sharpen=flags.sharpen, do_dither=flags.dither,
                   mapped=mapped)
    if band is not None:
        u8 = crop_rows(u8, 1)  # the rows around the band the sharpen read
    return u8, exposure_state
