# Frozen copy of rtrt_tpu_torch/post/tail.py
# (framebench's plain reference).
"""Fused post-processing tail — K3's plain twin (port of
rtrt_tpu/post/tail.py::post_tail_pallas): exposure x tone map + gamma, 3x3
sharpen clamped to the neighbourhood, blue-noise dither (the 64x64 mask
tiled and shifted by hash_pcg(frame)), u8 quantize — the XLA ops of
rtrt_tpu/post/pipeline.py:70-95.
"""

from __future__ import annotations

import torch

from .sharpen import sharpen
from .tonemap import tonemap


def tail_params(ev, tone_map, gamma, sharpen_amount, fshift, device):
    """(5,) float32 device vector [ev, tone map index, gamma, sharpen
    amount, dither shift]; ev may be a device scalar (no host sync)."""
    rest = torch.tensor([tone_map, gamma, sharpen_amount, fshift],
                        dtype=torch.float32).to(device, non_blocking=True)
    ev = torch.as_tensor(ev, dtype=torch.float32, device=device).reshape(1)
    return torch.cat([ev, rest])


def post_tail(color, params, mask, *, do_sharpen: bool, do_dither: bool):
    """color (H,W,3) f32, params (5,), mask (64,64) -> (H,W,3) uint8."""
    h, w = color.shape[0], color.shape[1]
    ev, tone, gamma, amount, fshift = params.unbind(0)
    ldr = tonemap(color * ev, tone, gamma)
    if do_sharpen:
        ldr = sharpen(ldr, amount)
    if do_dither:
        ys = torch.arange(h, device=color.device) % mask.shape[0]
        xs = torch.arange(w, device=color.device) % mask.shape[1]
        tiled = mask[ys][:, xs]
        noise = torch.remainder(tiled + fshift, 1.0) - 0.5
        ldr = ldr + noise[..., None] / 255.0
    return torch.clamp(ldr * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
