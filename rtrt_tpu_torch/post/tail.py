"""Fused post-processing tail — kernel K3 and its plain twin (port of
rtrt_tpu/post/tail.py::post_tail_pallas).

exposure x tone map + gamma, 3x3 sharpen clamped to the neighbourhood,
blue-noise dither (the 64x64 mask tiled and shifted by hash_pcg(frame)),
u8 quantize.  `post_tail` launches K3 (csrc/post_tail.cu) for CUDA tensors
and runs `post_tail_plain` — the XLA ops of rtrt_tpu/post/pipeline.py:70-95
— for CPU tensors.

mapped=True takes an image that is tone-mapped already (the Catmull-Rom
upscale's output, clamped to [0, 1]): no exposure, no tone map; sharpen,
dither and quantize as above (rtrt_tpu/post/pipeline.py:78-95).  K3 has
an instantiation for it, counted apart (launch_counts["post_tail_mapped"]).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda
from ..utils.consts import device_const
from .sharpen import sharpen
from .tonemap import tonemap


def tail_params(ev, tone_map, gamma, sharpen_amount, fshift, device):
    """(5,) float32 device vector [ev, tone map index, gamma, sharpen
    amount, dither shift]; ev and fshift may be device scalars (no host
    sync; a replayed frame's shift is hashed on the device), and nothing
    is copied from the host."""
    ev = torch.as_tensor(ev, dtype=torch.float32, device=device).reshape(1)
    shift = (fshift.to(torch.float32).reshape(1) if torch.is_tensor(fshift)
             else torch.full((1,), fshift, dtype=torch.float32,
                             device=device))
    return torch.cat([ev, device_const((tone_map, gamma, sharpen_amount),
                                       device), shift])


def post_tail_plain(color, params, mask, *, do_sharpen: bool,
                    do_dither: bool, mapped: bool = False):
    """color (H,W,3) f32, params (5,), mask (64,64) -> (H,W,3) uint8."""
    h, w = color.shape[0], color.shape[1]
    ev, tone, gamma, amount, fshift = params.unbind(0)
    ldr = color if mapped else tonemap(color * ev, tone, gamma)
    if do_sharpen:
        ldr = sharpen(ldr, amount)
    if do_dither:
        ys = torch.arange(h, device=color.device) % mask.shape[0]
        xs = torch.arange(w, device=color.device) % mask.shape[1]
        tiled = mask[ys][:, xs]
        noise = torch.remainder(tiled + fshift, 1.0) - 0.5
        ldr = ldr + noise[..., None] / 255.0
    return torch.clamp(ldr * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def post_tail(color, params, mask, *, do_sharpen: bool, do_dither: bool,
              mapped: bool = False, out=None):
    """Fused tail on an (H,W,3) float32 frame; see module docstring.  out:
    for CUDA tensors, an optional (H,W,3) uint8 buffer that receives the
    image (and is returned)."""
    if color.device.type == "cpu":
        return post_tail_plain(color, params, mask, do_sharpen=do_sharpen,
                               do_dither=do_dither, mapped=mapped)
    dev = color.device
    h, w = color.shape[0], color.shape[1]
    if out is None:
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    cuda.check_tensors(dev, color=(color, torch.float32, (h, w, 3)),
                       params=(params, torch.float32, (5,)),
                       mask=(mask, torch.float32, (64, 64)),
                       out=(out, torch.uint8, (h, w, 3)))
    cuda.launch(cuda.library().rtrt_post_tail,
                "post_tail_mapped" if mapped else "post_tail", dev, color,
                ctypes.c_int(h), ctypes.c_int(w), params, mask,
                ctypes.c_int(int(do_sharpen)), ctypes.c_int(int(do_dither)),
                ctypes.c_int(int(mapped)), out)
    return out
