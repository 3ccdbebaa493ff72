# Frozen copy of rtrt_tpu_torch/post/bloom.py
# (framebench's plain reference).
"""Bloom: bright-pass + gaussian pyramid blur + smoothed composite (port of
rtrt_tpu/post/bloom.py).  All smoothing happens at 1/4 and 1/16
resolution; the upsample back to full resolution is bilinear
(ops/resize.py::upsample_linear)."""

from __future__ import annotations

import torch

from ..core.color import luminance
from ..ops.resize import downsample4, upsample_linear
from ..ops.stencil import gaussian_weights, neighborhood


def _gauss5(img):
    w = gaussian_weights(2, img.device)
    taps, _ = neighborhood(img, 2)
    return torch.sum(taps * w[:, None, None, None], dim=0)


def bright_pass(img, threshold):
    """threshold: float or 0-d tensor (on img's device)."""
    lum = luminance(img)[..., None]
    scale = torch.clamp((lum - threshold)
                        / torch.clamp(torch.as_tensor(threshold), min=1e-4),
                        0.0, 1.0)
    return img * scale


def bloom(img, bright_lum, strength):
    """img: (H,W,3) pre-tonemap linear colour; bright_lum: adaptation bright
    luminance (the threshold, exposure state [2]); strength: composite
    weight."""
    quarter = downsample4(img)
    sixteenth = downsample4(quarter)
    q = _gauss5(bright_pass(quarter, bright_lum))
    s = _gauss5(_gauss5(bright_pass(sixteenth, bright_lum)))
    h, w = img.shape[0], img.shape[1]
    q_up = upsample_linear(q, h, w)
    s_up = upsample_linear(s, h, w)
    return img + strength * (q_up + s_up)
