# Frozen copy of rtrt_tpu_torch/post/sharpen.py
# (framebench's plain reference).
"""3x3 sharpening with a clamp to the neighbourhood min/max, and a 9-tap
median (port of rtrt_tpu/post/sharpen.py)."""

from __future__ import annotations

import torch


def neighborhood3(img):
    """The 9 edge-clamped shifted copies of an (H, W, ...) image, stacked
    (dy, dx) row-major over {-1, 0, 1}^2: (9, H, W, ...)."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.arange(h, device=img.device)
    xs = torch.arange(w, device=img.device)
    taps = []
    for dy in (-1, 0, 1):
        rows = img[torch.clamp(ys + dy, 0, h - 1)]
        for dx in (-1, 0, 1):
            taps.append(rows[:, torch.clamp(xs + dx, 0, w - 1)])
    return torch.stack(taps, dim=0)


def sharpen(img, amount):
    """3x3 unsharp mask clamped to the local neighbourhood range."""
    taps = neighborhood3(img)
    blur = taps.sum(0) / 9.0
    sharp = img + (img - blur) * (2.0 * amount)
    return torch.minimum(torch.maximum(sharp, taps.amin(0)), taps.amax(0))
