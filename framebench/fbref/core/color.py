# Frozen copy of rtrt_tpu_torch/core/color.py
# (framebench's plain reference).
"""Color-science transforms (port of rtrt_tpu/core/color.py): XYZ / sRGB /
ACES matrices, the sRGB transfer functions, Rec.709 luminance and the
denoiser's YCoCg transform.  The matrices are the published CIE / ACES
colorimetry constants; every function maps (..., 3) float tensors to
(..., 3) (luminance to (...,))."""

from __future__ import annotations

import torch


LUMA = (0.2126, 0.7152, 0.0722)  # Rec.709


def luminance(c):
    """Rec.709 relative luminance of linear RGB: (..., 3) -> (...,)."""
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def rgb_to_ycocg(c):
    """RGB -> YCoCg (orthogonal variant used for history clamping)."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = 0.25 * r + 0.5 * g + 0.25 * b
    co = 0.5 * r - 0.5 * b
    cg = -0.25 * r + 0.5 * g - 0.25 * b
    return torch.stack([y, co, cg], dim=-1)


def ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    r = y + co - cg
    g = y + cg
    b = y - co - cg
    return torch.stack([r, g, b], dim=-1)
