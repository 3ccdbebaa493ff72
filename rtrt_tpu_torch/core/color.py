"""Color-science transforms (port of rtrt_tpu/core/color.py): XYZ / sRGB /
ACES matrices, the sRGB transfer functions, Rec.709 luminance and the
denoiser's YCoCg transform.  The matrices are the published CIE / ACES
colorimetry constants; every function maps (..., 3) float tensors to
(..., 3) (luminance to (...,))."""

from __future__ import annotations

import torch

from .vecmath import matvec

# CIE XYZ (D65) -> linear sRGB (IEC 61966-2-1)
XYZ_TO_SRGB = ((3.2404542, -1.5371385, -0.4985314),
               (-0.9692660, 1.8760108, 0.0415560),
               (0.0556434, -0.2040259, 1.0572252))
SRGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
               (0.2126729, 0.7151522, 0.0721750),
               (0.0193339, 0.1191920, 0.9503041))
# XYZ -> ACES2065-1 (AP0, from the ACES spec)
XYZ_TO_ACES2065 = ((1.0498110175, 0.0000000000, -0.0000974845),
                   (-0.4959030231, 1.3733130458, 0.0982400361),
                   (0.0000000000, 0.0000000000, 0.9912520182))
# linear sRGB <-> ACEScg (AP1) fits
SRGB_TO_ACESCG = ((0.6131, 0.3395, 0.0474),
                  (0.0702, 0.9164, 0.0134),
                  (0.0206, 0.1096, 0.8698))
ACESCG_TO_SRGB = ((1.7049, -0.6217, -0.0832),
                  (-0.1302, 1.1408, -0.0106),
                  (-0.0240, -0.1289, 1.1529))

LUMA = (0.2126, 0.7152, 0.0722)  # Rec.709


def _apply(m, c):
    return matvec(torch.tensor(m, dtype=torch.float32, device=c.device), c)


def xyz_to_srgb(c):
    return _apply(XYZ_TO_SRGB, c)


def srgb_to_xyz(c):
    return _apply(SRGB_TO_XYZ, c)


def xyz_to_aces2065(c):
    return _apply(XYZ_TO_ACES2065, c)


def srgb_to_acescg(c):
    return _apply(SRGB_TO_ACESCG, c)


def acescg_to_srgb(c):
    return _apply(ACESCG_TO_SRGB, c)


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


def linear_to_srgb_gamma(c):
    """Linear -> sRGB transfer function (piecewise)."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def srgb_gamma_to_linear(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))
