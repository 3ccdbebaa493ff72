# Frozen copy of rtrt_tpu_torch/post/tonemap.py
# (framebench's plain reference).
"""Tone-mapping operators: Reinhard extended, ACES (fitted + approx),
Uncharted2 — selected by a runtime index (port of rtrt_tpu/post/tonemap.py).
"""

from __future__ import annotations

import torch

from ..core.color import luminance

TONE_REINHARD = 0
TONE_ACES_FITTED = 1
TONE_ACES_APPROX = 2

_ACES_IN = ((0.59719, 0.35458, 0.04823),
            (0.07600, 0.90834, 0.01566),
            (0.02840, 0.13383, 0.83777))
_ACES_OUT = ((1.60475, -0.53108, -0.07367),
             (-0.10208, 1.10813, -0.00605),
             (-0.00327, -0.07276, 1.07602))


def reinhard_extended(c, white=4.0):
    lum = luminance(c)[..., None]
    num = lum * (1.0 + lum / (white * white))
    mapped = num / (1.0 + lum)
    return torch.clamp(c * (mapped / torch.clamp(lum, min=1e-6)), 0.0, 1.0)


def _mat3(m, c):
    return torch.stack([r[0] * c[..., 0] + r[1] * c[..., 1] + r[2] * c[..., 2]
                        for r in m], dim=-1)


def aces_fitted(c):
    v = _mat3(_ACES_IN, c)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return torch.clamp(_mat3(_ACES_OUT, a / b), 0.0, 1.0)


def aces_approx(c):
    c = c * 0.6
    return torch.clamp((c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59) + 0.14),
                       0.0, 1.0)


def _hable(x):
    a, b, c_, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c_ * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(c, white=11.2):
    return torch.clamp(_hable(c * 2.0) / _hable(torch.full_like(c, white)),
                       0.0, 1.0)


def tonemap(c, tone_index, gamma):
    """Selected operator, then gamma.  tone_index / gamma: 0-d float32
    tensors (or floats)."""
    i = torch.round(torch.as_tensor(tone_index, dtype=torch.float32,
                                    device=c.device))
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=c.device)
    out = torch.where(i == TONE_REINHARD, reinhard_extended(c),
                      torch.where(i == TONE_ACES_FITTED, aces_fitted(c),
                                  torch.where(i == TONE_ACES_APPROX,
                                              aces_approx(c), uncharted2(c))))
    return torch.pow(torch.clamp(out, 0.0, 1.0), 1.0 / gamma)
