# Frozen copy of rtrt_tpu_torch/post/exposure.py
# (framebench's plain reference).
"""Auto-exposure: log-luminance histogram + eye adaptation (port of
rtrt_tpu/post/exposure.py).  The state is a (4,) float32 tensor
[EV scale, adapted lum, adapted bright lum, initialized] that stays on the
device: no host sync per frame."""

from __future__ import annotations

import torch

from ..core.color import luminance

NUM_BINS = 64
LOG_LUM_MIN = -10.0
LOG_LUM_MAX = 10.0


def log_luminance_histogram(img_small):
    """(h, w, 3) small color -> (NUM_BINS,) normalized histogram."""
    lum = luminance(img_small).reshape(-1)
    ll = torch.clamp((torch.log2(torch.clamp(lum, min=1e-8)) - LOG_LUM_MIN)
                     / (LOG_LUM_MAX - LOG_LUM_MIN), 0.0, 1.0)
    b0 = torch.floor(ll * (NUM_BINS - 1)).to(torch.int64)
    # index_add_ of ones: exact counts, and no host sync (bincount on the
    # card reads the largest bin back to size its output)
    hist = torch.zeros(NUM_BINS, dtype=torch.float32,
                       device=lum.device).index_add_(
        0, b0, torch.ones_like(lum))
    return hist / torch.clamp(hist.sum(), min=1.0)


def _percentile_mean_lum(hist, lo=0.4, hi=0.9):
    """Mean log-luminance between the 40% / 90% cuts, and of the top decile."""
    cdf = torch.cumsum(hist, 0)
    prev = cdf - hist
    clipped = torch.clamp(torch.clamp(cdf, max=hi) - torch.clamp(prev, min=lo),
                          min=0.0)
    centers = LOG_LUM_MIN + (torch.arange(NUM_BINS, device=hist.device)
                             + 0.5) / NUM_BINS * (LOG_LUM_MAX - LOG_LUM_MIN)
    mean_ll = (clipped * centers).sum() / torch.clamp(clipped.sum(), min=1e-6)
    bmass = torch.clamp(torch.clamp(cdf, max=1.0)
                        - torch.clamp(prev, min=0.9), min=0.0)
    bright_ll = (bmass * centers).sum() / torch.clamp(bmass.sum(), min=1e-6)
    return 2.0 ** mean_ll, 2.0 ** bright_ll


def exposure_compensation(avg_lum):
    return 1.03 - 2.0 / (torch.log2(avg_lum * 1000.0 + 1.0) + 2.0)


def init_exposure_state(device="cuda"):
    return torch.tensor([1.0, 0.5, 2.0, 0.0], dtype=torch.float32,
                        device=device)


def auto_exposure(img_small, state, dt, gain):
    """One adaptation step (tau = 1 s); returns the new (4,) state.
    dt: frame time in seconds (0-d float32 tensor or float)."""
    hist = log_luminance_histogram(img_small)
    lum, bright = _percentile_mean_lum(hist)
    initialized = state[3] > 0.5
    if not torch.is_tensor(dt):  # a fill, not a synchronising copy
        dt = torch.full((), dt, dtype=torch.float32, device=state.device)
    a = 1.0 - torch.exp(-dt / 1.0)
    adapted = torch.where(initialized, state[1] + (lum - state[1]) * a, lum)
    adapted_b = torch.where(initialized, state[2] + (bright - state[2]) * a,
                            bright)
    ec = exposure_compensation(adapted)
    ev = gain * ec / torch.clamp(adapted, min=1e-6)
    return torch.stack([ev, adapted, adapted_b,
                        torch.ones((), device=state.device)])
