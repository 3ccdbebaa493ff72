# Frozen copy of rtrt_tpu_torch/ops/morton.py
# (framebench's plain reference).
"""Morton (Z-order) codes for spatial sorting (port of
rtrt_tpu/ops/morton.py).

torch has little uint32 / uint64 support on CUDA (shifts, xor, or), so the
codes are computed in int64 and keep their unsigned values: a 30-bit code
lies in [0, 2^30), a 63-bit one in [0, 2^63), both exact in int64.
"""

from __future__ import annotations

import torch


def expand_bits_30(x):
    """Spread the low 10 bits of x so consecutive bits are 3 apart."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d_30(p):
    """30-bit morton code of points normalized to [0,1]^3: (..., 3) f32 ->
    (...,) int64 (the JAX function's uint32 values)."""
    q = torch.clamp(p * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (expand_bits_30(q[..., 0]) << 2) \
        | (expand_bits_30(q[..., 1]) << 1) | expand_bits_30(q[..., 2])


def normalize_to_aabb(p, lo, hi, eps=1e-12):
    """Normalize points into an AABB's unit cube (degenerate axes -> 0.5)."""
    ext = hi - lo
    safe = torch.clamp(ext, min=eps)
    u = (p - lo) / safe
    return torch.where(ext > eps, u, torch.full_like(u, 0.5))
