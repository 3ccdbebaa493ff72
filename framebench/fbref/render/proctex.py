# Frozen copy of rtrt_tpu_torch/render/proctex.py
# (framebench's plain reference).
"""Analytic procedural soil shading (port of rtrt_tpu/render/proctex.py):
the lattice hash and constants that the megakernel's component-form soil,
render/kshade.py::soil_shading_c, reads."""

from __future__ import annotations

import torch

from .sampling import INV_2POW24, M32, mul32


def _hash3(ix, iy, iz, seed: int):
    """Lattice hash of integer tensors -> [0, 1) float32 (top 24 bits)."""
    h = ((mul32(ix & M32, 0x8DA6B343) ^ mul32(iy & M32, 0xD8163841)
          ^ mul32(iz & M32, 0xCB1AB31F)) + seed) & M32
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return (h >> 8).to(torch.float32) * INV_2POW24
