"""Procedural star field for night skies (port of rtrt_tpu/render/stars.py;
reference: src/star.cuh:10-57 StableStarField).

Directions quantise onto a cube-face grid; each cell hosts at most one star
with a hashed position, brightness and tint.  The uint32 hashes run in
int64 tensors masked with M32, as in render/sampling.py, and reproduce the
JAX module's bit for bit.
"""

from __future__ import annotations

import torch

from .sampling import M32, hash_pcg, mul32, u32

GRID = 96.0  # stars per cube-face axis
STAR_SEED = 17


def _cell_hash(ix, iy, face, seed: int):
    return hash_pcg(mul32(u32(ix), 0x9E3779B9) ^ mul32(u32(iy), 0x85EBCA6B)
                    ^ mul32((u32(face) + seed) & M32, 0xC2B2AE35))


def star_field(d):
    """Star radiance along unit directions (..., 3) -> (..., 3)."""
    ax = d.abs()
    dx, dy, dz = d.unbind(-1)
    ax0, ax1, ax2 = ax.unbind(-1)
    face = torch.where((ax0 >= ax1) & (ax0 >= ax2),
                       torch.where(dx >= 0, 0, 1),
                       torch.where(ax1 >= ax2, torch.where(dy >= 0, 2, 3),
                                   torch.where(dz >= 0, 4, 5)))
    major = ax.amax(-1)
    # face-local uv in [0, 1)
    u = torch.where(face < 4, torch.where(face < 2, dy, dx), dx) / major
    v = torch.where(face < 4, dz, dy) / major
    u = (u + 1.0) * 0.5 * GRID
    v = (v + 1.0) * 0.5 * GRID
    iu = torch.floor(u).to(torch.int64)
    iv = torch.floor(v).to(torch.int64)
    h = _cell_hash(iu, iv, face, STAR_SEED)
    # the star's position within the cell
    fx = (h & 0xFFFF).to(torch.float32) / 65535.0
    fy = ((h >> 16) & 0xFFFF).to(torch.float32) / 65535.0
    du = u - iu.to(torch.float32) - fx
    dv = v - iv.to(torch.float32) - fy
    d2 = du * du + dv * dv
    h2 = hash_pcg(h ^ 0xB5297A4D)
    mag = (h2 & 0xFF).to(torch.float32) / 255.0
    exists = mag > 0.72  # ~28% of cells host a star
    b = torch.where(exists, (mag - 0.72) / 0.28, 0.0)
    brightness = b * b * b
    core = torch.exp(-d2 * 600.0)
    # colour temperature
    warm = ((h2 >> 8) & 0xFF).to(torch.float32) / 255.0
    tint = torch.stack([0.9 + 0.3 * warm, torch.full_like(warm, 0.95),
                        1.2 - 0.3 * warm], dim=-1)
    return (brightness * core)[..., None] * tint
