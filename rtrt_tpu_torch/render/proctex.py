"""Analytic procedural soil shading (port of rtrt_tpu/render/proctex.py):
3D value noise in closed form at the shading point, its octaves faded by
the ray cone's footprint (the analytic counterpart of a mip chain).  The
wavefront integrator shades textured materials with it; the megakernel's
component-form twin is render/kshade.py::soil_shading_c (the same math
over separate component tensors, kept apart so that neither's values
move)."""

from __future__ import annotations

import torch

from ..core.vecmath import normalize
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


def value_noise3(p, seed: int):
    """One octave of 3D value noise in [0, 1] at world points p (..., 3)."""
    pf = torch.floor(p)
    i = pf.to(torch.int64)
    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    f = p - pf
    w = f * f * f * (f * (f * 6.0 - 15.0) + 10.0)  # quintic smoothstep
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]

    def h(dx, dy, dz):
        return _hash3(ix + dx, iy + dy, iz + dz, seed)

    x00 = h(0, 0, 0) + (h(1, 0, 0) - h(0, 0, 0)) * wx
    x10 = h(0, 1, 0) + (h(1, 1, 0) - h(0, 1, 0)) * wx
    x01 = h(0, 0, 1) + (h(1, 0, 1) - h(0, 0, 1)) * wx
    x11 = h(0, 1, 1) + (h(1, 1, 1) - h(0, 1, 1)) * wx
    y0 = x00 + (x10 - x00) * wy
    y1 = x01 + (x11 - x01) * wy
    return y0 + (y1 - y0) * wz


def fbm3_filtered(p, cone_width, octaves: int, base_freq: float, seed: int,
                  gain: float = 0.5):
    """Fractal noise whose octave at frequency f fades to its mean 0.5 once
    the footprint cone_width covers its wavelength."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    norm, amp, freq = 0.0, 1.0, base_freq
    for k in range(octaves):
        fade = torch.clamp(1.0 - cone_width * freq * 1.5, 0.0, 1.0)
        n = value_noise3(p * freq, seed + k * 131)
        total = total + amp * (0.5 + (n - 0.5) * fade)
        norm += amp
        amp *= gain
        freq *= 2.0
    return total / norm


_C_DARK = (0.23, 0.15, 0.09)
_C_MID = (0.42, 0.30, 0.18)
_C_LIGHT = (0.55, 0.47, 0.35)


def soil_shading(pos, ns, cone_width, world_scale: float = 0.35):
    """The soil material at points pos (..., 3) with shading normals ns and
    footprints cone_width (...,): (albedo * ao (..., 3), roughness (...),
    bumped normal (..., 3))."""
    p = pos * world_scale
    cw = cone_width * world_scale
    h = fbm3_filtered(p, cw, 4, 1.0, seed=101)
    detail = fbm3_filtered(p, cw, 3, 6.0, seed=202)

    # the colour blends per channel, with the constants as Python floats
    # (no device copy of a constant)
    t = torch.clamp(h * 1.4 - 0.2, 0.0, 1.0)
    t2 = torch.clamp(detail * 1.2 - 0.3, 0.0, 1.0)
    albedo = torch.stack([
        (dk * (1.0 - t) + md * t) * (1.0 - 0.4 * t2) + lt * (0.4 * t2)
        for dk, md, lt in zip(_C_DARK, _C_MID, _C_LIGHT)], dim=-1)
    ao = torch.clamp(0.55 + 0.45 * h, 0.0, 1.0)[..., None]

    rough = torch.clamp(0.55 + 0.4 * detail + 0.15 * (1.0 - h), 0.05, 1.0)

    # normal perturbation: an independent noise vector, LOD-faded
    bump_fade = torch.clamp(1.0 - cw * 8.0, 0.0, 1.0)
    bump = torch.stack([
        fbm3_filtered(p + off, cw, 2, 5.0, seed=seed) - 0.5
        for off, seed in ((17.17, 303), (29.29, 404), (43.43, 505))], dim=-1)
    n2 = normalize(ns + bump * (0.8 * bump_fade)[..., None])
    return albedo * ao, rough, n2
