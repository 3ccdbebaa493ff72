"""Ocean: an iterated wave heightfield, its ray march and its shading (port
of rtrt_tpu/render/water.py; reference: src/water.cuh:9-188).

The heightfield is per-ray math with no tables; the march is a fixed
16-step search for the first crossing of y = height(x, z) and 8
bisections of its bracket; the shading blends the reflected environment
with depth-tinted water by Fresnel.  The clock `time` is a float32 value
(engine/frame.py::advance_clock); its products with constants are formed
in float32, as the JAX module's are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.vecmath import dot, normalize, reflect

WAVE_ITERS = 5
MARCH_STEPS = 16
BISECTIONS = 8
OCEAN_LEVEL = 0.0     # mean water height (world y)
T_MAX = 200.0         # far end of the march
NORMAL_EPS = 0.05     # central-difference step of wave_normal
_DEEP = np.float32([0.02, 0.08, 0.12])      # water colours
_SHALLOW = np.float32([0.1, 0.3, 0.35])


def wave_height(x, z, time: float):
    """Sum of domain-warped sines."""
    h = torch.zeros_like(x)
    amp = 0.5
    freq = 0.16
    dx, dz = x, z
    for i in range(WAVE_ITERS):
        tc = float(np.float32(time) * np.float32(0.8 + 0.2 * i))
        phase = dx * freq + dz * freq * 0.7 + tc
        cp = torch.cos(phase)
        h = h + amp * (torch.sin(phase) * torch.exp(cp - 1.0))
        # domain warp for choppiness
        dx = dx + cp * amp * 0.4
        dz = dz + torch.sin(phase * 1.3) * amp * 0.3
        amp *= 0.55
        freq *= 1.9
    return h


def wave_normal(x, z, time: float):
    """Central-difference normal; the four heights in one stacked call."""
    eps = NORMAL_EPS
    hs = wave_height(torch.stack([x - eps, x + eps, x, x]),
                     torch.stack([z, z, z - eps, z + eps]), time)
    return normalize(torch.stack([hs[0] - hs[1],
                                  torch.full_like(hs[0], 2.0 * eps),
                                  hs[2] - hs[3]], dim=-1))


def intersect_ocean(org, dir, time: float):
    """Fixed-step march + bisection for the heightfield crossing.  Returns
    (hit (...,), t (...,) with inf where no hit); only rays heading down
    hit."""
    ox, oy, oz = org.unbind(-1)
    dx, dy, dz = dir.unbind(-1)
    t0 = torch.clamp((OCEAN_LEVEL + 1.5 - oy) / torch.clamp(dy, max=-1e-4),
                     min=0.0)

    def above(t):
        return oy + dy * t > OCEAN_LEVEL + wave_height(ox + dx * t, oz + dz * t,
                                                 time)

    t = prev_t = t0
    prev_above = torch.ones_like(t0, dtype=torch.bool)
    found = torch.zeros_like(t0, dtype=torch.bool)
    dt = (T_MAX - t0) / MARCH_STEPS
    lo_t = torch.zeros_like(t0)
    hi_t = torch.zeros_like(t0)
    for _ in range(MARCH_STEPS):
        a = above(t)
        newly = prev_above & ~a & ~found  # first surface crossing
        lo_t = torch.where(newly, prev_t, lo_t)
        hi_t = torch.where(newly, t, hi_t)
        found = found | newly
        prev_above = a
        prev_t = t
        t = t + dt
    for _ in range(BISECTIONS):
        mid = 0.5 * (lo_t + hi_t)
        a = above(mid)
        lo_t = torch.where(a, mid, lo_t)
        hi_t = torch.where(a, hi_t, mid)
    hit = found & (dy < 0.0)
    return hit, torch.where(hit, 0.5 * (lo_t + hi_t), math.inf)


def ocean_shade(org, dir, t, time: float, sky_radiance_fn):
    """Fresnel blend of the reflected environment and depth-tinted water
    (reference OceanShader, water.cuh:127)."""
    p = org + dir * t[..., None]
    n = wave_normal(p[..., 0], p[..., 2], time)
    cos_i = torch.clamp(-dot(dir, n), 0.0, 1.0)
    m = 1.0 - cos_i
    m2 = m * m
    f = 0.02 + 0.98 * (m2 * m2 * m)
    refl = sky_radiance_fn(normalize(reflect(dir, n)))
    # deep + (shallow - deep) * e per channel, the constants as float32
    # scalars (no host-to-device copy in the frame)
    e = torch.exp(-0.2 * torch.clamp(t, min=0.0))
    body = torch.stack([e * float(s - d) + float(d)
                        for d, s in zip(_DEEP, _SHALLOW)], dim=-1)
    return refl * f[..., None] + body * (1.0 - f[..., None])
