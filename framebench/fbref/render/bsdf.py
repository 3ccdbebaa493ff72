# Frozen copy of rtrt_tpu_torch/render/bsdf.py
# (framebench's plain reference).
"""BSDF models: Lambert, perfect mirror, Fresnel glass, GGX microfacet
(port of rtrt_tpu/render/bsdf.py).  Every model is evaluated for every lane
and selected by material type, as the JAX module does.

Conventions: wo points toward the viewer, wi away from the surface, n is
the shading normal on wo's side; `sample_bsdf` returns the weight f cos /
pdf (delta lobes fold the Dirac through); glass is the perfect Fresnel
reflect / refract with total internal reflection.  The megakernel's
component-form twins of these live in render/kshade.py."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


INV_PI = 0.3183098861837907

MAT_LAMBERT = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_GGX = 3
MAT_EMISSIVE = 4


@dataclasses.dataclass
class Materials:
    """SoA material table (M entries)."""

    mtype: torch.Tensor      # (M,) int32
    albedo: torch.Tensor     # (M,3)
    emission: torch.Tensor   # (M,3)
    roughness: torch.Tensor  # (M,)
    ior: torch.Tensor        # (M,)
    f0: torch.Tensor         # (M,3)
    textured: torch.Tensor   # (M,) int32

    def to(self, device) -> "Materials":
        return Materials(*(getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)))


def make_materials(entries) -> Materials:
    """entries: list of dicts with keys matching Materials fields."""
    m = len(entries)
    d = dict(
        mtype=np.zeros(m, np.int32), albedo=np.ones((m, 3), np.float32),
        emission=np.zeros((m, 3), np.float32),
        roughness=np.full(m, 0.5, np.float32),
        ior=np.full(m, 1.5, np.float32),
        f0=np.full((m, 3), 0.04, np.float32), textured=np.zeros(m, np.int32))
    for i, e in enumerate(entries):
        for k, v in e.items():
            d[k][i] = v
    return Materials(**{k: torch.from_numpy(v) for k, v in d.items()})


def fresnel_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel reflectance; 1 on total internal
    reflection.  cos_i >= 0; eta = n_t / n_i."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta * eta, min=1e-8)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-8)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(f), torch.clamp(f, 0.0, 1.0))


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-8)


def smith_g1(n_dot_v, alpha):
    a2 = alpha * alpha
    denom = n_dot_v + torch.sqrt(torch.clamp(
        a2 + (1.0 - a2) * n_dot_v * n_dot_v, min=0.0))
    return 2.0 * n_dot_v / torch.clamp(denom, min=1e-8)


def smith_g2(n_dot_v, n_dot_l, alpha):
    return smith_g1(n_dot_v, alpha) * smith_g1(n_dot_l, alpha)
