"""Light sampling (port of rtrt_tpu/render/light.py): the environment light
(flux-weighted sky-or-sun choice, Walker alias texel pick, the mixture's
solid-angle pdf), the analytic sun-cone NEE that the integrator runs, and
the sphere lights' cone sampling."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.vecmath import dot, normalize, orthonormal_basis
from .sampling import uniform_cone, uniform_cone_pdf
from .sky import (_SUN_SIN_A, SUN_CONE_PDF, SUN_COS_THETA_MAX,
                  dir_to_equal_area_uv, equal_area_uv_to_dir, sky_radiance,
                  sun_disk_radiance)


@dataclasses.dataclass
class SphereLights:
    center: torch.Tensor    # (L,3)
    radius: torch.Tensor    # (L,)
    emission: torch.Tensor  # (L,3)

    def to(self, device) -> "SphereLights":
        return SphereLights(self.center.to(device), self.radius.to(device),
                            self.emission.to(device))


@dataclasses.dataclass
class LightSample:
    wi: torch.Tensor        # (..., 3) direction toward the light
    radiance: torch.Tensor  # (..., 3) incident radiance if unoccluded
    pdf: torch.Tensor       # (...,) solid-angle pdf of the sample
    dist: torch.Tensor      # (...,) distance to the light (inf: env)


def _p_sun(maps):
    total = maps.sky_flux + maps.sun_flux
    return torch.where(total > 0, maps.sun_flux / torch.clamp(
        total, min=1e-20), torch.zeros_like(total))


def _alias_pick(alias_p, alias_j, u1, u2):
    """O(1) Walker alias sample: texel k = floor(u1 n), or its partner."""
    n = alias_p.shape[0]
    k = torch.clamp((u1 * n).to(torch.int64), 0, n - 1)
    return torch.where(u2 < alias_p[k], k, alias_j[k].to(torch.int64))


def _sun_uv_to_dir(maps, uv):
    """Sun-cone-map uv in [0, 1)^2 -> world direction."""
    sx = uv[..., 0] * 2.0 - 1.0
    sy = uv[..., 1] * 2.0 - 1.0
    tang = sx[..., None] * maps.sun_basis_t + sy[..., None] * maps.sun_basis_b
    r2 = torch.clamp(sx * sx + sy * sy, 0.0, 1.0)
    axial = torch.sqrt(torch.clamp(1.0 - r2 * _SUN_SIN_A * _SUN_SIN_A,
                                   min=0.0))
    return normalize(axial[..., None] * maps.sun_dir + _SUN_SIN_A * tang)


def sample_env_light(maps, u3) -> LightSample:
    """Importance-sample the environment: sky or sun by their fluxes, a
    texel of that map by its alias table, a point in the texel.  u3
    (..., 3): selector, table, accept / jitter."""
    h, w = maps.sky_map.shape[0], maps.sky_map.shape[1]
    sh, sw = maps.sun_map.shape[0], maps.sun_map.shape[1]
    p_sun = _p_sun(maps)
    pick_sun = u3[..., 0] < p_sun
    jx = torch.remainder(u3[..., 2] * 7919.0, 1.0)
    jy = torch.remainder(u3[..., 2] * 104729.0, 1.0)
    u_accept = torch.remainder(u3[..., 2] * 15485863.0, 1.0)

    sky_idx = _alias_pick(maps.sky_alias_p, maps.sky_alias_j, u3[..., 1],
                          u_accept)
    iy, ix = sky_idx // w, sky_idx % w
    sky_dir = equal_area_uv_to_dir(torch.stack(
        [(ix.to(torch.float32) + jx) / w, (iy.to(torch.float32) + jy) / h],
        dim=-1))
    sky_rad = maps.sky_map[iy, ix]
    sky_pdf = maps.sky_pdf[sky_idx]

    sun_idx = _alias_pick(maps.sun_alias_p, maps.sun_alias_j, u3[..., 1],
                          u_accept)
    siy, six = sun_idx // sw, sun_idx % sw
    sun_dir = _sun_uv_to_dir(maps, torch.stack(
        [(six.to(torch.float32) + jx) / sw,
         (siy.to(torch.float32) + jy) / sh], dim=-1))
    sun_rad = maps.sun_map[siy, six]
    sun_pdf = maps.sun_pdf[sun_idx]

    ps = pick_sun[..., None]
    pdf = torch.where(pick_sun, p_sun * sun_pdf, (1.0 - p_sun) * sky_pdf)
    return LightSample(torch.where(ps, sun_dir, sky_dir),
                       torch.where(ps, sun_rad, sky_rad),
                       torch.clamp(pdf, min=0.0),
                       torch.full_like(pdf, math.inf))


def env_light_pdf(maps, d):
    """Solid-angle pdf that `sample_env_light` draws direction d (MIS
    weight of BSDF rays that escape)."""
    h, w = maps.sky_map.shape[0], maps.sky_map.shape[1]
    sh, sw = maps.sun_map.shape[0], maps.sun_map.shape[1]
    p_sun = _p_sun(maps)
    uv = dir_to_equal_area_uv(d)
    ix = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    iy = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    sky_pdf = maps.sky_pdf[iy * w + ix]
    in_cone = dot(d, maps.sun_dir.expand(d.shape)) > SUN_COS_THETA_MAX
    tx = dot(d, maps.sun_basis_t.expand(d.shape)) / _SUN_SIN_A
    ty = dot(d, maps.sun_basis_b.expand(d.shape)) / _SUN_SIN_A
    sxi = torch.clamp(((tx + 1.0) * 0.5 * sw).to(torch.int64), 0, sw - 1)
    syi = torch.clamp(((ty + 1.0) * 0.5 * sh).to(torch.int64), 0, sh - 1)
    sun_pdf = torch.where(in_cone, maps.sun_pdf[syi * sw + sxi],
                          torch.zeros_like(sky_pdf))
    return (1.0 - p_sun) * sky_pdf + p_sun * sun_pdf


def env_radiance(maps, d):
    """Radiance of escaped rays from the baked maps."""
    return sky_radiance(maps, d)


def sample_sun(maps, u2) -> LightSample:
    """Uniform sample of the sun's cone with analytic radiance (the
    limb-darkened disk times the transmittance) and pdf; a sun below the
    horizon gives no radiance.  This is the integrator's NEE."""
    local = uniform_cone(u2, SUN_COS_THETA_MAX)
    wi = normalize(local[..., 0:1] * maps.sun_basis_t
                   + local[..., 1:2] * maps.sun_basis_b
                   + local[..., 2:3] * maps.sun_dir)
    rad = sun_disk_radiance(maps, wi)
    rad = torch.where(maps.sun_dir[1] > -0.05, rad, torch.zeros_like(rad))
    return LightSample(wi, rad, torch.full_like(wi[..., 0], SUN_CONE_PDF),
                       torch.full_like(wi[..., 0], math.inf))


def sun_pdf_dir(maps, d):
    """Analytic pdf that the sun-cone NEE strategy produces dirs d (..., 3)."""
    cos_g = (d * maps.sun_dir).sum(-1)
    in_cone = cos_g > SUN_COS_THETA_MAX
    up = maps.sun_dir[1] > -0.05
    pdf = torch.full_like(cos_g, SUN_CONE_PDF)
    return torch.where(in_cone & up, pdf, torch.zeros_like(cos_g))


def sample_sphere_light(lights: SphereLights, light_idx, p, u2) -> LightSample:
    """Cone-sample sphere light light_idx (...,) int toward points p
    (..., 3); dist is the distance to the sphere along wi (clamped at 0)."""
    c = lights.center[light_idx]
    r = lights.radius[light_idx]
    to_c = c - p
    d2 = torch.clamp(dot(to_c, to_c), min=1e-8)
    dist = torch.sqrt(d2)
    axis = to_c / dist[..., None]
    cos_max = torch.sqrt(1.0 - torch.clamp(r * r / d2, 0.0, 0.9999))
    local = uniform_cone(u2, cos_max)
    t, b = orthonormal_basis(axis)
    wi = normalize(local[..., 0:1] * t + local[..., 1:2] * b
                   + local[..., 2:3] * axis)
    hit_dist = dist * local[..., 2] - torch.sqrt(torch.clamp(
        r * r - d2 * (1.0 - local[..., 2] ** 2), min=0.0))
    return LightSample(wi, lights.emission[light_idx],
                       uniform_cone_pdf(cos_max),
                       torch.clamp(hit_dist, min=0.0))
