"""Physically-based sky: single-scattering Rayleigh + Mie atmosphere (port of
the physical model of rtrt_tpu/render/sky.py).

Baked once per sky-parameter change: the equal-area sky map, the sun-cone
map, the transmittance toward the sun, and the host-solved Chebyshev fit
that escaped rays evaluate per pixel (`env_radiance_fit`).  The
importance-sampling CDF/alias tables of the JAX SkyMaps serve the env-light
sampler, which this slice's path does not run, so they are not built.

The sun-disk constants are folded on the host in float64 exactly as the JAX
module folds them: 1 - cos^2(theta) cancels catastrophically, and the
limb-darkening term amplifies 1-ulp cosine differences ~2000x.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.vecmath import dot, normalize, orthonormal_basis, vec3

PLANET_RADIUS = 6360e3
ATMOSPHERE_TOP = 6420e3
RAYLEIGH_SCALE_H = 7994.0
MIE_SCALE_H = 1200.0
BETA_RAYLEIGH = (5.802e-6, 13.558e-6, 33.1e-6)
BETA_MIE_SCATTER = 3.996e-6
BETA_MIE_ABSORB = 4.40e-6

TWO_PI = 6.283185307179586
SUN_ANGULAR_RADIUS = 0.004675  # radians
# float32 cos of the radius, as the JAX module computes it
SUN_COS_THETA_MAX = float(np.float32(math.cos(float(np.float32(
    SUN_ANGULAR_RADIUS)))))
# host-folded (float64) disk terms; rounded to f32 where the math uses them
SUN_SIN2_MAX = 1.0 - SUN_COS_THETA_MAX * SUN_COS_THETA_MAX
SUN_DISK_OMEGA = 2.0 * math.pi * (1.0 - SUN_COS_THETA_MAX)
# kshade's cone pdf: f32 reciprocal of the f32-rounded folded solid angle
SUN_DISK_PDF = float(np.float32(1.0) / np.float32(SUN_DISK_OMEGA))
# light.sun_pdf_dir's cone pdf: uniform_cone_pdf evaluated in f32
SUN_CONE_PDF = float(np.float32(1.0) / (np.float32(TWO_PI) * (
    np.float32(1.0) - np.float32(SUN_COS_THETA_MAX))))

SKY_RES = (256, 512)   # (H, W) equal-area map
SUN_RES = (32, 32)

VIEW_STEPS = 32
LIGHT_STEPS = 8

ENV_FIT_DEG = 14
ENV_FIT_RCOND = 1e-5


@dataclasses.dataclass
class SkyParams:
    sun_dir: torch.Tensor        # (3,) unit, +y up
    sun_intensity: torch.Tensor  # ()
    rayleigh_scale: torch.Tensor
    mie_scale: torch.Tensor
    mie_g: torch.Tensor
    altitude: torch.Tensor
    ground_albedo: torch.Tensor  # (3,)


def make_sky_params(sun_elevation=0.7, sun_azimuth=0.2, sun_intensity=20.0,
                    rayleigh_scale=1.0, mie_scale=1.0, mie_g=0.76,
                    altitude=200.0, ground_albedo=(0.3, 0.25, 0.2),
                    device="cuda") -> SkyParams:
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    ce, se = torch.cos(f(sun_elevation)), torch.sin(f(sun_elevation))
    ca, sa = torch.cos(f(sun_azimuth)), torch.sin(f(sun_azimuth))
    sun = normalize(vec3(ce * sa, se, ce * ca))
    return SkyParams(sun, f(sun_intensity), f(rayleigh_scale), f(mie_scale),
                     f(mie_g), f(altitude), f(ground_albedo))


def sun_direction_from_time(time_of_day, axis_angle=0.3):
    """Sun direction from a [0,1) day fraction on a tilted orbit."""
    ang = (torch.as_tensor(time_of_day, dtype=torch.float32) - 0.25) \
        * 2.0 * math.pi
    axis = torch.as_tensor(axis_angle, dtype=torch.float32)
    ca, sa = torch.cos(axis), torch.sin(axis)
    dy = torch.sin(ang)
    return normalize(vec3(torch.cos(ang), dy * ca, dy * sa))


# ---------------------------------------------------------------------------
# single-scattering raymarch
# ---------------------------------------------------------------------------


def _atmosphere_intersect(org, d, radius):
    b = dot(org, d)
    c = dot(org, org) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b + sq
    zero = torch.zeros_like(t)
    return torch.where(disc > 0.0, torch.clamp(t, min=0.0), zero)


def _densities(p):
    h = torch.sqrt(torch.clamp(dot(p, p), min=1.0)) - PLANET_RADIUS
    h = torch.clamp(h, min=0.0)
    return torch.exp(-h / RAYLEIGH_SCALE_H), torch.exp(-h / MIE_SCALE_H)


def _optical_depth_to_sun(p, sun_dir):
    t_top = _atmosphere_intersect(p, sun_dir.expand(p.shape), ATMOSPHERE_TOP)
    ds = t_top / LIGHT_STEPS
    od_r = torch.zeros(p.shape[:-1], device=p.device)
    od_m = torch.zeros(p.shape[:-1], device=p.device)
    for i in range(LIGHT_STEPS):
        sp = p + sun_dir * ((i + 0.5) * ds)[..., None]
        dr, dm = _densities(sp)
        od_r = od_r + dr * ds
        od_m = od_m + dm * ds
    return od_r, od_m


def _beta_rayleigh(device):
    return torch.tensor(BETA_RAYLEIGH, dtype=torch.float32, device=device)


def atmosphere_radiance(view_dirs, params: SkyParams):
    """Single-scattered sky radiance along unit view dirs (..., 3)."""
    dev = view_dirs.device
    alt = torch.clamp(params.altitude, min=1.0)
    org = torch.zeros_like(view_dirs) + vec3(0.0, PLANET_RADIUS + alt,
                                             0.0).to(dev)
    d = view_dirs

    t_atmo = _atmosphere_intersect(org, d, ATMOSPHERE_TOP)
    b = dot(org, d)
    c = dot(org, org) - PLANET_RADIUS * PLANET_RADIUS
    disc = b * b - c
    near = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t_ground = torch.where((disc > 0.0) & (near > 0.0), near,
                           torch.full_like(near, math.inf))
    t_end = torch.minimum(t_atmo, t_ground)

    beta_r = _beta_rayleigh(dev) * params.rayleigh_scale
    beta_ms = BETA_MIE_SCATTER * params.mie_scale
    beta_me = (BETA_MIE_SCATTER + BETA_MIE_ABSORB) * params.mie_scale

    mu = dot(d, params.sun_dir.expand(d.shape))
    ph_r = 3.0 / (16.0 * math.pi) * (1.0 + mu * mu)
    g = params.mie_g
    g2 = g * g
    denom = torch.clamp(1.0 + g2 - 2.0 * g * mu, min=1e-6)
    ph_m = (1.0 - g2) / (4.0 * math.pi * denom * torch.sqrt(denom))

    ds = t_end / VIEW_STEPS
    od_r = torch.zeros(d.shape[:-1], device=dev)
    od_m = torch.zeros(d.shape[:-1], device=dev)
    sum_r = torch.zeros(d.shape, device=dev)
    sum_m = torch.zeros(d.shape, device=dev)
    for i in range(VIEW_STEPS):
        p = org + d * ((i + 0.5) * ds)[..., None]
        dr, dm = _densities(p)
        od_r = od_r + dr * ds
        od_m = od_m + dm * ds
        sod_r, sod_m = _optical_depth_to_sun(p, params.sun_dir)
        tau = (beta_r * (od_r + sod_r)[..., None]
               + beta_me * (od_m + sod_m)[..., None])
        attn = torch.exp(-tau)
        sum_r = sum_r + attn * (dr * ds)[..., None]
        sum_m = sum_m + attn * (dm * ds)[..., None]

    radiance = params.sun_intensity * (
        sum_r * beta_r * ph_r[..., None] + sum_m * beta_ms * ph_m[..., None])

    hit_ground = torch.isfinite(t_ground)
    sun_up = torch.clamp(params.sun_dir[1], min=0.0)
    ground = params.ground_albedo * (0.3 + 0.7 * sun_up) \
        * params.sun_intensity * 0.01
    return torch.where(hit_ground[..., None], radiance + ground, radiance)


def transmittance_to_sun(params: SkyParams):
    """Transmittance from the observer toward the sun: (3,)."""
    dev = params.sun_dir.device
    alt = torch.clamp(params.altitude, min=1.0)
    org = vec3(0.0, PLANET_RADIUS + alt, 0.0).to(dev)
    od_r, od_m = _optical_depth_to_sun(org[None, :], params.sun_dir)
    beta_r = _beta_rayleigh(dev) * params.rayleigh_scale
    beta_me = (BETA_MIE_SCATTER + BETA_MIE_ABSORB) * params.mie_scale
    tau = beta_r * od_r[0] + beta_me * od_m[0]
    return torch.exp(-tau)


# ---------------------------------------------------------------------------
# map baking
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SkyMaps:
    sky_map: torch.Tensor      # (H, W, 3) radiance, equal-area
    sun_map: torch.Tensor      # (Sh, Sw, 3) radiance across the sun cone
    sun_dir: torch.Tensor      # (3,)
    sun_basis_t: torch.Tensor  # (3,)
    sun_basis_b: torch.Tensor  # (3,)
    params: SkyParams
    sun_trans: torch.Tensor    # (3,) transmittance toward the sun
    env_fit: torch.Tensor = None  # (2, ENV_FIT_DEG^2, 3) Chebyshev fit


def equal_area_uv_to_dir(uv):
    phi = (uv[..., 0] - 0.5) * 2.0 * math.pi
    y = uv[..., 1] * 2.0 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    return torch.stack([r * torch.cos(phi), y, r * torch.sin(phi)], dim=-1)


def bake_sky_maps(params: SkyParams, sky_res=SKY_RES, sun_res=SUN_RES,
                  model: str = "physical") -> SkyMaps:
    if model != "physical":
        raise NotImplementedError(
            f"sky_model={model!r} is not ported yet (ROADMAP.md, opt-in "
            "shading); only the physical Rayleigh-Mie model is")
    dev = params.sun_dir.device
    h, w = sky_res
    vv, uu = torch.meshgrid(
        (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h,
        (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w,
        indexing="ij")
    dirs = equal_area_uv_to_dir(torch.stack([uu, vv], dim=-1))
    sky = atmosphere_radiance(dirs, params)

    sh, sw = sun_res
    t, bvec = orthonormal_basis(params.sun_dir)
    sy, sx = torch.meshgrid(
        (torch.arange(sh, dtype=torch.float32, device=dev) + 0.5) / sh
        * 2.0 - 1.0,
        (torch.arange(sw, dtype=torch.float32, device=dev) + 0.5) / sw
        * 2.0 - 1.0, indexing="ij")
    r2 = sx * sx + sy * sy
    in_disk = r2 <= 1.0
    mu = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    limb = torch.where(in_disk, 1.0 - 0.6 * (1.0 - mu),
                       torch.zeros_like(mu))
    trans = transmittance_to_sun(params)
    sun_rad = (params.sun_intensity / SUN_DISK_OMEGA) * limb[..., None] \
        * trans
    return SkyMaps(sky, sun_rad, params.sun_dir, t, bvec, params, trans)


# ---------------------------------------------------------------------------
# gather-free environment eval: Chebyshev tensor fit of the baked sky
# ---------------------------------------------------------------------------


def _fit_env_host(sky_map, sun_dir):
    """Luminance-weighted least-squares Chebyshev fit of the baked sky map,
    one coefficient set per hemisphere, solved in numpy float64 (the
    degree-14 system is too ill-conditioned for f32).
    sky_map: (H,W,3); sun_dir: (3,) -> (2, B, 3) float32 numpy."""
    h, w = sky_map.shape[:2]
    sky = np.asarray(sky_map, np.float64)
    sd = np.asarray(sun_dir, np.float64)
    u = (np.arange(w, dtype=np.float64) + 0.5) / w
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    vv, uu = np.meshgrid(v, u, indexing="ij")
    phi_a = (uu - 0.5) * 2.0 * np.pi
    y_e = vv * 2.0 - 1.0
    r = np.sqrt(np.maximum(0.0, 1.0 - y_e * y_e))
    dx, dy, dz = r * np.cos(phi_a), y_e, r * np.sin(phi_a)

    s = np.clip(dy, -1.0, 1.0)
    xs = 2.0 * np.sqrt(np.abs(s)) - 1.0
    hn = np.sqrt(dx * dx + dz * dz)
    sn = np.sqrt(sd[0] ** 2 + sd[2] ** 2)
    c = np.clip((dx * sd[0] + dz * sd[2]) / np.maximum(hn * sn, 1e-8),
                -1.0, 1.0)
    c = np.where((hn < 1e-6) | (sn < 1e-6), 0.0, c)
    up = s >= 0.0

    def cheb(x, deg):
        ts = [np.ones_like(x), x]
        for _ in range(deg - 2):
            ts.append(2.0 * x * ts[-1] - ts[-2])
        return ts[:deg]

    b = ENV_FIT_DEG * ENV_FIT_DEG
    ts = cheb(xs, ENV_FIT_DEG)
    tc = cheb(c, ENV_FIT_DEG)
    phi = np.stack([a * t for a in ts for t in tc], axis=-1).reshape(-1, b)
    yv = sky.reshape(-1, 3)
    lum = np.maximum(yv.mean(axis=-1), 1e-6)
    wgt = 1.0 / (lum + 0.05 * lum.mean())
    upf = up.reshape(-1)

    def solve(mask):
        sw = np.sqrt(wgt * mask)[:, None]
        coef, _, _, _ = np.linalg.lstsq(phi * sw, yv * sw,
                                        rcond=ENV_FIT_RCOND)
        return coef

    out = np.stack([solve(upf.astype(np.float64)),
                    solve((~upf).astype(np.float64))])
    return out.astype(np.float32)


def finalize_sky_maps(maps: SkyMaps) -> SkyMaps:
    """Attach the host-solved environment fit."""
    fit = _fit_env_host(maps.sky_map.cpu().numpy(),
                        maps.sun_dir.cpu().numpy())
    return dataclasses.replace(
        maps, env_fit=torch.from_numpy(fit).to(maps.sky_map.device))


def _cheb_rows(x, deg):
    """Chebyshev polynomials T_0..T_{deg-1} of flat x as (deg, N) rows."""
    ts = [torch.ones_like(x), x]
    for _ in range(deg - 2):
        ts.append(2.0 * x * ts[-1] - ts[-2])
    return torch.stack(ts[:deg], dim=0)


def _env_coords(d, sun_dir):
    s = torch.clamp(d[..., 1], -1.0, 1.0)
    hx, hz = d[..., 0], d[..., 2]
    hn = torch.sqrt(hx * hx + hz * hz)
    sx, sz = sun_dir[0], sun_dir[2]
    sn = torch.sqrt(sx * sx + sz * sz)
    denom = torch.clamp(hn * sn, min=1e-8)
    c = torch.clamp((hx * sx + hz * sz) / denom, -1.0, 1.0)
    c = torch.where((hn < 1e-6) | (sn < 1e-6), torch.zeros_like(c), c)
    return c, s


def env_radiance_fit(maps: SkyMaps, d):
    """Escaped-ray radiance: Chebyshev sky fit + analytic sun disk.

    The tensor-product series is contracted as a small matrix product,
    sum_i T_i(xs) * (sum_j coef[i, j] * T_j(c)) (float32, no TF32), in
    (term, ray) layout, instead of the JAX module's 196-term sequential
    sum: the same series in another summation order."""
    c, s = _env_coords(d, maps.sun_dir)
    s_min = 1.0 / maps.sky_map.shape[0]
    lead = d.shape[:-1]
    c, s = c.reshape(-1), s.reshape(-1)
    deg = ENV_FIT_DEG
    tc = _cheb_rows(c, deg)                                  # (deg, N)
    coef = maps.env_fit.reshape(2, deg, deg, 3)
    halves = []
    for k, xs in enumerate((
            2.0 * torch.sqrt(torch.clamp(s, s_min, 1.0)) - 1.0,
            2.0 * torch.sqrt(torch.clamp(-s, s_min, 1.0)) - 1.0)):
        # g[i, ch, n] = sum_j coef[k, i, j, ch] * T_j(c_n)
        g = (coef[k].permute(0, 2, 1).reshape(deg * 3, deg) @ tc).reshape(
            deg, 3, -1)
        halves.append((_cheb_rows(xs, deg)[:, None, :] * g).sum(0))
    up, dn = halves                                          # (3, N)
    t = torch.clamp((s / s_min + 1.0) * 0.5, 0.0, 1.0)
    w = t * t * (3.0 - 2.0 * t)
    out = (w * up + (1.0 - w) * dn).T.reshape(lead + (3,))
    return torch.clamp(out, min=0.0) + sun_disk_radiance(maps, d)


def sun_disk_radiance(maps: SkyMaps, d):
    """Analytic limb-darkened sun disk radiance along dirs (..., 3)."""
    cos_g = dot(d, maps.sun_dir.expand(d.shape))
    in_cone = cos_g > SUN_COS_THETA_MAX
    sin2 = torch.clamp(1.0 - cos_g * cos_g, min=0.0)
    mu = torch.sqrt(torch.clamp(1.0 - sin2 / SUN_SIN2_MAX, min=0.0))
    limb = 1.0 - 0.6 * (1.0 - mu)
    rad = (maps.params.sun_intensity / SUN_DISK_OMEGA) * limb[..., None] \
        * maps.sun_trans
    return torch.where(in_cone[..., None], rad, torch.zeros_like(rad))
