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

from ..core.vecmath import (dot, local_to_world, normalize,
                            orthonormal_basis, reflect, refract)
from .sampling import cosine_hemisphere

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


def material_lookup(m: Materials, mat):
    """Per-lane material parameters of material ids `mat` (...,) by a
    where-chain over the (small) table.  Returns (mtype, albedo,
    roughness, ior, f0, emission, textured)."""
    dev = mat.device
    mtype = torch.zeros_like(mat)
    albedo = torch.zeros(mat.shape + (3,), device=dev)
    rough = torch.zeros(mat.shape, device=dev)
    ior = torch.ones(mat.shape, device=dev)
    f0 = torch.zeros(mat.shape + (3,), device=dev)
    emission = torch.zeros(mat.shape + (3,), device=dev)
    textured = torch.zeros(mat.shape, dtype=torch.bool, device=dev)
    for i in range(int(m.mtype.shape[0])):
        sel = mat == i
        sel3 = sel[..., None]
        mtype = torch.where(sel, m.mtype[i].to(mtype.dtype), mtype)
        albedo = torch.where(sel3, m.albedo[i], albedo)
        rough = torch.where(sel, m.roughness[i], rough)
        ior = torch.where(sel, m.ior[i], ior)
        f0 = torch.where(sel3, m.f0[i], f0)
        emission = torch.where(sel3, m.emission[i], emission)
        textured = torch.where(sel, m.textured[i] != 0, textured)
    return mtype, albedo, rough, ior, f0, emission, textured


def fresnel_schlick(cos_theta, f0):
    """Schlick's approximation; f0 (..., 3) with cos_theta (...,), or of
    cos_theta's shape."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    if f0.dim() == cos_theta.dim() + 1:
        return f0 + (1.0 - f0) * (m * m * m * m * m)[..., None]
    return f0 + (1.0 - f0) * m ** 5


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


def ggx_sample_h(n, wo, u, alpha):
    """A visible half vector of the GGX lobe (Heitz 2018 VNDF sampling)
    about n for view wo: (..., 3)."""
    t, b = orthonormal_basis(n)
    vx = dot(wo, t)
    vy = dot(wo, b)
    vz = torch.clamp(dot(wo, n), min=1e-6)
    # stretch the view by alpha (GGX -> the uniform hemisphere)
    vhx, vhy, vhz = alpha * vx, alpha * vy, vz
    inv_len = torch.rsqrt(torch.clamp(vhx * vhx + vhy * vhy + vhz * vhz,
                                      min=1e-20))
    vhx, vhy, vhz = vhx * inv_len, vhy * inv_len, vhz * inv_len
    # orthonormal frame around the stretched view
    lensq = vhx * vhx + vhy * vhy
    invl = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    ok = lensq > 1e-12
    t1x = torch.where(ok, -vhy * invl, torch.ones_like(invl))
    t1y = torch.where(ok, vhx * invl, torch.zeros_like(invl))
    t2x = vhy * 0.0 - vhz * t1y
    t2y = vhz * t1x - vhx * 0.0
    t2z = vhx * t1y - vhy * t1x
    # polar sample, the lower half projected onto the tilted disk
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nhx = p1 * t1x + p2 * t2x + p3 * vhx
    nhy = p1 * t1y + p2 * t2y + p3 * vhy
    nhz = p2 * t2z + p3 * vhz
    # unstretch
    hx, hy, hz = alpha * nhx, alpha * nhy, torch.clamp(nhz, min=1e-6)
    inv_h = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    return t * hx[..., None] + b * hy[..., None] + n * hz[..., None]


def ggx_eval(n, wo, wi, albedo, f0, alpha):
    """GGX reflection f (..., 3) and the VNDF sampling pdf (...,) of wi:
    G1(wo) D / (4 n.wo), the density of `ggx_sample_h`'s reflected lobe."""
    h = normalize(wo + wi)
    n_dot_v = torch.clamp(dot(n, wo), min=0.0)
    n_dot_l = torch.clamp(dot(n, wi), min=0.0)
    n_dot_h = torch.clamp(dot(n, h), min=0.0)
    v_dot_h = torch.clamp(dot(wo, h), min=0.0)
    d = ggx_d(n_dot_h, alpha)
    g = smith_g2(n_dot_v, n_dot_l, alpha)
    f_spec = fresnel_schlick(v_dot_h, f0)
    denom = torch.clamp(4.0 * n_dot_v * n_dot_l, min=1e-6)
    f = f_spec * (d * g / denom)[..., None] * albedo
    pdf = smith_g1(n_dot_v, alpha) * d / torch.clamp(4.0 * n_dot_v,
                                                     min=1e-6)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    return (torch.where(valid[..., None], f, torch.zeros_like(f)),
            torch.where(valid, pdf, torch.zeros_like(pdf)))


@dataclasses.dataclass
class BsdfSample:
    wi: torch.Tensor        # (..., 3)
    weight: torch.Tensor    # (..., 3) f cos / pdf
    pdf: torch.Tensor       # (...,) solid-angle pdf (1 for delta lobes)
    is_delta: torch.Tensor  # (...,) bool: mirror / glass, outside MIS


def _by_type(mtype, lam, mir, gls, ggx):
    """Per-lane select of (..., 3) lobe values by material type (GGX for
    every other type)."""
    t = mtype[..., None]
    return torch.where(t == MAT_LAMBERT, lam, torch.where(
        t == MAT_MIRROR, mir, torch.where(t == MAT_GLASS, gls, ggx)))


def sample_bsdf(mtype, albedo, roughness, ior, f0, n, wo, inside,
                u2) -> BsdfSample:
    """Importance-sample every lobe and keep the lane's type.  n: shading
    normal on wo's side; inside: lanes inside glass (the IOR ratio
    flips)."""
    alpha = torch.clamp(roughness * roughness, min=1e-4)

    wi_lam = local_to_world(cosine_hemisphere(u2), n)
    pdf_lam = torch.clamp(dot(n, wi_lam), min=0.0) * INV_PI

    wi_mir = reflect(-wo, n)

    # glass: stochastic Fresnel reflect / refract
    eta_rel = torch.where(inside, ior, 1.0 / ior)  # n_i / n_t
    cos_i = torch.clamp(dot(wo, n), min=0.0)
    fr = fresnel_dielectric(cos_i, 1.0 / torch.clamp(eta_rel, min=1e-6))
    refr_dir, tir = refract(-wo, n, eta_rel)
    choose_refl = (u2[..., 0] < fr) | tir
    wi_gls = torch.where(choose_refl[..., None], reflect(-wo, n), refr_dir)

    h = ggx_sample_h(n, wo, u2, alpha)
    wi_ggx = reflect(-wo, h)
    f_ggx, pdf_ggx = ggx_eval(n, wo, wi_ggx, albedo, f0, alpha)
    cos_ggx = torch.clamp(dot(n, wi_ggx), min=0.0)
    w_ggx = torch.where(
        (pdf_ggx > 1e-7)[..., None],
        f_ggx * (cos_ggx / torch.clamp(pdf_ggx, min=1e-7))[..., None],
        torch.zeros_like(f_ggx))

    # Lambert, mirror and glass weigh albedo: f / pdf cancels
    wi = _by_type(mtype, wi_lam, wi_mir, wi_gls, wi_ggx)
    weight = _by_type(mtype, albedo, albedo, albedo, w_ggx)
    one = torch.ones_like(pdf_lam)
    pdf = torch.where(mtype == MAT_LAMBERT, pdf_lam,
                      torch.where(mtype == MAT_GGX, pdf_ggx, one))
    is_delta = (mtype == MAT_MIRROR) | (mtype == MAT_GLASS)
    return BsdfSample(normalize(wi), weight, pdf, is_delta)


def eval_bsdf(mtype, albedo, roughness, f0, n, wo, wi):
    """f (..., 3) and pdf (...,) for a given wi (light-sample MIS); delta
    lobes give 0 (light sampling cannot hit them)."""
    alpha = torch.clamp(roughness * roughness, min=1e-4)
    cos_l = torch.clamp(dot(n, wi), min=0.0)
    f_ggx, pdf_ggx = ggx_eval(n, wo, wi, albedo, f0, alpha)
    t = mtype[..., None]
    zero3 = torch.zeros_like(f_ggx)
    f = torch.where(t == MAT_LAMBERT, albedo * INV_PI,
                    torch.where(t == MAT_GGX, f_ggx, zero3))
    pdf = torch.where(mtype == MAT_LAMBERT, cos_l * INV_PI,
                      torch.where(mtype == MAT_GGX, pdf_ggx,
                                  torch.zeros_like(cos_l)))
    valid = cos_l > 0.0
    return (torch.where(valid[..., None], f, zero3),
            torch.where(valid, pdf, torch.zeros_like(pdf)))
