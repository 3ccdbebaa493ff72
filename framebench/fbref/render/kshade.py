# Frozen copy of rtrt_tpu_torch/render/kshade.py
# (framebench's plain reference).
"""Component-form shading library of the path-trace megakernel (port of
rtrt_tpu/render/kshade.py).

Two forms of the same math:
  * this module: torch tensors, used by the plain megakernel
    (render/megakernel.py::megakernel_trace_plain) and the tests;
  * csrc/kshade.cuh: per-thread CUDA ``__device__`` functions, used by the
    megakernel K2.
Each function here mirrors its JAX twin operation for operation (same
constants, same RNG dims, same selects); tests/test_torch_kshade.py holds
them against the JAX module on random inputs.
"""

from __future__ import annotations

import math

import torch

from .bsdf import (INV_PI, MAT_GGX, MAT_GLASS, MAT_LAMBERT, MAT_MIRROR,
                   fresnel_dielectric, ggx_d, smith_g1, smith_g2)
from .proctex import _hash3 as _hash3_c  # the soil's lattice hash
from .sampling import (TWO_PI, _dim_shift, pixel_seed, sobol_owen_pair,
                       u32)
from .sky import SUN_DISK_OMEGA, SUN_DISK_PDF, SUN_COS_THETA_MAX, SUN_SIN2_MAX

MAT_ROW = 16


def _w(m, a, b):
    """torch.where that accepts Python scalars on either side."""
    if not torch.is_tensor(a):
        a = torch.full_like(b if torch.is_tensor(b) else m, a,
                            dtype=torch.float32)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(m, a, b)


class V3:
    """A 3-vector held as separate component tensors of one shape."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __iter__(self):
        return iter((self.x, self.y, self.z))


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vnormalize(a: V3) -> V3:
    n2 = vdot(a, a)
    inv = _w(n2 > 1e-20, torch.reciprocal(torch.sqrt(
        torch.clamp(n2, min=1e-20))), 0.0)
    return a * inv


def vwhere(m, a: V3, b: V3) -> V3:
    return V3(_w(m, a.x, b.x), _w(m, a.y, b.y), _w(m, a.z, b.z))


def vlum(a: V3):
    return a.x * 0.2126 + a.y * 0.7152 + a.z * 0.0722


def reflect_c(d: V3, n: V3) -> V3:
    k = 2.0 * vdot(d, n)
    return d - n * k


def refract_c(d: V3, n: V3, eta):
    cos_i = -vdot(d, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = d * eta + n * (eta * cos_i - cos_t)
    return vwhere(tir, reflect_c(d, n), refr), tir


def orthonormal_basis_c(n: V3):
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = V3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def local_to_world_c(local: V3, n: V3) -> V3:
    t, b = orthonormal_basis_c(n)
    return t * local.x + b * local.y + n * local.z


# ---------------------------------------------------------------------------
# RNG
# ---------------------------------------------------------------------------


def rand2_c(pixel_id, frame, dim_pair):
    """(u1, u2) LD pair for integer pixel ids, frame and dim pair (ints or
    integer tensors; all-int arguments give Python floats)."""
    return sobol_owen_pair(u32(frame),
                           pixel_seed(u32(pixel_id), u32(dim_pair)))


# The blue-noise pair splits into a part shared by every pixel of a launch,
# (u1, u2, sx, sy) of (frame, dim), and a per-pixel rotation.  K2 computes
# the shared part once per launch into a table in shared memory
# (csrc/kshade.cuh::sampler_entry); these are its torch twins.  The
# megakernel draws dims base + 2 * seg for these bases: BSDF, light
# sample, shadow-or-scatter choice, sphere-light pick.
SAMPLER_BASES = (2, 64, 128, 192)


def sampler_dims(segments: int) -> list:
    """The dims of the table's slots, slot b * segments + s holding dim
    SAMPLER_BASES[b] + 2 s."""
    return [b + 2 * s for b in SAMPLER_BASES for s in range(segments)]


def sampler_entry(frame, dim_pair) -> tuple:
    """(u1, u2, sx, sy) of (frame, dim) as Python floats (float32 values):
    the shared sequence's pair and the dim's Cranley-Patterson shift."""
    return rand2_c(0, frame, dim_pair) + _dim_shift(dim_pair)


def sampler_table(frame, segments: int) -> torch.Tensor:
    """(4 * segments, 4) float32 table of sampler_entry over
    sampler_dims(segments)."""
    return torch.tensor([sampler_entry(frame, d)
                         for d in sampler_dims(segments)],
                        dtype=torch.float32)


def bn_rotate(entry, bnx, bny):
    """The per-pixel part: the entry's pair rotated by the mask offsets
    (bnx, bny) plus the entry's shift."""
    u1, u2, sx, sy = entry
    ox = bnx + sx
    oy = bny + sy
    u = u1 + (ox - torch.floor(ox))
    v = u2 + (oy - torch.floor(oy))
    return u - torch.floor(u), v - torch.floor(v)


# ---------------------------------------------------------------------------
# warps
# ---------------------------------------------------------------------------


def concentric_disk_c(u1, u2):
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * (oy / _w(ox == 0, 1.0, ox)),
        (math.pi / 2.0) - (math.pi / 4.0) * (ox / _w(oy == 0, 1.0, oy)))
    px = r * torch.cos(theta)
    py = r * torch.sin(theta)
    return _w(zero, 0.0, px), _w(zero, 0.0, py)


def cosine_hemisphere_c(u1, u2) -> V3:
    dx, dy = concentric_disk_c(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    return V3(dx, dy, z)


def uniform_cone_c(u1, u2, cos_theta_max) -> V3:
    cos_t = (1.0 - u1) + u1 * cos_theta_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2
    return V3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t)


def power_heuristic_c(f_pdf, g_pdf):
    f, g = f_pdf, g_pdf
    return _w(f + g > 0.0, (f * f) / torch.clamp(f * f + g * g, min=1e-20),
              0.0)


# ---------------------------------------------------------------------------
# GGX + unified BSDF
# ---------------------------------------------------------------------------


def fresnel_schlick_c(cos_theta, f0: V3) -> V3:
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m5 = m * m * m * m * m
    return V3(f0.x + (1.0 - f0.x) * m5, f0.y + (1.0 - f0.y) * m5,
              f0.z + (1.0 - f0.z) * m5)


def ggx_sample_h_c(n: V3, wo: V3, u1, u2, alpha) -> V3:
    """VNDF visible-half-vector sample (Heitz 2018)."""
    t, b = orthonormal_basis_c(n)
    vx = vdot(wo, t)
    vy = vdot(wo, b)
    vz = torch.clamp(vdot(wo, n), min=1e-6)
    vhx, vhy, vhz = alpha * vx, alpha * vy, vz
    inv_len = torch.rsqrt(torch.clamp(vhx * vhx + vhy * vhy + vhz * vhz,
                                      min=1e-20))
    vhx, vhy, vhz = vhx * inv_len, vhy * inv_len, vhz * inv_len
    lensq = vhx * vhx + vhy * vhy
    invl = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    ok = lensq > 1e-12
    t1x = _w(ok, -vhy * invl, 1.0)
    t1y = _w(ok, vhx * invl, 0.0)
    t2x = -vhz * t1y
    t2y = vhz * t1x
    t2z = vhx * t1y - vhy * t1x
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nhx = p1 * t1x + p2 * t2x + p3 * vhx
    nhy = p1 * t1y + p2 * t2y + p3 * vhy
    nhz = p2 * t2z + p3 * vhz
    hx, hy, hz = alpha * nhx, alpha * nhy, torch.clamp(nhz, min=1e-6)
    inv_h = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    return t * hx + b * hy + n * hz


def ggx_eval_c(n: V3, wo: V3, wi: V3, albedo: V3, f0: V3, alpha):
    """GGX f and the VNDF sampling pdf of wi."""
    h = vnormalize(wo + wi)
    n_dot_v = torch.clamp(vdot(n, wo), min=0.0)
    n_dot_l = torch.clamp(vdot(n, wi), min=0.0)
    n_dot_h = torch.clamp(vdot(n, h), min=0.0)
    v_dot_h = torch.clamp(vdot(wo, h), min=0.0)
    d = ggx_d(n_dot_h, alpha)
    g = smith_g2(n_dot_v, n_dot_l, alpha)
    f_spec = fresnel_schlick_c(v_dot_h, f0)
    scale = d * g / torch.clamp(4.0 * n_dot_v * n_dot_l, min=1e-6)
    f = f_spec * albedo * scale
    pdf = smith_g1(n_dot_v, alpha) * d / torch.clamp(4.0 * n_dot_v, min=1e-6)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    return vwhere(valid, f, V3(0.0, 0.0, 0.0)), _w(valid, pdf, 0.0)


def sample_bsdf_c(mtype, albedo: V3, roughness, ior, f0: V3, n: V3, wo: V3,
                  inside, u1, u2):
    """Branchless BSDF sample over material types.
    Returns (wi V3, weight V3, pdf, is_delta)."""
    alpha = torch.clamp(roughness * roughness, min=1e-4)

    wi_lam = local_to_world_c(cosine_hemisphere_c(u1, u2), n)
    pdf_lam = torch.clamp(vdot(n, wi_lam), min=0.0) * INV_PI

    wi_mir = reflect_c(-wo, n)

    eta_rel = torch.where(inside, ior, 1.0 / ior)
    cos_i = torch.clamp(vdot(wo, n), min=0.0)
    fr = fresnel_dielectric(cos_i, 1.0 / torch.clamp(eta_rel, min=1e-6))
    refr_dir, tir = refract_c(-wo, n, eta_rel)
    choose_refl = (u1 < fr) | tir
    wi_gls = vwhere(choose_refl, reflect_c(-wo, n), refr_dir)

    h = ggx_sample_h_c(n, wo, u1, u2, alpha)
    wi_ggx = reflect_c(-wo, h)
    f_ggx, pdf_ggx = ggx_eval_c(n, wo, wi_ggx, albedo, f0, alpha)
    cos_ggx = torch.clamp(vdot(n, wi_ggx), min=0.0)
    ggx_ok = pdf_ggx > 1e-7
    w_ggx = vwhere(ggx_ok, f_ggx * (cos_ggx / torch.clamp(pdf_ggx, min=1e-7)),
                   V3(0.0, 0.0, 0.0))

    lam, mir, gls = mtype == MAT_LAMBERT, mtype == MAT_MIRROR, \
        mtype == MAT_GLASS
    wi = vwhere(lam, wi_lam, vwhere(mir, wi_mir, vwhere(gls, wi_gls, wi_ggx)))
    weight = vwhere(lam, albedo, vwhere(mir, albedo,
                                        vwhere(gls, albedo, w_ggx)))
    pdf = torch.where(lam, pdf_lam, _w(mtype == MAT_GGX, pdf_ggx, 1.0))
    is_delta = mir | gls
    return vnormalize(wi), weight, pdf, is_delta


def eval_bsdf_c(mtype, albedo: V3, roughness, f0: V3, n: V3, wo: V3,
                wi: V3):
    alpha = torch.clamp(roughness * roughness, min=1e-4)
    cos_l = torch.clamp(vdot(n, wi), min=0.0)
    f_lam = albedo * INV_PI
    pdf_lam = cos_l * INV_PI
    f_ggx, pdf_ggx = ggx_eval_c(n, wo, wi, albedo, f0, alpha)
    zero = V3(0.0, 0.0, 0.0)
    lam, ggx = mtype == MAT_LAMBERT, mtype == MAT_GGX
    f = vwhere(lam, f_lam, vwhere(ggx, f_ggx, zero))
    pdf = torch.where(lam, pdf_lam, _w(ggx, pdf_ggx, 0.0))
    valid = cos_l > 0.0
    return vwhere(valid, f, zero), _w(valid, pdf, 0.0)


# ---------------------------------------------------------------------------
# sun NEE (constants host-folded in float64, see render/sky.py)
# ---------------------------------------------------------------------------


class SunParamsC:
    """Sun state unpacked from the 16-float sun vector (pack_sun_params)."""

    def __init__(self, vec):
        r = lambda i: vec[i]
        self.dir = V3(r(0), r(1), r(2))
        self.t = V3(r(3), r(4), r(5))
        self.b = V3(r(6), r(7), r(8))
        self.trans = V3(r(9), r(10), r(11))
        self.intensity = r(12)


def sun_disk_radiance_c(sun: SunParamsC, d: V3) -> V3:
    cos_g = vdot(d, sun.dir)
    in_cone = cos_g > SUN_COS_THETA_MAX
    sin2 = torch.clamp(1.0 - cos_g * cos_g, min=0.0)
    mu = torch.sqrt(torch.clamp(1.0 - sin2 / SUN_SIN2_MAX, min=0.0))
    limb = 1.0 - 0.6 * (1.0 - mu)
    s = (sun.intensity / SUN_DISK_OMEGA) * limb
    return vwhere(in_cone, sun.trans * s, V3(0.0, 0.0, 0.0))


def sample_sun_c(sun: SunParamsC, u1, u2):
    """Uniform-cone sun sample: returns (wi V3, radiance V3, pdf)."""
    local = uniform_cone_c(u1, u2, SUN_COS_THETA_MAX)
    wi = vnormalize(sun.t * local.x + sun.b * local.y + sun.dir * local.z)
    rad = sun_disk_radiance_c(sun, wi)
    up = sun.dir.y > -0.05
    rad = vwhere(up, rad, V3(0.0, 0.0, 0.0))
    pdf = torch.full_like(wi.x, SUN_DISK_PDF)
    return wi, rad, pdf


# ---------------------------------------------------------------------------
# procedural soil texture
# ---------------------------------------------------------------------------


def value_noise3_c(px, py, pz, seed: int):
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = (f.to(torch.int64) for f in (fx, fy, fz))
    rx, ry, rz = px - fx, py - fy, pz - fz
    wx = rx * rx * rx * (rx * (rx * 6.0 - 15.0) + 10.0)
    wy = ry * ry * ry * (ry * (ry * 6.0 - 15.0) + 10.0)
    wz = rz * rz * rz * (rz * (rz * 6.0 - 15.0) + 10.0)

    def h(dx, dy, dz):
        return _hash3_c(ix + dx, iy + dy, iz + dz, seed)

    c000, c100, c010, c110 = h(0, 0, 0), h(1, 0, 0), h(0, 1, 0), h(1, 1, 0)
    c001, c101, c011, c111 = h(0, 0, 1), h(1, 0, 1), h(0, 1, 1), h(1, 1, 1)
    x00 = c000 + (c100 - c000) * wx
    x10 = c010 + (c110 - c010) * wx
    x01 = c001 + (c101 - c001) * wx
    x11 = c011 + (c111 - c011) * wx
    y0 = x00 + (x10 - x00) * wy
    y1 = x01 + (x11 - x01) * wy
    return y0 + (y1 - y0) * wz


def fbm3_filtered_c(px, py, pz, cone_width, octaves: int, base_freq: float,
                    seed: int, gain: float = 0.5):
    total = torch.zeros_like(px)
    norm, amp, freq = 0.0, 1.0, base_freq
    for k in range(octaves):
        fade = torch.clamp(1.0 - cone_width * freq * 1.5, 0.0, 1.0)
        n = value_noise3_c(px * freq, py * freq, pz * freq, seed + k * 131)
        total = total + amp * (0.5 + (n - 0.5) * fade)
        norm += amp
        amp *= gain
        freq *= 2.0
    return total / norm


def soil_shading_c(pos: V3, ns: V3, cone_width, world_scale: float = 0.35):
    """Procedural soil -> (albedo*ao V3, roughness, bumped normal V3)."""
    px, py, pz = pos.x * world_scale, pos.y * world_scale, pos.z * world_scale
    cw = cone_width * world_scale
    h = fbm3_filtered_c(px, py, pz, cw, 4, 1.0, seed=101)
    detail = fbm3_filtered_c(px, py, pz, cw, 3, 6.0, seed=202)

    t = torch.clamp(h * 1.4 - 0.2, 0.0, 1.0)
    alb = V3(0.23, 0.15, 0.09) * (1.0 - t) + V3(0.42, 0.30, 0.18) * t
    t2 = torch.clamp(detail * 1.2 - 0.3, 0.0, 1.0)
    alb = alb * (1.0 - 0.4 * t2) + V3(0.55, 0.47, 0.35) * (0.4 * t2)
    ao = torch.clamp(0.55 + 0.45 * h, 0.0, 1.0)

    rough = torch.clamp(0.55 + 0.4 * detail + 0.15 * (1.0 - h), 0.05, 1.0)

    bump_fade = torch.clamp(1.0 - cw * 8.0, 0.0, 1.0)
    bx = fbm3_filtered_c(px + 17.17, py + 17.17, pz + 17.17, cw, 2, 5.0,
                         seed=303)
    by = fbm3_filtered_c(px + 29.29, py + 29.29, pz + 29.29, cw, 2, 5.0,
                         seed=404)
    bz = fbm3_filtered_c(px + 43.43, py + 43.43, pz + 43.43, cw, 2, 5.0,
                         seed=505)
    bump = V3(bx - 0.5, by - 0.5, bz - 0.5)
    n2 = vnormalize(ns + bump * (0.8 * bump_fade))
    return alb * ao, rough, n2


# ---------------------------------------------------------------------------
# material rows, normals, sphere lights
# ---------------------------------------------------------------------------


def pack_materials_rows(materials) -> torch.Tensor:
    """Materials -> (M, MAT_ROW) f32 rows:
    [0]=mtype [1:4]=albedo [4:7]=emission [7]=roughness [8]=ior [9:12]=f0
    [12]=textured."""
    m = materials.mtype.shape[0]
    f = lambda x: x.to(torch.float32)
    return torch.cat([
        f(materials.mtype)[:, None], f(materials.albedo),
        f(materials.emission), f(materials.roughness)[:, None],
        f(materials.ior)[:, None], f(materials.f0),
        f(materials.textured)[:, None],
        torch.zeros((m, MAT_ROW - 13), device=materials.mtype.device)],
        dim=1).contiguous()


def material_select_c(mat_rows, mat):
    """Resolve material ids (int tensor) against the (M, MAT_ROW) rows.
    Returns (mtype i64, albedo V3, rough, ior, f0 V3, emission V3,
    textured bool); ids outside [0, M) get the zero material (ior 1)."""
    n = mat_rows.shape[0]
    ok = (mat >= 0) & (mat < n)
    r = mat_rows[torch.where(ok, mat, torch.zeros_like(mat)).long()]
    col = lambda k: _w(ok, r[..., k], 0.0)
    return (col(0).to(torch.int64), V3(col(1), col(2), col(3)), col(7),
            _w(ok, r[..., 8], 1.0), V3(col(9), col(10), col(11)),
            V3(col(4), col(5), col(6)), col(12) != 0.0)


def orient_normals_c(ns_raw: V3, ng_raw: V3, wo: V3):
    ng = vnormalize(ng_raw)
    ns = vnormalize(ns_raw)
    flip = torch.sign(vdot(ng, wo))
    flip = _w(flip == 0.0, 1.0, flip)
    ng = ng * flip
    ns = ns * torch.sign(vdot(ns, ng))
    ns = vwhere(vdot(ns, wo) > 0.0, ns, ng)
    return ns, ng
