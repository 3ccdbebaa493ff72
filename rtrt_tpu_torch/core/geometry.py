"""Boxes and the ray-primitive intersectors, batched and branchless (port of
rtrt_tpu/core/geometry.py).  Every test is mask-based over any leading
shape: a miss is hit=False / t=+inf, never an early out.

Primitives are plain tensors: a box lo / hi (..., 3) (the empty box is
(+inf, -inf), the identity of union), a ray org / dir (..., 3) with its
`RayAux`, a triangle v0 / v1 / v2 (..., 3), a sphere center (..., 3) and
radius (...), a plane normal (..., 3) and offset (...) with dot(n, p) =
offset."""

from __future__ import annotations

import dataclasses
import math

import torch

from .precision import GAMMA3
from .vecmath import cross, dot, permute3

RAY_TMIN = 1e-4
INF = math.inf


# ---------------------------------------------------------------------------
# ray auxiliary precomputation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RayAux:
    """Per-ray values every node and leaf test shares: the slab test's
    inv_dir, and the watertight triangle test's axis permutation (kx, ky,
    kz: the largest |component| last, kx / ky swapped where it is
    negative, to keep the winding) and shear (sx, sy, sz)."""

    inv_dir: torch.Tensor  # (..., 3)
    kx: torch.Tensor       # (...,) int64
    ky: torch.Tensor
    kz: torch.Tensor
    sx: torch.Tensor       # (...,) f32
    sy: torch.Tensor
    sz: torch.Tensor


def safe_dir(d, tiny: float = 1e-20):
    """d with each component of magnitude below `tiny` pushed to +-tiny (by
    its sign), so that 1 / d is finite."""
    return torch.where(torch.abs(d) < tiny,
                       torch.where(d >= 0, tiny, -tiny), d)


def make_ray_aux(dir) -> RayAux:
    d = dir
    sd = safe_dir(d)
    inv_dir = 1.0 / sd
    kz = torch.argmax(torch.abs(d), dim=-1)
    kx = (kz + 1) % 3
    ky = (kz + 2) % 3
    neg = torch.gather(d, -1, kz[..., None])[..., 0] < 0.0
    kx, ky = torch.where(neg, ky, kx), torch.where(neg, kx, ky)
    dp = permute3(sd, kx, ky, kz)
    sz = 1.0 / dp[..., 2]
    return RayAux(inv_dir, kx, ky, kz, dp[..., 0] * sz, dp[..., 1] * sz, sz)


# ---------------------------------------------------------------------------
# AABB
# ---------------------------------------------------------------------------


def aabb_union(lo_a, hi_a, lo_b, hi_b):
    return torch.minimum(lo_a, lo_b), torch.maximum(hi_a, hi_b)


def aabb_center(lo, hi):
    return 0.5 * (lo + hi)


def aabb_empty(shape=(), dtype=torch.float32, device=None):
    lo = torch.full(tuple(shape) + (3,), float("inf"), dtype=dtype,
                    device=device)
    return lo, -lo


def ray_aabb(org, inv_dir, lo, hi, t_min=RAY_TMIN, t_max=INF):
    """Slab test: (hit, max(t_near, t_min)).  The far distance is scaled by
    1 + 2 gamma(3) so that grazing rays are not missed, and the near / far
    planes are picked by the direction's sign, so an empty box (+inf, -inf)
    misses."""
    neg = inv_dir < 0.0
    tnear = ((torch.where(neg, hi, lo) - org) * inv_dir).amax(-1)
    tfar = ((torch.where(neg, lo, hi) - org) * inv_dir).amin(-1) \
        * (1.0 + 2.0 * GAMMA3)
    hit = (tnear <= tfar) & (tfar > t_min) & (tnear < t_max)
    return hit, torch.clamp(tnear, min=t_min)


def ray_aabb_pair(org, inv_dir, boxes12, t_min=RAY_TMIN, t_max=INF):
    """Both child boxes of one node row, (..., 12) [Llo, Lhi, Rlo, Rhi]:
    (hitL, tL, hitR, tR)."""
    hl, tl = ray_aabb(org, inv_dir, boxes12[..., 0:3], boxes12[..., 3:6],
                      t_min, t_max)
    hr, tr = ray_aabb(org, inv_dir, boxes12[..., 6:9], boxes12[..., 9:12],
                      t_min, t_max)
    return hl, tl, hr, tr


# ---------------------------------------------------------------------------
# triangle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TriHit:
    hit: torch.Tensor  # (...,) bool
    t: torch.Tensor    # (...,) f32, inf on a miss
    u: torch.Tensor    # barycentric of v1
    v: torch.Tensor    # barycentric of v2


def ray_triangle_watertight(org, aux: RayAux, v0, v1, v2, t_min=RAY_TMIN,
                            t_max=INF) -> TriHit:
    """Watertight double-sided ray / triangle test (Woop, Benthin, Wald,
    JCGT 2013): the edge functions' signs agree along shared edges, so no
    ray passes between two triangles."""
    a = permute3(v0 - org, aux.kx, aux.ky, aux.kz)
    b = permute3(v1 - org, aux.kx, aux.ky, aux.kz)
    c = permute3(v2 - org, aux.kx, aux.ky, aux.kz)
    sx, sy, sz = aux.sx, aux.sy, aux.sz
    ax = a[..., 0] - sx * a[..., 2]
    ay = a[..., 1] - sy * a[..., 2]
    bx = b[..., 0] - sx * b[..., 2]
    by = b[..., 1] - sy * b[..., 2]
    cx = c[..., 0] - sx * c[..., 2]
    cy = c[..., 1] - sy * c[..., 2]
    u = cx * by - cy * bx
    v = ax * cy - ay * cx
    w = bx * ay - by * ax
    same_sign = ((u >= 0) & (v >= 0) & (w >= 0)) \
        | ((u <= 0) & (v <= 0) & (w <= 0))
    det = u + v + w
    t_scaled = u * (sz * a[..., 2]) + v * (sz * b[..., 2]) \
        + w * (sz * c[..., 2])
    # sign-safe range check of t = t_scaled / det
    ts = t_scaled * torch.sign(det)
    absdet = torch.abs(det)
    in_range = (ts > t_min * absdet) & (ts < t_max * absdet)
    hit = same_sign & (det != 0.0) & in_range
    inv_det = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    t = torch.where(hit, t_scaled * inv_det, torch.full_like(det, INF))
    return TriHit(hit, t, v * inv_det, w * inv_det)


def ray_triangle_mt(org, dir, v0, v1, v2, t_min=RAY_TMIN,
                    t_max=INF) -> TriHit:
    """Möller-Trumbore, double-sided (the tests' oracle intersector)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(dir, e2)
    det = dot(e1, p)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = org - v0
    u = dot(tvec, p) * inv_det
    q = cross(tvec, e1)
    v = dot(dir, q) * inv_det
    t = dot(e2, q) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) \
        & (t < t_max)
    return TriHit(hit, torch.where(hit, t, torch.full_like(t, INF)), u, v)


def triangle_normal(v0, v1, v2):
    """Geometric normal (not normalised), counter-clockwise winding."""
    return cross(v1 - v0, v2 - v0)


def triangle_aabb(v0, v1, v2, pad=1e-6):
    """Per-triangle AABB, padded by `pad` on every side."""
    lo = torch.minimum(torch.minimum(v0, v1), v2) - pad
    hi = torch.maximum(torch.maximum(v0, v1), v2) + pad
    return lo, hi


# ---------------------------------------------------------------------------
# sphere / plane
# ---------------------------------------------------------------------------


def ray_sphere(org, dir, center, radius, t_min=RAY_TMIN, t_max=INF):
    """(hit, t) of the nearest root in (t_min, t_max); dir unit length."""
    oc = org - center
    b = dot(oc, dir)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    inf = torch.full_like(t0, INF)
    t = torch.where((t0 > t_min) & (t0 < t_max), t0,
                    torch.where((t1 > t_min) & (t1 < t_max), t1, inf))
    hit = (disc > 0.0) & torch.isfinite(t)
    return hit, torch.where(hit, t, inf)


def ray_plane(org, dir, normal, offset, t_min=RAY_TMIN, t_max=INF):
    """(hit, t) of the plane dot(n, p) = offset."""
    dn = dot(dir, normal)
    ok = torch.abs(dn) > 1e-12
    t = (offset - dot(org, normal)) / torch.where(ok, dn,
                                                  torch.full_like(dn, 1e-12))
    hit = ok & (t > t_min) & (t < t_max)
    return hit, torch.where(hit, t, torch.full_like(t, INF))
