"""Vector helpers on (..., 3) torch tensors (port of the vector part of
rtrt_tpu/core/vecmath.py: what the renderer calls; the matrix and
quaternion helpers serve only the JAX package's content tools)."""

from __future__ import annotations

import torch


def vec3(x, y, z):
    """Stack broadcastable components into a (..., 3) float32 tensor."""
    dev = next((c.device for c in (x, y, z) if torch.is_tensor(c)), None)
    x, y, z = torch.broadcast_tensors(*(torch.as_tensor(
        c, dtype=torch.float32, device=dev) for c in (x, y, z)))
    return torch.stack([x, y, z], dim=-1)


def dot(a, b):
    return (a * b).sum(-1)


def dotk(a, b):
    return (a * b).sum(-1, keepdim=True)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def length_sq(a):
    return dot(a, a)


def distance(a, b):
    return length(a - b)


def lerp(a, b, t):
    return a + (b - a) * t


def normalize(a, eps: float = 1e-20):
    """Safe normalize; zero vectors map to zero (not NaN)."""
    n2 = dotk(a, a)
    inv = torch.where(n2 > eps, torch.reciprocal(torch.sqrt(
        torch.clamp(n2, min=eps))), torch.zeros_like(n2))
    return a * inv


def reflect(d, n):
    """Reflect direction d about normal n (both (..., 3); d points in)."""
    return d - 2.0 * dotk(d, n) * n


def refract(d, n, eta):
    """Refract d through a surface of normal n with relative index eta
    (n_incident / n_transmitted; a tensor of d's leading shape or a
    broadcastable one).  d points toward the surface, n opposes it.
    Returns (direction, total internal reflection); on total internal
    reflection the direction is the reflection."""
    if torch.is_tensor(eta) and eta.dim() == d.dim() - 1:
        eta = eta[..., None]
    cos_i = -dotk(d, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = (sin2_t >= 1.0)[..., 0]
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return torch.where(tir[..., None], reflect(d, n), refr), tir


def permute3(v, kx, ky, kz):
    """Components of (..., 3) v picked by per-element axis indices kx, ky,
    kz (...,) in {0, 1, 2} (selects, as the JAX function)."""
    def pick(k):
        k = k[..., None]
        return torch.where(k == 0, v[..., 0:1],
                           torch.where(k == 1, v[..., 1:2], v[..., 2:3]))
    return torch.cat([pick(kx), pick(ky), pick(kz)], dim=-1)


def orthonormal_basis(n):
    """Branchless Frisvad/Duff tangent frame for unit n: returns (t, b)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def local_to_world(local, n):
    """A (..., 3) direction in the tangent frame of unit n -> world."""
    t, b = orthonormal_basis(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def spherical_to_dir(theta, phi):
    """(theta from +z, phi around z) -> unit vector."""
    st = torch.sin(theta)
    return vec3(st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))
