"""Vector, matrix and quaternion helpers on torch tensors (port of
rtrt_tpu/core/vecmath.py): vectors (..., 3) with the components on the
trailing axis, matrices (..., 3, 3) / (..., 4, 4), quaternions (..., 4) as
(w, x, y, z)."""

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


def clamp(x, lo=0.0, hi=1.0):
    return torch.clamp(x, lo, hi)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


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


def project(a, b):
    """Project a onto b."""
    return b * (dotk(a, b) / torch.clamp(dotk(b, b), min=1e-20))


def abs_max_component_index(v):
    """Index (0/1/2) of the largest-|.| component: (...,) int32 (the first
    on a tie, as argmax)."""
    return torch.argmax(torch.abs(v), dim=-1).to(torch.int32)


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


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------


def matvec(m, v):
    """(..., N, N) @ (..., N) -> (..., N)."""
    return torch.einsum("...ij,...j->...i", m, v)


def mat3_from_axis_angle(axis, angle):
    """Rodrigues rotation matrix, axis (..., 3) unit, angle (...,)
    radians."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c, s = torch.cos(angle), torch.sin(angle)
    t = 1.0 - c
    rows = [
        torch.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y], -1),
        torch.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x], -1),
        torch.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c], -1),
    ]
    return torch.stack(rows, dim=-2)


def rotate_axis_angle(v, axis, angle):
    return matvec(mat3_from_axis_angle(axis, angle), v)


def mat4_translate(t):
    t = torch.as_tensor(t, dtype=torch.float32)
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[:3, 3] = t
    return m


def mat4_scale(s):
    s = torch.as_tensor(s, dtype=torch.float32)
    return torch.diag(torch.cat([torch.broadcast_to(s, (3,)),
                                 torch.ones(1, device=s.device)]))


def mat4_from_mat3(m3):
    m3 = torch.as_tensor(m3, dtype=torch.float32)
    m = torch.eye(4, dtype=torch.float32, device=m3.device)
    m[:3, :3] = m3
    return m


def transform_point(m4, p):
    """Apply a (..., 4, 4) homogeneous transform to (..., 3) points."""
    return matvec(m4[..., :3, :3], p) + m4[..., :3, 3]


def transform_dir(m4, d):
    return matvec(m4[..., :3, :3], d)


# ---------------------------------------------------------------------------
# quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_from_axis_angle(axis, angle):
    axis = torch.as_tensor(axis, dtype=torch.float32)
    half = torch.as_tensor(angle, dtype=torch.float32,
                           device=axis.device) * 0.5
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate (..., 3) v by unit quaternion q."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


# ---------------------------------------------------------------------------
# compensated (Kahan) accumulation
# ---------------------------------------------------------------------------


def kahan_add(total, comp, value):
    """One Kahan step; returns (new_total, new_comp)."""
    y = value - comp
    t = total + y
    return t, (t - total) - y
