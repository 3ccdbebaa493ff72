# Frozen copy of rtrt_tpu_torch/core/vecmath.py
# (framebench's plain reference).
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


def normalize(a, eps: float = 1e-20):
    """Safe normalize; zero vectors map to zero (not NaN)."""
    n2 = dotk(a, a)
    inv = torch.where(n2 > eps, torch.reciprocal(torch.sqrt(
        torch.clamp(n2, min=eps))), torch.zeros_like(n2))
    return a * inv


def orthonormal_basis(n):
    """Branchless Frisvad/Duff tangent frame for unit n: returns (t, b)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt
