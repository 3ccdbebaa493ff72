"""Axis-aligned boxes (port of the parts of rtrt_tpu/core/geometry.py that
the LBVH build uses; the ray-primitive intersectors serve the wavefront
integrator, which is not ported).  Boxes are (..., 3) lo / hi tensors; the
empty box is (+inf, -inf), the identity of union."""

from __future__ import annotations

import torch


def aabb_union(lo_a, hi_a, lo_b, hi_b):
    return torch.minimum(lo_a, lo_b), torch.maximum(hi_a, hi_b)


def aabb_center(lo, hi):
    return 0.5 * (lo + hi)


def aabb_empty(shape=(), dtype=torch.float32, device=None):
    lo = torch.full(tuple(shape) + (3,), float("inf"), dtype=dtype,
                    device=device)
    return lo, -lo


def triangle_aabb(v0, v1, v2, pad=1e-6):
    """Per-triangle AABB, padded by `pad` on every side."""
    lo = torch.minimum(torch.minimum(v0, v1), v2) - pad
    hi = torch.maximum(torch.maximum(v0, v1), v2) + pad
    return lo, hi
