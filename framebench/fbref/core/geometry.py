# Frozen copy of rtrt_tpu_torch/core/geometry.py
# (framebench's plain reference), cut to what framebench's frames reach.
"""Triangle boxes (port of rtrt_tpu/core/geometry.py::triangle_aabb)."""

from __future__ import annotations

import torch


def triangle_aabb(v0, v1, v2, pad=1e-6):
    """Per-triangle AABB, padded by `pad` on every side."""
    lo = torch.minimum(torch.minimum(v0, v1), v2) - pad
    hi = torch.maximum(torch.maximum(v0, v1), v2) + pad
    return lo, hi
