"""Color helpers (port of rtrt_tpu/core/color.py::luminance)."""

from __future__ import annotations

LUMA = (0.2126, 0.7152, 0.0722)  # Rec.709


def luminance(c):
    """Rec.709 relative luminance of linear RGB: (..., 3) -> (...,)."""
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]
