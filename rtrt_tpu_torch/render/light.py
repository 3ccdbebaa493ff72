"""Light definitions and the analytic sun pdf (port of the parts of
rtrt_tpu/render/light.py the slice uses)."""

from __future__ import annotations

import dataclasses

import torch

from .sky import SUN_CONE_PDF, SUN_COS_THETA_MAX


@dataclasses.dataclass
class SphereLights:
    center: torch.Tensor    # (L,3)
    radius: torch.Tensor    # (L,)
    emission: torch.Tensor  # (L,3)

    def to(self, device) -> "SphereLights":
        return SphereLights(self.center.to(device), self.radius.to(device),
                            self.emission.to(device))


def sun_pdf_dir(maps, d):
    """Analytic pdf that the sun-cone NEE strategy produces dirs d (..., 3)."""
    cos_g = (d * maps.sun_dir).sum(-1)
    in_cone = cos_g > SUN_COS_THETA_MAX
    up = maps.sun_dir[1] > -0.05
    pdf = torch.full_like(cos_g, SUN_CONE_PDF)
    return torch.where(in_cone & up, pdf, torch.zeros_like(cos_g))
