"""Primary-ray generation: thin-lens camera rays + ray cones (port of
rtrt_tpu/render/raygen.py::generate_rays_padded)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import CameraBasis, pixel_to_dir
from ..core.vecmath import normalize
from .sampling import concentric_disk


@dataclasses.dataclass
class Rays:
    org: torch.Tensor         # (..., 3)
    dir: torch.Tensor         # (..., 3) unit
    uv: torch.Tensor          # (..., 2) jittered screen uv
    cone_width: torch.Tensor  # (...,) angular width per unit distance


def generate_rays_padded(basis: CameraBasis, width: int, height: int,
                         pixel_ids, jitter2, lens2) -> Rays:
    """One primary ray per entry of pixel_ids (any shape, int), with
    (..., 2) subpixel jitter and aperture samples in [0, 1)."""
    aspect = width / height
    px = (pixel_ids % width).to(torch.float32) + 0.5
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(
        torch.float32) + 0.5
    size = torch.tensor([width, height], dtype=torch.float32).to(
        jitter2.device, non_blocking=True)
    uv = (torch.stack([px, py], dim=-1) + jitter2 - 0.5) / size
    d = pixel_to_dir(basis, uv, aspect)
    disk = concentric_disk(lens2) * basis.aperture
    offset = disk[..., 0:1] * basis.right + disk[..., 1:2] * basis.up
    focal_pt = basis.pos + d * basis.focal_dist
    org = basis.pos + offset
    d = normalize(focal_pt - org)
    cone = torch.full(d.shape[:-1], 1.0, device=d.device) \
        * (2.0 * basis.tan_half_fov_y / height)
    return Rays(org, d, uv, cone)
