"""Primary-ray generation: thin-lens camera rays + ray cones (port of
rtrt_tpu/render/raygen.py): `generate_rays` over the whole pixel grid
(flat, (N, ...)), `generate_rays_padded` for given pixel ids (the
frame's)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import CameraBasis, pixel_to_dir
from ..core.vecmath import normalize
from ..utils.consts import device_const
from .sampling import concentric_disk


@dataclasses.dataclass
class Rays:
    org: torch.Tensor         # (..., 3)
    dir: torch.Tensor         # (..., 3) unit
    uv: torch.Tensor          # (..., 2) jittered screen uv
    cone_width: torch.Tensor  # (...,) angular width per unit distance


def pixel_grid(width: int, height: int, device="cuda"):
    """Flat pixel coordinates: (N, 2) float32 (x, y) of each pixel's corner,
    row-major, and the (N,) int32 pixel ids that seed the sampler."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    centers = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    ids = torch.arange(width * height, dtype=torch.int32, device=device)
    return centers, ids


def generate_rays(basis: CameraBasis, width: int, height: int,
                  jitter2, lens2) -> Rays:
    """One primary ray per pixel of the grid, flat: jitter2 (N, 2) subpixel
    jitter and lens2 (N, 2) aperture samples in [0, 1), N = width *
    height."""
    aspect = width / height
    centers, _ = pixel_grid(width, height, jitter2.device)
    size = device_const((float(width), float(height)), jitter2.device)
    uv = (centers + jitter2) / size
    d = pixel_to_dir(basis, uv, aspect)
    disk = concentric_disk(lens2) * basis.aperture
    offset = disk[..., 0:1] * basis.right + disk[..., 1:2] * basis.up
    focal_pt = basis.pos + d * basis.focal_dist
    org = basis.pos + offset
    d = normalize(focal_pt - org)
    cone = torch.full(d.shape[:-1], 1.0, device=d.device) \
        * (2.0 * basis.tan_half_fov_y / height)
    return Rays(org, d, uv, cone)


def generate_rays_padded(basis: CameraBasis, width: int, height: int,
                         pixel_ids, jitter2, lens2) -> Rays:
    """One primary ray per entry of pixel_ids (any shape, int), with
    (..., 2) subpixel jitter and aperture samples in [0, 1)."""
    aspect = width / height
    px = (pixel_ids % width).to(torch.float32) + 0.5
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(
        torch.float32) + 0.5
    size = device_const((float(width), float(height)), jitter2.device)
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
