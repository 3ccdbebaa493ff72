"""Pinhole + thin-lens camera model and reprojection (port of
rtrt_tpu/core/camera.py).

World convention: right-handed, +y up, yaw about +y, pitch about the right
axis.  Screen uv in [0,1]^2 with (0,0) at the top-left pixel corner.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.consts import device_const
from .vecmath import cross, dotk, normalize, vec3


@dataclasses.dataclass
class Camera:
    """Camera state as float32 tensors: pos (3,), the rest 0-d."""

    pos: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor
    fov_y: torch.Tensor
    aperture: torch.Tensor
    focal_dist: torch.Tensor


def make_camera(pos=(0.0, 2.0, -5.0), yaw=0.0, pitch=0.0, fov_y=1.0,
                aperture=0.0, focal_dist=5.0, device="cuda") -> Camera:
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return Camera(f(pos), f(yaw), f(pitch), f(fov_y), f(aperture),
                  f(focal_dist))


@dataclasses.dataclass
class CameraBasis:
    pos: torch.Tensor      # (3,)
    forward: torch.Tensor  # (3,) unit
    right: torch.Tensor    # (3,) unit
    up: torch.Tensor       # (3,) unit
    tan_half_fov_y: torch.Tensor
    aperture: torch.Tensor
    focal_dist: torch.Tensor


def camera_basis(cam: Camera) -> CameraBasis:
    cp, sp = torch.cos(cam.pitch), torch.sin(cam.pitch)
    cy, sy = torch.cos(cam.yaw), torch.sin(cam.yaw)
    forward = vec3(cp * sy, sp, cp * cy).to(cam.pos.device)
    world_up = device_const((0.0, 1.0, 0.0), cam.pos.device)
    right = normalize(cross(forward, world_up))
    up = cross(right, forward)
    return CameraBasis(cam.pos, forward, right, up,
                       torch.tan(0.5 * cam.fov_y), cam.aperture,
                       cam.focal_dist)


def pixel_to_dir(basis: CameraBasis, uv, aspect: float):
    """Screen uv (..., 2) (+ aspect = W/H) -> world-space unit dirs (..., 3)."""
    ndc_x = (uv[..., 0] * 2.0 - 1.0) * aspect * basis.tan_half_fov_y
    ndc_y = (1.0 - uv[..., 1] * 2.0) * basis.tan_half_fov_y
    d = (basis.forward + ndc_x[..., None] * basis.right
         + ndc_y[..., None] * basis.up)
    return normalize(d)


def world_to_screen(basis: CameraBasis, p, aspect: float):
    """World points (..., 3) -> screen uv (..., 2) and view depth (...,)."""
    rel = p - basis.pos
    z = dotk(rel, basis.forward)[..., 0]
    safe_z = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
    x = dotk(rel, basis.right)[..., 0] / (safe_z * basis.tan_half_fov_y
                                          * aspect)
    y = dotk(rel, basis.up)[..., 0] / (safe_z * basis.tan_half_fov_y)
    u = (x + 1.0) * 0.5
    v = (1.0 - y) * 0.5
    return torch.stack([u, v], dim=-1), z


def motion_vector(prev_basis: CameraBasis, cur_uv, world_pos, aspect: float):
    """Screen-space motion uv_prev - uv_cur of static world points; zero
    where the point was behind the previous camera."""
    prev_uv, prev_z = world_to_screen(prev_basis, world_pos, aspect)
    mv = prev_uv - cur_uv
    return torch.where((prev_z > 0.0)[..., None], mv, torch.zeros_like(mv))
