"""The integrator's shared definitions (port of the parts of
rtrt_tpu/render/integrator.py the megakernel path uses).  The wavefront
integrator itself is not ported: the megakernel covers its function."""

from __future__ import annotations

import dataclasses

import torch

RADIANCE_CLAMP = 10.0  # firefly clamp on demodulated radiance


@dataclasses.dataclass
class SceneData:
    """Everything the path tracer reads about the scene."""

    tables: object            # bvh.packet.TraceTables
    materials: object         # render.bsdf.Materials
    sky: object               # render.sky.SkyMaps
    lights: object = None     # render.light.SphereLights or None


@dataclasses.dataclass
class GBuffer:
    """Per-pixel path-trace outputs, image shaped (H, W, ...)."""

    color: torch.Tensor   # (H,W,3) albedo-demodulated radiance
    albedo: torch.Tensor  # (H,W,3)
    normal: torch.Tensor  # (H,W,3)
    depth: torch.Tensor   # (H,W) inf = sky
    motion: torch.Tensor  # (H,W,2) uv motion vector
    mat_id: torch.Tensor  # (H,W) int32, -1 = sky
