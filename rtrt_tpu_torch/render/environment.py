"""Composed environment of escaped rays: the sky fit, plus an optional star
field and an optional ray-marched ocean (port of
rtrt_tpu/render/environment.py; reference: the dormant sky2 chain,
src/sky2.cuh:75, src/star.cuh:33, src/water.cuh:127).

Escaped rays carry only their direction out of the megakernel, so the
ocean's march starts every lane at its PRIMARY ray's origin (the camera),
as the JAX frame's does.
"""

from __future__ import annotations

import torch

from .sky import SkyMaps, env_radiance_fit
from .stars import star_field
from .water import intersect_ocean, ocean_shade

STAR_INTENSITY = 0.5


def night_visibility(maps: SkyMaps):
    """Star visibility in [0, 1]: fades in as the sun sinks below the
    horizon (full at sun elevation <= -0.1, zero above +0.02)."""
    return torch.clamp((0.02 - maps.sun_dir[1]) / 0.12, 0.0, 1.0)


def env_radiance_scene(maps: SkyMaps, org, d, time: float, *,
                       ocean: bool = False, stars: bool = False):
    """Environment radiance of escaped rays.  org: (..., 3) primary ray
    origins; d: (..., 3) unit escape directions; time: the float32 clock."""
    env = env_radiance_fit(maps, d)
    if stars:
        vis = night_visibility(maps) * STAR_INTENSITY
        above = (d[..., 1] > 0.0).to(torch.float32)
        env = env + star_field(d) * (vis * above)[..., None]
    if ocean:
        hit, t = intersect_ocean(org, d, time)
        # the water reflects the sky fit, sun disk included (the glints)
        shade = ocean_shade(org, d, torch.where(hit, t, 0.0), time,
                            lambda dd: env_radiance_fit(maps, dd))
        env = torch.where(hit[..., None], shade, env)
    return env
