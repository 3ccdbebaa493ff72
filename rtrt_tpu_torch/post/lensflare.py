"""Procedural lens flare: halo, streaks and a ghost chain along the
sun-centre axis (port of rtrt_tpu/post/lensflare.py).  Visibility is a
device scalar multiplying the layer: no host sync."""

from __future__ import annotations

import math

import torch

from ..utils.consts import device_const


def _smooth_circle(d2, radius, soft):
    return torch.clamp(
        1.0 - (torch.sqrt(torch.clamp(d2, min=1e-12)) - radius) / soft,
        0.0, 1.0)


def lens_flare(h: int, w: int, sun_uv, sun_visible, strength,
               row0: int = 0, n: int | None = None):
    """Returns an additive (H,W,3) flare layer.

    sun_uv: (2,) sun position in screen uv; sun_visible: 0-d 0/1 tensor
    (depth-at-sun-pixel test done by the caller); strength: user gain;
    n: the layer's image rows row0 .. row0 + n - 1 only (each clamped to
    the image; default all h)."""
    dev = sun_uv.device
    if n is None:
        ys = torch.arange(h, dtype=torch.float32, device=dev)
    else:
        ys = torch.clamp(torch.arange(row0, row0 + n, device=dev), 0,
                         h - 1).to(torch.float32)
    ys = (ys + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    aspect = w / h
    # aspect-corrected coordinates so circles stay circular
    px = (xx - 0.5) * aspect
    py = yy - 0.5
    sx = (sun_uv[0] - 0.5) * aspect
    sy = sun_uv[1] - 0.5
    ghost_params = [(-0.4, 0.05, (0.4, 0.7, 1.0), 0.25),
                    (-0.8, 0.08, (0.9, 0.5, 1.0), 0.18),
                    (-1.3, 0.03, (0.4, 1.0, 0.6), 0.22),
                    (0.5, 0.10, (1.0, 0.6, 0.4), 0.10),
                    (1.6, 0.14, (0.5, 0.6, 1.0), 0.12)]
    # the layer's colours, copied to the device once
    cols = device_const(((1.0, 0.85, 0.6), (1.0, 0.9, 0.75))
                        + tuple(g[2] for g in ghost_params), dev)

    acc = torch.zeros((ys.shape[0], w, 3), dtype=torch.float32, device=dev)

    # halo around the sun
    d2s = (px - sx) ** 2 + (py - sy) ** 2
    halo = torch.exp(-d2s * 60.0)
    acc = acc + halo[..., None] * cols[0] * 0.8

    # streaks through the sun (horizontal + diagonal)
    for ang, amp in ((0.0, 0.35), (1.5707963, 0.2), (0.7853982, 0.12)):
        ca, sa = math.cos(ang), math.sin(ang)
        along = (px - sx) * ca + (py - sy) * sa
        across = -(px - sx) * sa + (py - sy) * ca
        streak = torch.exp(-across * across * 4000.0) * \
            torch.exp(-along * along * 6.0)
        acc = acc + streak[..., None] * cols[1] * amp

    # ghost chain along the mirrored sun->centre axis
    for k, (t, radius, _, amp) in enumerate(ghost_params):
        gx = -sx * t
        gy = -sy * t
        d2 = (px - gx) ** 2 + (py - gy) ** 2
        ring = _smooth_circle(d2, radius, 0.02) * \
            (1.0 - _smooth_circle(d2, radius * 0.55, 0.03) * 0.6)
        acc = acc + ring[..., None] * cols[2 + k] * (amp * 0.3)

    # fade the whole layer by sun visibility and off-screen distance
    on_screen = torch.clamp(1.5 - 2.0 * torch.sqrt(sx * sx + sy * sy),
                            0.0, 1.0)
    return acc * (strength * sun_visible * on_screen)
