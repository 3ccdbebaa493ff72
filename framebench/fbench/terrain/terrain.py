# Frozen copy of rtrt_tpu_torch/content/terrain.py (the numpy density field
# only; the native C++ generator of large worlds is left out).
"""Procedural voxel terrain: Perlin-driven density field in 16^3 chunks
(reference: src/terrain.{h,cpp}, 16x16x16 chunk heightmap from 3D Perlin at
terrain.cpp:5-45).  The mesher places surface vertices sub-voxel on the
continuous density field."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .perlin import Perlin

CHUNK = 16


class VoxelWorld(NamedTuple):
    """density: (X+1, Y+1, Z+1) corner-sampled field, >0 inside ground."""

    density: np.ndarray
    chunks_x: int
    chunks_y: int
    chunks_z: int


def terrain_density(p: Perlin, xs, ys, zs, height_scale=6.0):
    """Signed density: positive below the heightfield surface.  xs/ys/zs:
    broadcastable world coordinates (y up)."""
    h = p.fbm3(xs * 0.05, np.zeros_like(np.asarray(xs, np.float64)),
               zs * 0.05, octaves=4) * height_scale
    return (h - ys).astype(np.float32)


def generate_world(chunks_x=4, chunks_y=2, chunks_z=4, seed=7,
                   height_scale=6.0) -> VoxelWorld:
    """Sample the density field over a chunk grid (corner lattice), the
    world centred on the origin."""
    nx, ny, nz = chunks_x * CHUNK, chunks_y * CHUNK, chunks_z * CHUNK
    ox, oy, oz = -nx / 2, -ny / 2, -nz / 2
    p = Perlin(seed)
    xs = np.arange(nx + 1, dtype=np.float64) + ox
    ys = np.arange(ny + 1, dtype=np.float64) + oy
    zs = np.arange(nz + 1, dtype=np.float64) + oz
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    density = terrain_density(p, gx, gy, gz, height_scale)
    return VoxelWorld(density, chunks_x, chunks_y, chunks_z)


def world_origin(world: VoxelWorld):
    return (-world.chunks_x * CHUNK / 2.0,
            -world.chunks_y * CHUNK / 2.0,
            -world.chunks_z * CHUNK / 2.0)
