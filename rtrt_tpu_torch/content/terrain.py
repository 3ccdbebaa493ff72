"""Procedural voxel terrain: Perlin-driven density field in 16^3 chunks.

Counterpart of the reference's terrain generator
(reference: src/terrain.{h,cpp} — 16x16x16 chunk heightmap from 3D Perlin
at terrain.cpp:5-45, chunk grid with neighbor queries + border sentinel
at terrain.cpp:60-160).

We keep the chunked layout and the solid/empty voxel query API, but also
expose the continuous *density* field so the mesher can place surface
vertices sub-voxel (smooth terrain instead of template blocks).

Copy of rtrt_tpu/content/terrain.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .perlin import Perlin

CHUNK = 16
BORDER_SENTINEL = 0xFFFF  # out-of-world queries (reference: terrain.cpp:60-160)


class VoxelWorld(NamedTuple):
    """`chunks` grid of CHUNK^3 occupancy + the sampled density volume.

    density: (X+1, Y+1, Z+1) corner-sampled field, >0 inside ground.
    solid:   (X, Y, Z) uint8 voxel occupancy (cell solid if its center
             density > 0).
    """

    density: np.ndarray
    solid: np.ndarray
    chunks_x: int
    chunks_y: int
    chunks_z: int

    def voxel(self, x, y, z):
        """Occupancy query with the reference's out-of-bounds sentinel."""
        s = self.solid
        inside = (0 <= x < s.shape[0]) and (0 <= y < s.shape[1]) \
            and (0 <= z < s.shape[2])
        return int(s[x, y, z]) if inside else BORDER_SENTINEL


def terrain_density(p: Perlin, xs, ys, zs, height_scale=6.0, cave_scale=0.0):
    """Signed density: positive below the heightfield surface.

    xs/ys/zs: broadcastable world coordinates (y up).
    """
    h = p.fbm3(xs * 0.05, np.zeros_like(np.asarray(xs, np.float64)),
               zs * 0.05, octaves=4) * height_scale
    d = (h - ys).astype(np.float32)
    if cave_scale > 0.0:
        d -= cave_scale * np.maximum(
            p.fbm3(xs * 0.12, ys * 0.12, zs * 0.12, octaves=3), 0.0)
    return d


def generate_world(chunks_x=4, chunks_y=2, chunks_z=4, seed=7,
                   height_scale=6.0, prefer_native=None) -> VoxelWorld:
    """Sample the density field over a chunk grid (corner lattice).

    prefer_native=None auto-selects: worlds of >= 2^21 cells route through
    the native C++ density kernel (rtrt_native.cpp::rtrt_terrain_density —
    the numpy fbm over an 18M-point lattice costs ~10 min at the ~1M-tri
    scene scale; the C++ twin does it in ~1 s).  The native Perlin uses a
    different permutation RNG, so small/benchmark-pinned worlds keep the
    numpy field (bit-identical scenes across rounds) and only the large
    envelope scenes switch."""
    nx, ny, nz = chunks_x * CHUNK, chunks_y * CHUNK, chunks_z * CHUNK
    # center the world on the origin; y spans [-CHUNK*cy/2, +...]
    ox, oy, oz = -nx / 2, -ny / 2, -nz / 2
    if prefer_native is None:
        prefer_native = nx * ny * nz >= 2 ** 21
    if prefer_native:
        from . import native
        if native.available():
            # ADVICE r3: the native Perlin uses a different permutation
            # RNG than the numpy path, so geometry (and bench numbers)
            # differ between generators — always say which one ran
            import sys
            print(f"[terrain] native C++ generator: {nx}x{ny}x{nz} cells "
                  f"seed={seed}", file=sys.stderr, flush=True)
            density = native.terrain_density(
                nx, ny, nz, (ox, oy, oz), seed, height_scale)
            ctr = native.terrain_density(
                nx - 1, ny - 1, nz - 1, (ox + 0.5, oy + 0.5, oz + 0.5),
                seed, height_scale)
            solid = (ctr > 0).astype(np.uint8)
            return VoxelWorld(density, solid, chunks_x, chunks_y, chunks_z)
        import sys
        print(f"[terrain] native generator unavailable — numpy fallback "
              f"for {nx}x{ny}x{nz} cells (large worlds take minutes)",
              file=sys.stderr, flush=True)
    p = Perlin(seed)
    xs = np.arange(nx + 1, dtype=np.float64) + ox
    ys = np.arange(ny + 1, dtype=np.float64) + oy
    zs = np.arange(nz + 1, dtype=np.float64) + oz
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    density = terrain_density(p, gx, gy, gz, height_scale)

    cx, cy, cz = np.meshgrid(xs[:-1] + 0.5, ys[:-1] + 0.5, zs[:-1] + 0.5,
                             indexing="ij")
    solid = (terrain_density(p, cx, cy, cz, height_scale) > 0).astype(np.uint8)
    return VoxelWorld(density, solid, chunks_x, chunks_y, chunks_z)


def world_origin(world: VoxelWorld):
    return (-world.chunks_x * CHUNK / 2.0,
            -world.chunks_y * CHUNK / 2.0,
            -world.chunks_z * CHUNK / 2.0)
