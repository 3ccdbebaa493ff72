"""Scene assembly: content generation -> padded triangle arrays + materials
(port of rtrt_tpu/engine/scene.py).  Triangles come from the port's own
content pipeline, `rtrt_tpu_torch.content` (numpy, and the native C++ twin
built from the port's copy of rtrt_native.cpp where a compiler is found)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bvh.types import BATCH_SIZE
from ..content import native
from ..content.marching import (march_tetrahedra, roundcube_field,
                                smooth_normals, weld_vertices)
from ..content.terrain import generate_world, world_origin
from ..render.bsdf import (MAT_GGX, MAT_GLASS, MAT_LAMBERT, MAT_MIRROR,
                           Materials, make_materials)
from ..render.light import SphereLights
from ..utils.config import GlobalSettings

MAX_TRIS = BATCH_SIZE * 1024


@dataclass
class HostScene:
    vertices: np.ndarray    # (V,3) f32
    indices: np.ndarray     # (T0,3) i32 (unpadded)
    normals: np.ndarray     # (V,3) f32 smooth vertex normals
    tri_mat: np.ndarray     # (T0,) i32
    num_batches: int        # padded batch count (>= 2)
    materials: Materials
    lights: SphereLights = None

    @property
    def num_tris(self) -> int:
        return int(self.indices.shape[0])


def default_materials() -> Materials:
    return make_materials([
        dict(mtype=MAT_LAMBERT, albedo=(0.5, 0.42, 0.32), textured=1),
        dict(mtype=MAT_LAMBERT, albedo=(0.75, 0.72, 0.68)),
        dict(mtype=MAT_MIRROR, albedo=(0.95, 0.95, 0.95)),
        dict(mtype=MAT_GLASS, albedo=(0.98, 0.98, 0.98), ior=1.5),
        dict(mtype=MAT_GGX, albedo=(0.9, 0.7, 0.3), roughness=0.25,
             f0=(0.9, 0.6, 0.2)),
        dict(mtype=MAT_GGX, albedo=(0.8, 0.8, 0.85), roughness=0.1,
             f0=(0.95, 0.95, 0.95)),
    ])


def _pad_batch_count(t: int) -> int:
    return max(2, -(-t // BATCH_SIZE))


def build_terrain_scene(settings: GlobalSettings) -> HostScene:
    """Perlin voxel terrain -> marching tetrahedra -> weld -> smooth normals
    (native C++ pipeline when the library loads, numpy twins otherwise)."""
    world = generate_world(chunks_x=settings.terrain_chunks,
                           chunks_y=max(2, settings.terrain_chunks // 2),
                           chunks_z=settings.terrain_chunks,
                           seed=settings.terrain_seed)
    origin = world_origin(world)
    if settings.terrain_style == "roundcube":
        density = roundcube_field(world.solid, rounding=0)
        v0, v1, v2 = march_tetrahedra(density, origin=origin)
        vertices = np.concatenate([v0, v1, v2], axis=0).astype(np.float32)
        t = v0.shape[0]
        indices = np.stack([np.arange(t), np.arange(t) + t,
                            np.arange(t) + 2 * t], axis=-1).astype(np.int32)
        fn = np.cross(v1 - v0, v2 - v0)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
        normals = np.concatenate([fn, fn, fn], axis=0).astype(np.float32)
    elif native.available():
        v0, v1, v2 = native.march_tetrahedra(world.density, origin)
        vertices, indices = native.weld(v0, v1, v2)
        normals = native.smooth_normals(vertices, indices)
    else:
        v0, v1, v2 = march_tetrahedra(world.density, origin=origin)
        vertices, indices = weld_vertices(v0, v1, v2)
        normals = smooth_normals(vertices, indices)
    if indices.shape[0] > MAX_TRIS:
        indices = indices[:MAX_TRIS]
        normals = smooth_normals(vertices, indices)
    return HostScene(vertices=vertices, indices=indices, normals=normals,
                     tri_mat=np.zeros(indices.shape[0], np.int32),
                     num_batches=_pad_batch_count(indices.shape[0]),
                     materials=default_materials())


def build_mesh_scene(vertices, indices, material_id=1) -> HostScene:
    """Wrap an imported mesh as a scene."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)[:MAX_TRIS]
    return HostScene(vertices=vertices, indices=indices,
                     normals=smooth_normals(vertices, indices),
                     tri_mat=np.full(indices.shape[0], material_id, np.int32),
                     num_batches=_pad_batch_count(indices.shape[0]),
                     materials=default_materials())


def build_demo_scene() -> HostScene:
    """Ground quad + icosphere trio (mirror / glass / GGX gold) and one
    analytic sphere light."""
    vs, tris, mats = [], [], []

    def add_quad(a, b, c, d, m):
        base = len(vs)
        vs.extend([a, b, c, d])
        tris.append((base, base + 1, base + 2))
        tris.append((base, base + 2, base + 3))
        mats.extend([m, m])

    g = 30.0
    add_quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g), 1)

    def add_icosphere(center, radius, m, subdiv=2):
        t = (1.0 + 5 ** 0.5) / 2.0
        base_v = np.array([
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], np.float64)
        base_v /= np.linalg.norm(base_v, axis=1, keepdims=True)
        base_f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
                  (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
                  (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
                  (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
        verts = list(map(tuple, base_v))
        faces = base_f
        for _ in range(subdiv):
            cache = {}
            new_faces = []

            def mid(i, j):
                key = (min(i, j), max(i, j))
                if key not in cache:
                    m_ = np.asarray(verts[i]) + np.asarray(verts[j])
                    m_ /= np.linalg.norm(m_)
                    cache[key] = len(verts)
                    verts.append(tuple(m_))
                return cache[key]

            for (a, b, c) in faces:
                ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
                new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c),
                              (ab, bc, ca)]
            faces = new_faces
        base = len(vs)
        for v in verts:
            vs.append(tuple(np.asarray(v) * radius + np.asarray(center)))
        for (a, b, c) in faces:
            tris.append((base + a, base + b, base + c))
            mats.append(m)

    add_icosphere((-2.5, 1.0, 0.0), 1.0, 2)   # mirror
    add_icosphere((0.0, 1.0, 0.0), 1.0, 3)    # glass
    add_icosphere((2.5, 1.0, 0.0), 1.0, 4)    # GGX gold

    lights = SphereLights(center=torch.tensor([[0.0, 4.5, -3.0]]),
                          radius=torch.tensor([0.6]),
                          emission=torch.tensor([[40.0, 32.0, 22.0]]))
    vertices = np.asarray(vs, np.float32)
    indices = np.asarray(tris, np.int32)
    return HostScene(vertices=vertices, indices=indices,
                     normals=smooth_normals(vertices, indices),
                     tri_mat=np.asarray(mats, np.int32),
                     num_batches=_pad_batch_count(indices.shape[0]),
                     materials=default_materials(), lights=lights)


CHAIN_SIZE = 2.0 ** 20  # side of build_chain_scene's squares


def build_chain_scene(k_lo: int = -39, k_hi: int = 84) -> HostScene:
    """A stress scene for the traversal stack: squares of side CHAIN_SIZE
    (two triangles each) in the y-z plane at x = 2^k, k in [k_lo, k_hi).
    Each SAH split peels the few largest-x squares off, so the tree is a
    chain of BVH4 levels (the default: 246 triangles, 12 levels, a
    36-entry stack, where the terrain's 36,834 triangles make 8 levels).  The range keeps
    the tree exact for the traversal: below 2^-39 the SAH's centroid
    extent falls under 1e-12 (median splits), and the slab test takes a
    direction component below 1e-20 as 1e-20 (safe_inv), so a ray along x
    sees a box edge CHAIN_SIZE / 5 away only within 2^84."""
    vs, ix = [], []
    c = CHAIN_SIZE
    for k in range(k_lo, k_hi):
        x = float(np.float32(2.0) ** k)
        b = len(vs)
        vs += [(x, 0.0, 0.0), (x, c, 0.0), (x, c, c), (x, 0.0, c)]
        ix += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    vertices = np.asarray(vs, np.float32)
    indices = np.asarray(ix, np.int32)
    normals = np.tile(np.float32([1.0, 0.0, 0.0]), (len(vs), 1))
    return HostScene(vertices=vertices, indices=indices, normals=normals,
                     tri_mat=np.ones(indices.shape[0], np.int32),
                     num_batches=_pad_batch_count(indices.shape[0]),
                     materials=default_materials())


def chain_scene_rays(n: int, seed: int = 0, k_lo: int = -10,
                     k_hi: int = 83):
    """(org, dir) float32 numpy rays for build_chain_scene: from x =
    1.5 * 2^j (j in [k_lo, k_hi)) inside the squares' cross-section, away
    from its diagonal and edges, along +x or -x with a slope small enough
    to meet the next square inside, so that they hit squares at every
    depth of the chain; a quarter start at x = -1 and run exactly along
    +x: they enter every box of the chain and descend it to the nearest
    square, pushing the far children of every level (the deepest stack).
    A slope below 1e-18 is set to 0, so that no direction component lies
    in safe_inv's clamped range."""
    rng = np.random.default_rng(seed)
    c = CHAIN_SIZE
    j = rng.integers(k_lo, k_hi, n)
    x = 1.5 * np.exp2(j.astype(np.float64))
    x[: n // 4] = -1.0
    y = rng.uniform(0.2, 0.8, n)
    z = np.where(rng.uniform(size=n) < 0.5, y - rng.uniform(0.1, 0.15, n),
                 y + rng.uniform(0.1, 0.15, n))
    sgn = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    sgn[: n // 4] = 1.0
    # over the 0.5 * 2^j to the next square, y and z move by <= 0.04 c
    slope = rng.uniform(-0.08, 0.08, (n, 2)) * c / np.maximum(x, 1.0)[:, None]
    slope[: n // 4] = 0.0
    slope[np.abs(slope) < 1e-18] = 0.0
    d = np.stack([sgn, slope[:, 0], slope[:, 1]], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.stack([x, y * c, z * c], axis=1)
    return org.astype(np.float32), d.astype(np.float32)


def padded_arrays(scene: HostScene):
    """Pad index/material arrays to whole 1024-triangle batches.
    Returns numpy dict: indices (B*1024, 3), tri_mat (B*1024,),
    valid (B, 1024) bool."""
    t0 = scene.num_tris
    total = scene.num_batches * BATCH_SIZE
    pad = total - t0
    indices = np.concatenate(
        [scene.indices, np.zeros((pad, 3), np.int32)], axis=0)
    tri_mat = np.concatenate([scene.tri_mat, np.zeros(pad, np.int32)], axis=0)
    valid = np.zeros(total, bool)
    valid[:t0] = True
    return dict(indices=indices, tri_mat=tri_mat,
                valid=valid.reshape(scene.num_batches, BATCH_SIZE))
