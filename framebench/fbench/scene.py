"""The scene a configuration states: the terrain mesh, made by framebench's
own frozen terrain generator and cached inside the checkout, its padding to
whole 1024-triangle batches, and the material table.  The program and the
reference are each handed the same arrays."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .terrain.marching import march_tetrahedra, smooth_normals, weld_vertices
from .terrain.terrain import generate_world, world_origin

BATCH_SIZE = 1024  # triangles a batch (the port's bvh/types.py::BATCH_SIZE)
# the mesh cache's generator version: a change to fbench/terrain/ that
# changes the mesh moves it, so that no checkout keeps a stale mesh
MESH_VERSION = 1


def make_mesh(terrain: dict):
    """(vertices (V, 3) f32, indices (T, 3) i32, normals (V, 3) f32) of the
    configuration's terrain: the Perlin density field, marching tetrahedra,
    welded vertices and area-weighted smooth normals."""
    world = generate_world(terrain["chunks_x"], terrain["chunks_y"],
                           terrain["chunks_z"], seed=terrain["seed"],
                           height_scale=terrain["height_scale"])
    v0, v1, v2 = march_tetrahedra(world.density, origin=world_origin(world))
    vertices, indices = weld_vertices(v0, v1, v2, tol=terrain["weld_tol"])
    return vertices, indices, smooth_normals(vertices, indices)


def cached_mesh(terrain: dict, cache_dir: str):
    """make_mesh's arrays, kept in `cache_dir` under a name keyed by the
    terrain's parameters, so that only a checkout's first run makes them."""
    key = hashlib.sha256(json.dumps(dict(terrain, version=MESH_VERSION),
                                    sort_keys=True).encode())
    path = os.path.join(cache_dir, f"mesh_{key.hexdigest()[:16]}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["vertices"], z["indices"], z["normals"]
    mesh = make_mesh(terrain)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".part.npz"
    np.savez(tmp, vertices=mesh[0], indices=mesh[1], normals=mesh[2])
    os.replace(tmp, path)
    return mesh


def batches(n_tris: int) -> int:
    """The padded batch count of n_tris triangles (at least 2)."""
    return max(2, -(-n_tris // BATCH_SIZE))


def padded(indices: np.ndarray):
    """(indices (B * 1024, 3) i32, tri_mat (B * 1024,) i32, valid (B, 1024)
    bool): the triangles padded with (0, 0, 0) to whole batches, material
    0 everywhere (the terrain's one textured material)."""
    t = indices.shape[0]
    b = batches(t)
    pad = b * BATCH_SIZE - t
    idx = np.concatenate([indices, np.zeros((pad, 3), np.int32)], 0)
    valid = np.zeros(b * BATCH_SIZE, bool)
    valid[:t] = True
    return idx.astype(np.int32), np.zeros(b * BATCH_SIZE, np.int32), \
        valid.reshape(b, BATCH_SIZE)


def material_entries(config: dict, bsdf):
    """The configuration's materials as make_materials entries, each mtype
    name ("lambert", "ggx", ...) mapped to the MAT_* constant of `bsdf`,
    the program's or the reference's render/bsdf.py module."""
    return [dict(e, mtype=getattr(bsdf, "MAT_" + e["mtype"].upper()))
            for e in config["materials"]]
