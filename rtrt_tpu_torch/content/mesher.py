"""Block mesher: voxel occupancy -> quad faces with interior-face removal
(port of rtrt_tpu/content/mesher.py, host numpy code as the JAX package's;
the vertex and index order is the JAX function's, since the order feeds
the BVH build).

Counterpart of the reference's BlockMeshGenerator (reference:
src/meshing.{h,cpp} — VoxelToMesh emits quad faces and removes interior
faces via a hash set).  The blocky alternative to the smooth marching
mesher: a face is emitted exactly where a solid voxel meets an empty one,
so interior faces cancel by construction (the neighbour is tested
directly).
"""

from __future__ import annotations

import numpy as np

# face table: (axis, direction, 4 corner offsets CCW seen from outside)
_FACES = [
    (0, -1, [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)]),
    (0, +1, [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)]),
    (1, -1, [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)]),
    (1, +1, [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)]),
    (2, -1, [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)]),
    (2, +1, [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]),
]


def voxels_to_mesh(solid: np.ndarray, origin=(0.0, 0.0, 0.0),
                   scale: float = 1.0):
    """solid: (X,Y,Z) uint8/bool occupancy.  Returns (vertices (V,3) f32,
    indices (T,3) i32) — two triangles per exposed quad face, shared
    vertices within the grid lattice."""
    s = np.asarray(solid).astype(bool)
    nx, ny, nz = s.shape
    pad = np.zeros((nx + 2, ny + 2, nz + 2), bool)
    pad[1:-1, 1:-1, 1:-1] = s

    vert_ids = {}
    verts = []
    tris = []

    def vid(p):
        if p not in vert_ids:
            vert_ids[p] = len(verts)
            verts.append(p)
        return vert_ids[p]

    solid_cells = np.argwhere(s)
    for (x, y, z) in solid_cells:
        for axis, d, corners in _FACES:
            n = [x + 1, y + 1, z + 1]
            n[axis] += d
            if pad[n[0], n[1], n[2]]:
                continue  # interior face — neighbor solid
            ids = [vid((x + c[0], y + c[1], z + c[2])) for c in corners]
            tris.append((ids[0], ids[1], ids[2]))
            tris.append((ids[0], ids[2], ids[3]))

    o = np.asarray(origin, np.float32)
    v = np.asarray(verts, np.float32) * scale + o
    return v.astype(np.float32), np.asarray(tris, np.int32)
