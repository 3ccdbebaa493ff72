"""Offline mesh baker: import -> [subdivide] -> morton-sort -> weld ->
.npz scene cache (port of tools/mesh_baker.py).

    python -m rtrt_tpu_torch.tools.mesh_baker INPUT OUTPUT.npz
        [--subdivide N] [--weld-tol 1e-5] [--device cuda|cpu]

Counterpart of the reference's meshProcessor tool (reference:
tool/meshProcessor.cpp — import, 60-bit morton codes, CPU sort, a binary
scene cache).  INPUT is an OBJ, PLY or .npz (content/meshio.py).  Loop
subdivision and the morton sort use the port's native C++ library
(content/native) when it is built; otherwise the subdivision runs on
content/halfedge.py and the morton sort on `--device` (torch), then the
soup is welded (content/marching.py::weld_vertices).  The output is the
framework's .npz cache, which `GlobalSettings(scene="mesh:OUTPUT.npz")`
loads.  Without a card the tool exits non-zero unless --device cpu is
given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def morton_sort(v0, v1, v2, device="cuda"):
    """The triangle soup (each (T, 3) float32) reordered by the 63-bit
    morton code of its centroids (21 bits an axis over the centroids'
    bounds; a stable sort), computed in torch on `device`."""
    import torch

    c = (torch.from_numpy(np.asarray(v0, np.float32)).to(device)
         + torch.from_numpy(np.asarray(v1, np.float32)).to(device)
         + torch.from_numpy(np.asarray(v2, np.float32)).to(device)) / 3.0
    lo = c.amin(0)
    ext = torch.clamp(c.amax(0) - lo, min=1e-12)
    q = torch.clamp((c - lo) / ext * 2097151.0, 0, 2097151).to(torch.int64)

    def expand(x):
        x = x & 0x1FFFFF
        x = (x | (x << 32)) & 0x1F00000000FFFF
        x = (x | (x << 16)) & 0x1F0000FF0000FF
        x = (x | (x << 8)) & 0x100F00F00F00F00F
        x = (x | (x << 4)) & 0x10C30C30C30C30C3
        x = (x | (x << 2)) & 0x1249249249249249
        return x

    codes = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) \
        | expand(q[:, 2])
    order = torch.sort(codes, stable=True).indices.cpu().numpy()
    return v0[order], v1[order], v2[order]


def bake(input_path, output_path, subdivide=0, weld_tol=1e-5,
         device="cuda", log=print):
    """Bake INPUT into the .npz cache OUTPUT; returns (vertices, indices)
    as written."""
    from ..content import native
    from ..content.marching import weld_vertices
    from ..content.meshio import load_mesh, save_mesh_cache

    verts, faces = load_mesh(input_path)
    log(f"loaded {input_path}: {len(verts)} verts, {len(faces)} tris")
    if subdivide:
        if native.available():
            verts, faces = native.subdivide_loop(verts, faces, subdivide)
        else:
            from ..content.halfedge import HalfedgeMesh
            m = HalfedgeMesh.from_triangles(verts, faces)
            for _ in range(subdivide):
                m.subdivide("loop")
            verts, faces = m.to_triangles()
        log(f"subdivided x{subdivide}: {len(verts)} verts, "
            f"{len(faces)} tris")

    # morton-sort the triangle soup for traversal locality, then re-weld
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    if native.available():
        v0, v1, v2 = native.morton_sort_tris(v0, v1, v2)
        verts, faces = native.weld(v0, v1, v2, weld_tol)
    else:
        v0, v1, v2 = morton_sort(v0, v1, v2, device)
        verts, faces = weld_vertices(v0, v1, v2, weld_tol)
    save_mesh_cache(output_path, verts, faces)
    log(f"wrote {output_path}: {len(verts)} verts, {len(faces)} tris "
        f"(native={native.available()})")
    return verts, faces


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--subdivide", type=int, default=0,
                   help="Loop-subdivision levels before baking")
    p.add_argument("--weld-tol", type=float, default=1e-5)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    from ..utils.timing import device_line
    print(device_line(args.device))
    bake(args.input, args.output, args.subdivide, args.weld_tol,
         args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
