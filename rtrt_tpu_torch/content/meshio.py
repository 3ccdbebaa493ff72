"""Mesh I/O: OBJ/PLY import, binary scene cache.

Counterpart of the reference's mesh loading: assimp import
(reference: src/fileUtils.cu:61-80, 1M-tri cap) and the binary
`[triCount][Triangle...]` cache written by the offline baker and read at
init (reference: tool/meshProcessor.cpp, src/init.cu:28-50).  assimp is not
available here; OBJ and PLY cover the common interchange cases, and the
binary cache format is our own (npz of vertices/indices).

Copy of rtrt_tpu/content/meshio.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAX_TRIS = 1 << 20  # 1M-tri cap like the reference


def load_obj(path: str):
    """Minimal OBJ: v / f (triangulates polygons by fanning).

    Returns (vertices (V,3) f32, indices (T,3) i32)."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    if len(faces) >= MAX_TRIS:
                        break
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def save_obj(path: str, vertices, indices):
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(indices):
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def load_ply(path: str):
    """Binary/ascii little-endian PLY with float vertex xyz + int face lists."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        nv = nf = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                nv = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element face"):
                nf = int(line.split()[-1])
                in_vertex = False
            elif line.startswith(b"property") and in_vertex:
                props.append(line.split()[-1])
            elif line == b"end_header":
                break
        k = len(props)
        if fmt == b"ascii":
            verts = np.zeros((nv, 3), np.float32)
            for i in range(nv):
                vals = f.readline().split()
                verts[i] = [float(vals[0]), float(vals[1]), float(vals[2])]
            faces = []
            for _ in range(nf):
                vals = list(map(int, f.readline().split()))
                n = vals[0]
                for j in range(1, n - 1):
                    faces.append((vals[1], vals[1 + j], vals[2 + j]))
        else:
            data = np.frombuffer(f.read(nv * k * 4), np.float32).reshape(nv, k)
            verts = data[:, :3].astype(np.float32)
            faces = []
            for _ in range(nf):
                (n,) = struct.unpack("<B", f.read(1))
                idx = struct.unpack(f"<{n}i", f.read(4 * n))
                for j in range(1, n - 1):
                    faces.append((idx[0], idx[j], idx[j + 1]))
        return verts, np.asarray(faces, np.int32)[:MAX_TRIS]


def load_mesh(path: str):
    """Dispatch by extension; .npz is the binary cache.  OBJ prefers the
    native loader (content/native.py) when built."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        from . import native
        if native.available():
            return native.load_obj(path)
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    if ext == ".npz":
        d = np.load(path)
        return (d["vertices"].astype(np.float32),
                d["indices"].astype(np.int32)[:MAX_TRIS])
    raise ValueError(f"unsupported mesh format: {ext}")


def save_mesh_cache(path: str, vertices, indices):
    """Binary scene cache (the meshProcessor .bin analog)."""
    np.savez_compressed(path, vertices=np.asarray(vertices, np.float32),
                        indices=np.asarray(indices, np.int32))
