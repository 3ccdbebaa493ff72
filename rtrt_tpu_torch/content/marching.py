"""Isosurface extraction: marching tetrahedra + vertex welding.

Counterpart of the reference's marching-cubes mesher
(reference: src/marchingCubes.cpp — 15 template meshes expanded to 256 cube
cases via mirror/rotate closures :216-537, per-cell emission :539-568, and
the VertexMerger dedup :572-674).

Re-designed from first principles rather than template meshes: each cell is
split into 6 tetrahedra around the main diagonal (a decomposition whose
shared faces agree between neighboring cells, so the surface is watertight
by construction), and each tetrahedron's 16 sign cases are enumerated
directly — no case tables, no template assets, and vertices land ON the
density isosurface (sub-voxel smooth, where the reference snaps to template
geometry).  Output feeds the same weld + smooth-normal pipeline.

Host-side numpy (content gen is init-time); the C++ native twin provides
the same function for the native content pipeline.

Copy of rtrt_tpu/content/marching.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

# 6-tetrahedra decomposition of the unit cube around diagonal 0-7.
# Corner i has coords ((i>>0)&1, (i>>1)&1, (i>>2)&1).
TETS = np.array([
    (0, 1, 3, 7),
    (0, 1, 5, 7),
    (0, 2, 3, 7),
    (0, 2, 6, 7),
    (0, 4, 5, 7),
    (0, 4, 6, 7),
], np.int32)

CORNER_OFFSET = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1]
                          for i in range(8)], np.float32)


def _interp(pa, pb, da, db):
    """Surface crossing point on edge a-b (densities of opposite sign)."""
    t = da / (da - db)
    return pa + t[..., None] * (pb - pa)


def _orient(v0, v1, v2, inside_pt):
    """Flip v1/v2 where the triangle normal points toward the inside point
    (we want outward-facing CCW winding)."""
    n = np.cross(v1 - v0, v2 - v0)
    flip = np.sum(n * (inside_pt - v0), axis=-1) > 0.0
    v1f = np.where(flip[..., None], v2, v1)
    v2f = np.where(flip[..., None], v1, v2)
    return v0, v1f, v2f


def march_tetrahedra(density: np.ndarray, origin=(0.0, 0.0, 0.0),
                     scale: float = 1.0):
    """Extract the 0-isosurface of a corner-sampled density volume.

    density: (X+1, Y+1, Z+1) float; > 0 = inside.
    Returns (v0, v1, v2): each (T, 3) float32 triangle soup (outward CCW).
    """
    d = np.asarray(density, np.float32)
    nx, ny, nz = d.shape[0] - 1, d.shape[1] - 1, d.shape[2] - 1
    ox, oy, oz = origin

    # cell corner positions + densities: (C, 8)
    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    cells = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=-1)  # (C,3)
    corner_idx = cells[:, None, :] + CORNER_OFFSET[None, :, :].astype(np.int64)
    cd = d[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # (C,8)
    cpos = (cells[:, None, :].astype(np.float32) + CORNER_OFFSET[None]) \
        * scale + np.array([ox, oy, oz], np.float32)

    # cells fully inside/outside emit nothing — drop them early
    occ = cd > 0.0
    active = ~(occ.all(axis=1) | (~occ).all(axis=1))
    cd = cd[active]
    cpos = cpos[active]

    tris = []
    for tet in TETS:
        td = cd[:, tet]          # (A, 4)
        tp = cpos[:, tet]        # (A, 4, 3)
        inside = td > 0.0
        count = inside.sum(axis=1)

        # --- one corner on one side: single triangle ---
        for lone_inside in (True, False):
            sel = count == (1 if lone_inside else 3)
            if not sel.any():
                continue
            tdm = td[sel]
            tpm = tp[sel]
            im = inside[sel] if lone_inside else ~inside[sel]
            a = np.argmax(im, axis=1)
            rows = np.arange(a.shape[0])
            others = np.array([[j for j in range(4) if j != ai] for ai in a])
            pa = tpm[rows, a]
            da = tdm[rows, a]
            vs = [_interp(pa, tpm[rows, others[:, k]], da,
                          tdm[rows, others[:, k]]) for k in range(3)]
            ip = pa if lone_inside else (
                # inside point = centroid of the three inside corners
                (tpm[rows, others[:, 0]] + tpm[rows, others[:, 1]]
                 + tpm[rows, others[:, 2]]) / 3.0)
            tris.append(_orient(vs[0], vs[1], vs[2], ip))

        # --- two-two split: quad -> two triangles ---
        sel = count == 2
        if sel.any():
            tdm = td[sel]
            tpm = tp[sel]
            im = inside[sel]
            order = np.argsort(~im, axis=1, kind="stable")  # inside first
            a0, a1 = order[:, 0], order[:, 1]
            b0, b1 = order[:, 2], order[:, 3]
            rows = np.arange(a0.shape[0])
            p00 = _interp(tpm[rows, a0], tpm[rows, b0], tdm[rows, a0], tdm[rows, b0])
            p01 = _interp(tpm[rows, a0], tpm[rows, b1], tdm[rows, a0], tdm[rows, b1])
            p10 = _interp(tpm[rows, a1], tpm[rows, b0], tdm[rows, a1], tdm[rows, b0])
            p11 = _interp(tpm[rows, a1], tpm[rows, b1], tdm[rows, a1], tdm[rows, b1])
            ip = 0.5 * (tpm[rows, a0] + tpm[rows, a1])
            tris.append(_orient(p00, p01, p11, ip))
            tris.append(_orient(p00, p11, p10, ip))

    if not tris:
        z = np.zeros((0, 3), np.float32)
        return z, z, z
    v0 = np.concatenate([t[0] for t in tris]).astype(np.float32)
    v1 = np.concatenate([t[1] for t in tris]).astype(np.float32)
    v2 = np.concatenate([t[2] for t in tris]).astype(np.float32)
    return v0, v1, v2


def weld_vertices(v0, v1, v2, tol: float = 1e-3):
    """Merge coincident vertices (quantized to `tol`) into a shared
    vertex/index buffer (reference VertexMerger: marchingCubes.cpp:572-674).
    Degenerate triangles (repeated indices) are dropped.

    Returns (vertices (V,3) f32, indices (T,3) i32).
    """
    soup = np.concatenate([v0, v1, v2], axis=0)
    q = np.round(soup / tol).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True, return_inverse=True)
    vertices = soup[first].astype(np.float32)
    n = v0.shape[0]
    indices = np.stack([inv[:n], inv[n:2 * n], inv[2 * n:]], axis=-1)
    ok = (indices[:, 0] != indices[:, 1]) & (indices[:, 1] != indices[:, 2]) \
        & (indices[:, 0] != indices[:, 2])
    return vertices, indices[ok].astype(np.int32)


def smooth_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (counterpart of the reference's
    atomicAdd GPU accumulation, src/kernel.cu:228-257 — here a host
    scatter-add; the JAX segment_sum twin lives in content/normals.py)."""
    v = vertices
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(v[i1] - v[i0], v[i2] - v[i0])  # area-weighted
    out = np.zeros_like(v)
    for k, idx in enumerate((i0, i1, i2)):
        np.add.at(out, idx, fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)


def roundcube_field(solid: np.ndarray, rounding: int = 1) -> np.ndarray:
    """Corner-sampled signed field whose isosurface is the ROUNDED-BLOCK
    surface of a binary voxel world — the reference's visual identity.

    The reference meshes binary voxels with 15 hand-modeled "roundcube"
    template meshes (reference: src/marchingCubes.cpp:216-537): flat block
    faces away from edges, rounded bevels along edges and corners.  This
    framework reproduces that look procedurally instead of with template
    assets: the ±1 occupancy field is corner-resampled (8-cell average)
    and then box-smoothed `rounding` times, which leaves flat faces flat
    (constant neighborhoods are fixed points of the box filter) while
    rounding the sign transitions at edges/corners; marching tetrahedra on
    the smoothed field then lands vertices on the rounded isosurface.

    solid: (X, Y, Z) uint8/bool cell occupancy.
    Returns (X+1, Y+1, Z+1) float32 corner field, > 0 inside.
    """
    s = np.asarray(solid, np.float32) * 2.0 - 1.0
    # cell-centered -> corner lattice: average the 8 adjacent cells
    # (outside-of-world cells count as empty, giving a closed surface)
    p = np.pad(s, 1, constant_values=-1.0)
    f = np.zeros((s.shape[0] + 1, s.shape[1] + 1, s.shape[2] + 1),
                 np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                f += p[dx:dx + f.shape[0], dy:dy + f.shape[1],
                       dz:dz + f.shape[2]]
    f *= 0.125
    for _ in range(rounding):
        g = np.pad(f, 1, mode="edge")
        acc = np.zeros_like(f)
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    acc += g[dx:dx + f.shape[0], dy:dy + f.shape[1],
                             dz:dz + f.shape[2]]
        f = acc / 27.0
    return f
