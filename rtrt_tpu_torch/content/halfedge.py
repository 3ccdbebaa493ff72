"""Half-edge mesh with local edit operations + subdivision (port of
rtrt_tpu/content/halfedge.py: host code on numpy arrays and Python lists,
as the JAX package's, kept as the port's own copy).

Counterpart of the reference's Scotty3D-style half-edge library
(reference: src/mesh.{h,cpp} — from_poly, validate, to_triangles — and the
edit ops in src/meshedit.cpp — edge flip, split, collapse, triangulate,
linear / Catmull-Clark / Loop subdivision).  The native C++ Loop
subdivision lives in content/native/rtrt_native.cpp; this module provides
the editable structure and the op set in Python.

Design: classic half-edge records in flat lists (twin/next/vertex/edge/face
indices).  Triangle meshes only for flip/split/collapse; subdivision accepts
any manifold triangle mesh.
"""

from __future__ import annotations

import numpy as np


class HalfedgeMesh:
    """Flat-array half-edge mesh.

    Arrays (python lists; -1 = none):
      h_twin, h_next, h_vertex (origin), h_edge, h_face : per half-edge
      v_half, e_half, f_half : representative half-edge per element
      v_pos : vertex positions
    """

    def __init__(self):
        self.h_twin = []
        self.h_next = []
        self.h_vertex = []
        self.h_edge = []
        self.h_face = []
        self.v_half = []
        self.e_half = []
        self.f_half = []
        self.v_pos = []

    # ------------------------------------------------------------------
    # construction (from_poly analog)
    # ------------------------------------------------------------------

    @classmethod
    def from_triangles(cls, vertices, indices) -> "HalfedgeMesh":
        m = cls()
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int64)
        m.v_pos = [tuple(p) for p in vertices]
        m.v_half = [-1] * len(m.v_pos)

        edge_map = {}
        for f, (a, b, c) in enumerate(indices):
            base = len(m.h_twin)
            m.f_half.append(base)
            loop = [(a, b), (b, c), (c, a)]
            for k, (u, v) in enumerate(loop):
                h = base + k
                m.h_twin.append(-1)
                m.h_next.append(base + (k + 1) % 3)
                m.h_vertex.append(int(u))
                m.h_face.append(f)
                m.v_half[u] = h
                key = (min(u, v), max(u, v))
                if key in edge_map:
                    e, other = edge_map[key]
                    m.h_twin[h] = other
                    m.h_twin[other] = h
                    m.h_edge.append(e)
                else:
                    e = len(m.e_half)
                    m.e_half.append(h)
                    edge_map[key] = (e, h)
                    m.h_edge.append(e)
        return m

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def num_vertices(self):
        return len(self.v_pos)

    def num_edges(self):
        return len(self.e_half)

    def num_faces(self):
        return len(self.f_half)

    def is_boundary_edge(self, e):
        h = self.e_half[e]
        return self.h_twin[h] == -1

    def edge_vertices(self, e):
        h = self.e_half[e]
        return self.h_vertex[h], self.h_vertex[self.h_next[h]]

    def vertex_ring(self, v):
        """One-ring vertex ids (assumes interior manifold vertex)."""
        out = []
        h0 = self.v_half[v]
        h = h0
        for _ in range(64):
            nxt = self.h_next[h]
            out.append(self.h_vertex[nxt])
            tw = self.h_twin[self.h_next[nxt]]
            if tw == -1:
                break
            h = tw
            if h == h0:
                break
        return out

    def validate(self):
        """Structural invariants (reference: mesh.cpp:372)."""
        nh = len(self.h_twin)
        for h in range(nh):
            t = self.h_twin[h]
            if t != -1:
                assert self.h_twin[t] == h, f"twin mismatch at {h}"
                assert self.h_edge[t] == self.h_edge[h]
            n = self.h_next[h]
            assert 0 <= n < nh
            assert self.h_face[self.h_next[h]] == self.h_face[h]
        for f, h in enumerate(self.f_half):
            # face loops close
            steps = 0
            hh = h
            while True:
                hh = self.h_next[hh]
                steps += 1
                assert steps <= 64, "unclosed face loop"
                if hh == h:
                    break
        return True

    def to_triangles(self):
        """Export (vertices, indices) (reference: mesh.cpp:974)."""
        verts = np.asarray(self.v_pos, np.float32)
        tris = []
        for f, h0 in enumerate(self.f_half):
            loop = []
            h = h0
            while True:
                loop.append(self.h_vertex[h])
                h = self.h_next[h]
                if h == h0:
                    break
            for k in range(1, len(loop) - 1):
                tris.append((loop[0], loop[k], loop[k + 1]))
        return verts, np.asarray(tris, np.int32)

    # ------------------------------------------------------------------
    # local edit ops (meshedit.cpp analogs) — rebuild-based implementations:
    # correctness over pointer surgery (content ops are init-time)
    # ------------------------------------------------------------------

    def _rebuild(self, vertices, indices):
        fresh = HalfedgeMesh.from_triangles(vertices, indices)
        self.__dict__.update(fresh.__dict__)

    def flip_edge(self, e):
        """Rotate an interior edge inside its two adjacent triangles:
        faces (a,b,c) + (b,a,d) become (a,d,c) + (d,b,c).  Refuses boundary
        edges and flips that would duplicate an existing edge (e.g. any
        tetrahedron edge)."""
        if self.is_boundary_edge(e):
            return False
        h = self.e_half[e]
        t = self.h_twin[h]
        a = self.h_vertex[h]            # ordered edge a->b in face 1
        b = self.h_vertex[self.h_next[h]]
        c = self.h_vertex[self.h_next[self.h_next[h]]]
        d = self.h_vertex[self.h_next[self.h_next[t]]]
        # would create a duplicate edge c-d?
        for hh in range(len(self.h_twin)):
            u, v = self.h_vertex[hh], self.h_vertex[self.h_next[hh]]
            if {u, v} == {c, d}:
                return False
        verts, tris = self.to_triangles()
        newt = []
        replaced = 0
        for (x, y, z) in tris:
            s = {x, y, z}
            if s == {a, b, c} and replaced in (0, 1):
                newt.append((a, d, c))
                replaced += 1
            elif s == {a, b, d}:
                newt.append((d, b, c))
                replaced += 1
            else:
                newt.append((x, y, z))
        self._rebuild(verts, newt)
        return True

    def split_edge(self, e):
        """Insert the midpoint vertex; 2 tris -> 4 (boundary: 1 -> 2)."""
        h = self.e_half[e]
        a, b = self.edge_vertices(e)
        verts, tris = self.to_triangles()
        mid = (verts[a] + verts[b]) * 0.5
        m = len(verts)
        verts = np.concatenate([verts, mid[None]], axis=0)
        newt = []
        for (x, y, z) in tris:
            loop = [x, y, z]
            if a in loop and b in loop:
                # replace this tri with two using the midpoint
                other = [v for v in loop if v not in (a, b)][0]
                # preserve winding: walk the original order
                for k in range(3):
                    u, v = loop[k], loop[(k + 1) % 3]
                    if {u, v} == {a, b}:
                        newt.append((u, m, other))
                        newt.append((m, v, other))
                        break
            else:
                newt.append((x, y, z))
        self._rebuild(verts, newt)
        return m

    def collapse_edge(self, e):
        """Merge the edge's endpoints at their midpoint."""
        a, b = self.edge_vertices(e)
        verts, tris = self.to_triangles()
        verts = verts.copy()
        verts[a] = (verts[a] + verts[b]) * 0.5
        newt = []
        for (x, y, z) in tris:
            t2 = tuple(a if v == b else v for v in (x, y, z))
            if len(set(t2)) == 3:
                newt.append(t2)
        # reindex to drop the orphaned vertex
        used = sorted({v for t in newt for v in t})
        remap = {v: i for i, v in enumerate(used)}
        newt = [(remap[x], remap[y], remap[z]) for (x, y, z) in newt]
        self._rebuild(verts[used], newt)
        return remap.get(a, 0)

    # ------------------------------------------------------------------
    # subdivision (meshedit.cpp :336/:368/:410 analogs)
    # ------------------------------------------------------------------

    def subdivide(self, mode: str = "loop"):
        """mode: 'linear' (midpoint), 'loop' (smooth) — 1:4 split — or
        'catmull_clark' (quad-based, reference meshedit.cpp:368)."""
        if mode == "catmull_clark":
            return self.subdivide_catmull_clark()
        verts, tris = self.to_triangles()
        nv = len(verts)
        edge_mid = {}
        edge_opp = {}
        ring = [[] for _ in range(nv)]
        for (a, b, c) in tris:
            for (u, v, w) in ((a, b, c), (b, c, a), (c, a, b)):
                key = (min(u, v), max(u, v))
                edge_opp.setdefault(key, []).append(w)
                ring[u].append(v)
                ring[v].append(u)
        ring = [sorted(set(r)) for r in ring]

        new_verts = list(map(np.asarray, verts))
        if mode == "loop":
            for i in range(nv):
                n = len(ring[i])
                if n < 3:
                    continue
                beta = 3 / 16 if n == 3 else 3 / (8 * n)
                s = sum(np.asarray(verts[j]) for j in ring[i])
                new_verts[i] = verts[i] * (1 - n * beta) + s * beta

        for key, opp in edge_opp.items():
            a, b = key
            if mode == "loop" and len(opp) >= 2:
                p = (verts[a] + verts[b]) * (3 / 8) \
                    + (verts[opp[0]] + verts[opp[1]]) * (1 / 8)
            else:
                p = (verts[a] + verts[b]) * 0.5
            edge_mid[key] = len(new_verts)
            new_verts.append(p)

        newt = []
        for (a, b, c) in tris:
            ab = edge_mid[(min(a, b), max(a, b))]
            bc = edge_mid[(min(b, c), max(b, c))]
            ca = edge_mid[(min(c, a), max(c, a))]
            newt += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        self._rebuild(np.asarray(new_verts, np.float32), newt)

    def subdivide_catmull_clark(self):
        """Catmull-Clark subdivision (reference: meshedit.cpp:368).

        Computes the classic face/edge/vertex points and replaces each
        n-gon with n quads; the quads are stored triangulated (this
        structure is triangle-backed), matching the reference's
        subdivide-then-triangulate pipeline (meshedit.cpp:368 + :275).
        Boundary rules: edge point = midpoint; boundary vertex =
        (1/8, 3/4, 1/8) along the boundary curve."""
        verts, tris = self.to_triangles()
        verts = [np.asarray(v, np.float64) for v in verts]
        nv = len(verts)

        # adjacency
        edge_faces = {}
        v_faces = [[] for _ in range(nv)]
        v_edges = [set() for _ in range(nv)]
        for f, (a, b, c) in enumerate(tris):
            for (u, v) in ((a, b), (b, c), (c, a)):
                key = (min(u, v), max(u, v))
                edge_faces.setdefault(key, []).append(f)
                v_edges[u].add(key)
                v_edges[v].add(key)
            for u in (a, b, c):
                v_faces[u].append(f)

        # 1. face points: centroid of each face
        face_pt = [(verts[a] + verts[b] + verts[c]) / 3.0
                   for (a, b, c) in tris]
        # 2. edge points
        edge_pt = {}
        for key, fs in edge_faces.items():
            a, b = key
            mid = (verts[a] + verts[b]) * 0.5
            if len(fs) == 2:  # interior: avg of endpoints + face points
                edge_pt[key] = (verts[a] + verts[b]
                                + face_pt[fs[0]] + face_pt[fs[1]]) * 0.25
            else:             # boundary: midpoint
                edge_pt[key] = mid
        # 3. vertex points: (Q + 2R + (n-3)S)/n, boundary = crease rule
        new_pos = []
        for i in range(nv):
            bnd = [k for k in v_edges[i] if len(edge_faces[k]) == 1]
            if bnd:
                s = verts[i] * 0.75
                for k in bnd[:2]:
                    a, b = k
                    other = b if a == i else a
                    s = s + verts[other] * (0.125 if len(bnd) >= 2 else 0.25)
                new_pos.append(s)
                continue
            n = len(v_edges[i])
            if n == 0:
                new_pos.append(verts[i])
                continue
            q = sum(face_pt[f] for f in v_faces[i]) / max(len(v_faces[i]), 1)
            r = sum((verts[a] + verts[b]) * 0.5
                    for (a, b) in v_edges[i]) / n
            new_pos.append((q + 2.0 * r + (n - 3.0) * verts[i]) / n)

        # assemble: new verts = vertex points | edge points | face points
        out_verts = list(new_pos)
        e_idx = {}
        for key in edge_faces:
            e_idx[key] = len(out_verts)
            out_verts.append(edge_pt[key])
        f_idx = []
        for f in range(len(tris)):
            f_idx.append(len(out_verts))
            out_verts.append(face_pt[f])
        # each triangle (a,b,c) -> 3 quads, each stored as 2 triangles
        newt = []
        for f, (a, b, c) in enumerate(tris):
            fp = f_idx[f]
            loop = (a, b, c)
            for k in range(3):
                v = loop[k]
                e_next = e_idx[(min(v, loop[(k + 1) % 3]),
                                max(v, loop[(k + 1) % 3]))]
                e_prev = e_idx[(min(loop[(k + 2) % 3], v),
                                max(loop[(k + 2) % 3], v))]
                # quad (v, e_next, fp, e_prev), triangulated
                newt.append((v, e_next, fp))
                newt.append((v, fp, e_prev))
        self._rebuild(np.asarray(out_verts, np.float32), newt)

    def triangulate(self):
        """No-op for triangle meshes; present for API parity
        (reference: meshedit.cpp:275)."""
        verts, tris = self.to_triangles()
        self._rebuild(verts, tris)
