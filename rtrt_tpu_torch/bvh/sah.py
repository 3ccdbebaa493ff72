"""Init-time binned-SAH BVH for static scenes, host side (port of
rtrt_tpu/bvh/sah.py).

Builds the flat binary SAH tree with the native C++ builder
(`content/native.py::build_sah`, numpy + ctypes, built from the port's
own copy of rtrt_native.cpp) where the
library loads and with the numpy twin otherwise, collapses subtrees of
<= 8 triangles into row-aligned 8-slot leaves, and collapses the binary
tree into 4-wide (q, 32) records for the traversal (`bvh4_nodes`, native
`rtrt_collapse4` or the numpy twin).  The tables are bitwise equal to the
JAX package's (tests/test_torch_scene_bvh.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..content import native

from .types import _LEAF_BIT, BATCH_SIZE, SceneBvh

_BINS = 16


def _leaf_entry(slot):
    return np.int32(_LEAF_BIT | ((slot // 1024) << 11) | (slot % 1024))


def _sah_fallback(tris: np.ndarray):
    """Pure-numpy binned-SAH twin of rtrt_native.cpp::rtrt_build_sah
    (explicit stack, preorder node ids)."""
    n = tris.shape[0]
    v = tris.reshape(n, 3, 3)
    tb_lo = v.min(axis=1)
    tb_hi = v.max(axis=1)
    tc = 0.5 * (tb_lo + tb_hi)
    order = np.arange(n, dtype=np.int32)
    boxes = np.zeros((n - 1, 12), np.float32)
    children = np.zeros((n - 1, 2), np.int32)
    n_nodes = 0

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def emit(parent, side, entry, lo_b, hi_b):
        if parent >= 0:
            boxes[parent, 6 * side:6 * side + 3] = lo_b
            boxes[parent, 6 * side + 3:6 * side + 6] = hi_b
            children[parent, side] = entry

    stack = [(0, n, -1, 0, 0)]
    while stack:
        lo, hi, parent, side, depth = stack.pop()
        ids = order[lo:hi]
        blo = tb_lo[ids].min(axis=0)
        bhi = tb_hi[ids].max(axis=0)
        if hi - lo == 1:
            emit(parent, side, _leaf_entry(lo), blo, bhi)
            continue
        c = tc[ids]
        clo, chi = c.min(axis=0), c.max(axis=0)
        axis = int(np.argmax(chi - clo))
        ext = chi[axis] - clo[axis]
        mid = -1
        if ext > 1e-12 and depth < 64:
            bins = np.minimum(
                (_BINS * (c[:, axis] - clo[axis]) / ext).astype(np.int32),
                _BINS - 1)
            cnt = np.bincount(bins, minlength=_BINS)
            binlo = np.full((_BINS, 3), 1e30, np.float32)
            binhi = np.full((_BINS, 3), -1e30, np.float32)
            for b in range(_BINS):
                m = bins == b
                if m.any():
                    binlo[b] = tb_lo[ids[m]].min(axis=0)
                    binhi[b] = tb_hi[ids[m]].max(axis=0)
            best, best_b = np.inf, -1
            llo = np.minimum.accumulate(binlo, axis=0)
            lhi = np.maximum.accumulate(binhi, axis=0)
            rlo = np.minimum.accumulate(binlo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(binhi[::-1], axis=0)[::-1]
            lc = np.cumsum(cnt)
            rc = cnt.sum() - lc
            for b in range(_BINS - 1):
                if lc[b] == 0 or rc[b] == 0:
                    continue
                cost = area(llo[b], lhi[b]) * lc[b] \
                    + area(rlo[b + 1], rhi[b + 1]) * rc[b]
                if cost < best:
                    best, best_b = cost, b
            if best_b >= 0:
                left_m = bins <= best_b
                order[lo:hi] = np.concatenate([ids[left_m], ids[~left_m]])
                mid = lo + int(left_m.sum())
        if mid <= lo or mid >= hi:
            mid = (lo + hi) // 2
            k = np.argsort(tc[ids, axis], kind="stable")
            order[lo:hi] = ids[k]
        node = n_nodes
        n_nodes += 1
        emit(parent, side, np.int32(node), blo, bhi)
        stack.append((mid, hi, node, 1, depth + 1))
        stack.append((lo, mid, node, 0, depth + 1))
    if n_nodes != n - 1:
        raise RuntimeError(f"SAH build emitted {n_nodes} nodes for {n} tris")
    return boxes, children, order


def _collapse_leaves(boxes, children, leaf_max=8):
    """Collapse maximal subtrees of <= leaf_max triangles into row-aligned
    leaves.  Returns (new_boxes, new_children, slot_map): leaf entries
    encode padded slot bases (multiples of leaf_max); slot_map (P,) maps
    each padded slot to its source slot (short leaves pad with duplicates
    of their first triangle)."""
    m = boxes.shape[0]
    is_leaf = (children & _LEAF_BIT) != 0
    inner = children & 0x3FFFFF
    cnt = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        cnt[i] = ((1 if is_leaf[i, 0] else cnt[inner[i, 0]])
                  + (1 if is_leaf[i, 1] else cnt[inner[i, 1]]))

    def slot_of(e):
        return ((e >> 11) & 0x7FF) * 1024 + (e & 0x7FF)

    new_id = {0: 0}
    order = [0]
    leaf_lo = []
    stack = [0]
    while stack:
        b = stack.pop()
        for s in (0, 1):
            if not is_leaf[b, s] and cnt[inner[b, s]] > leaf_max:
                c = inner[b, s]
                if c not in new_id:
                    new_id[c] = len(order)
                    order.append(c)
                    stack.append(c)
    lo = np.zeros(m, np.int64)
    stack = [0]
    while stack:
        b = stack.pop()
        lcnt = 1 if is_leaf[b, 0] else cnt[inner[b, 0]]
        if not is_leaf[b, 0]:
            lo[inner[b, 0]] = lo[b]
            stack.append(inner[b, 0])
        if not is_leaf[b, 1]:
            lo[inner[b, 1]] = lo[b] + lcnt
            stack.append(inner[b, 1])

    q = len(order)
    new_boxes = np.zeros((q, 12), np.float32)
    new_children = np.zeros((q, 2), np.int32)
    for b in order:
        i = new_id[b]
        new_boxes[i] = boxes[b]
        for s in (0, 1):
            e = int(children[b, s])
            if is_leaf[b, s]:
                src, c = slot_of(e), 1
            elif cnt[inner[b, s]] <= leaf_max:
                src, c = int(lo[inner[b, s]]), int(cnt[inner[b, s]])
            else:
                new_children[i, s] = new_id[inner[b, s]]
                continue
            base = len(leaf_lo) * leaf_max
            leaf_lo.append((src, c))
            new_children[i, s] = _leaf_entry(base)

    p = len(leaf_lo) * leaf_max
    slot_map = np.zeros(p, np.int32)
    for li, (src, c) in enumerate(leaf_lo):
        base = li * leaf_max
        slot_map[base:base + leaf_max] = src
        slot_map[base:base + c] = np.arange(src, src + c, dtype=np.int32)
    return new_boxes, new_children, slot_map


def build_scene_bvh_sah(v0, v1, v2, valid, leaf_max=1) -> SceneBvh:
    """Flat SAH SceneBvh over padded (B, 1024, 3) triangle arrays (numpy
    in, CPU tensors out).  leaf_max > 1 collapses subtrees into row-aligned
    leaves of leaf_max slots."""
    b = v0.shape[0]
    t_total = b * BATCH_SIZE
    v0 = np.asarray(v0, np.float32).reshape(t_total, 3)
    v1 = np.asarray(v1, np.float32).reshape(t_total, 3)
    v2 = np.asarray(v2, np.float32).reshape(t_total, 3)
    valid = np.asarray(valid).reshape(t_total)
    vidx = np.nonzero(valid)[0].astype(np.int32)
    nv = int(vidx.size)
    if not 2 <= nv <= 2 ** 21:
        raise ValueError(f"SAH scene needs 2..2^21 valid triangles, got {nv}")
    soup = np.concatenate([v0[vidx], v1[vidx], v2[vidx]], axis=1)

    out = native.build_sah(soup)
    if out is None:
        out = _sah_fallback(soup)
    boxes, children, perm = out

    if leaf_max > 1:
        boxes, children, slot_map = _collapse_leaves(boxes, children,
                                                     leaf_max)
        perm = perm[slot_map]
        nv = int(perm.size)
        if nv > 2 ** 21:
            raise ValueError(f"padded leaf slots exceed 2^21: {nv}")
        t_total = -(-nv // BATCH_SIZE) * BATCH_SIZE

    sorted_tri_index = np.zeros(t_total, np.int32)
    sorted_tri_index[:nv] = vidx[perm]
    s = soup[perm]
    tris_t = np.zeros((9, t_total), np.float32)
    tris_t[:, :nv] = s.T

    root_lo = np.minimum(boxes[0, 0:3], boxes[0, 6:9])
    root_hi = np.maximum(boxes[0, 3:6], boxes[0, 9:12])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return SceneBvh(boxes_t=t(boxes.T), children_t=t(children.T),
                    tris_t=t(tris_t), sorted_tri_index=t(sorted_tri_index),
                    root_lo=t(root_lo), root_hi=t(root_hi))


def build_scene_tables_sah(num_batches, indices, tri_mat, valid, verts, nrm,
                           leaf_max=1):
    """SAH tree + sorted per-triangle attribute tables (vertex normals,
    materials) of a static scene: returns (bvh, tri_nrm_t (9, P) f32,
    sorted_mat (P,) i32), all CPU tensors."""
    b = num_batches
    indices = np.asarray(indices)
    verts_np = np.asarray(verts)
    nrm_np = np.asarray(nrm)
    tv0 = verts_np[indices[:, 0]].reshape(b, BATCH_SIZE, 3)
    tv1 = verts_np[indices[:, 1]].reshape(b, BATCH_SIZE, 3)
    tv2 = verts_np[indices[:, 2]].reshape(b, BATCH_SIZE, 3)
    bvh = build_scene_bvh_sah(tv0, tv1, tv2, valid, leaf_max=leaf_max)

    sort_idx = bvh.sorted_tri_index.numpy()
    sorted_idx3 = indices[sort_idx]
    sorted_mat = np.asarray(tri_mat)[sort_idx]
    tri_nrm_t = np.concatenate(
        [nrm_np[sorted_idx3[:, 0]].T, nrm_np[sorted_idx3[:, 1]].T,
         nrm_np[sorted_idx3[:, 2]].T], axis=0)
    return (bvh, torch.from_numpy(np.ascontiguousarray(tri_nrm_t)),
            torch.from_numpy(np.ascontiguousarray(sorted_mat)))


def _collapse4_np(boxes, children):
    """Numpy twin of rtrt_native.cpp::rtrt_collapse4 (greedy largest-area
    inline of internal children until 4 per node) -> (q, 32) f32 records:
    4 child AABBs (lo3, hi3), 4 child entries as exact f32 (-1 = empty;
    empty slots carry inverted boxes), 4 pad lanes."""
    def area(bb):
        d = np.maximum(bb[3:6] - bb[0:3], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    new_id = {}
    order = []
    kids = {}
    stack = [0]
    while stack:
        b = stack.pop()
        new_id[b] = len(order)
        order.append(b)
        cs = [(int(children[b, 0]), boxes[b, 0:6]),
              (int(children[b, 1]), boxes[b, 6:12])]
        while len(cs) < 4:
            pick, best = -1, -1.0
            for i, (e, bb) in enumerate(cs):
                if e & _LEAF_BIT:
                    continue
                a = area(bb)
                if a > best:
                    best, pick = a, i
            if pick < 0:
                break
            inner = cs[pick][0] & 0x3FFFFF
            cs[pick] = (int(children[inner, 0]), boxes[inner, 0:6])
            cs.append((int(children[inner, 1]), boxes[inner, 6:12]))
        kids[b] = cs
        for e, _ in reversed(cs):
            if not (e & _LEAF_BIT):
                stack.append(e & 0x3FFFFF)

    q = len(order)
    nodes = np.zeros((q, 32), np.float32)
    nodes[:, 0:24:6] = np.inf
    nodes[:, 1:24:6] = np.inf
    nodes[:, 2:24:6] = np.inf
    nodes[:, 3:24:6] = -np.inf
    nodes[:, 4:24:6] = -np.inf
    nodes[:, 5:24:6] = -np.inf
    nodes[:, 24:28] = -1.0
    for b in order:
        i = new_id[b]
        for s, (e, bb) in enumerate(kids[b]):
            nodes[i, 6 * s:6 * s + 6] = bb
            nodes[i, 24 + s] = float(e if (e & _LEAF_BIT)
                                     else new_id[e & 0x3FFFFF])
    return nodes


def bvh4_nodes(bvh: SceneBvh) -> np.ndarray:
    """Collapse a flat binary SceneBvh into 4-wide (q, 32) f32 records
    (native when the library loads)."""
    boxes = np.ascontiguousarray(bvh.boxes_t.cpu().numpy().T, np.float32)
    children = np.ascontiguousarray(bvh.children_t.cpu().numpy().T, np.int32)
    lib = native._load()
    if lib is None:
        return _collapse4_np(boxes, children)
    out = ctypes.POINTER(ctypes.c_float)()
    q = ctypes.c_int64()
    lib.rtrt_collapse4(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        children.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        boxes.shape[0], ctypes.byref(out), ctypes.byref(q))
    return native._take_f32(lib, out, q.value * 32).reshape(q.value, 32)
