"""Ray-scene traversal over the 4-wide SAH tree: kernel K1 and its plain twin
(port of rtrt_tpu/bvh/packet.py::packet_intersect / traverse_tile).

The TPU kernel shares ONE scalar stack across a 32x128 ray tile and steps
the tile through the union of its rays' node visits.  On Hopper the natural
form is one thread per ray with its own short stack (csrc/traverse.cuh),
so the port keeps the function and drops the TPU layout: no 128-lane packed
record rows, no exact-f32 integers in the triangle/attribute tables, no
shared stack, no distinct-winner resolve loop.

Per-ray semantics are those of traverse_tile for one lane:
  * best_t starts at min(t_max, exit distance of the root box) (-inf for
    rays with t_max <= 0, which then hit nothing);
  * slab test with far-plane slack 1 + 3.6e-7, near-first ordering of the
    four children by entry distance (the same 5-comparator network), far
    children pushed with their entry distance, pops pruned when that entry
    is not below the ray's current best;
  * leaves are 8-slot rows tested with Möller-Trumbore over precomputed
    edges; padding slots duplicate real triangles, so a strict `<` keeps
    the first slot of a tie;
  * any-hit lanes stop at their first accepted leaf hit and report it;
  * a push that does not fit the STACK-deep stack is dropped AND counted
    in the caller's overflow counter (must stay 0 for a correct image).

The hit id is the sorted slot; shading attributes come from the sorted
normal / geometric-normal / material tables at that slot.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..utils import cuda
from .types import _LEAF_BIT, entry_slot

STACK = 64           # per-ray traversal stack depth (entries)
LEAF_WIDTH = 8       # triangle slots per leaf row
RAY_TMIN = 1e-4
FAR_SCALE = 1.0 + 3.6e-7
_TINY = 1e-20


@dataclasses.dataclass
class TraceTables:
    """Device-side scene tables of the traversal (GPU layout).

    nodes (q, 32) f32: 128-byte BVH4 records from bvh/sah.py::bvh4_nodes —
      4 child AABBs (lo xyz, hi xyz) then 4 child entries as exact floats
      (leaf bit 23, -1 = empty slot), 4 pad floats.
    tris (P, 9) f32: sorted triangles as [v0 | v1 - v0 | v2 - v0].
    nrm (P, 9) f32: sorted vertex normals [n0 | n1 | n2].
    ng (P, 3) f32: unit geometric normal per slot.
    mat (P,) i32: material id per slot.
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    nrm: torch.Tensor
    ng: torch.Tensor
    mat: torch.Tensor

    def to(self, device) -> "TraceTables":
        return TraceTables(*(getattr(self, f.name).to(device).contiguous()
                             for f in dataclasses.fields(self)))


def pack_tables(bvh, tri_nrm_t, tri_mat, nodes4) -> TraceTables:
    """SceneBvh + sorted normals/materials + (q, 32) BVH4 records ->
    TraceTables (on the device of bvh.tris_t)."""
    tt = bvh.tris_t.to(torch.float32)
    e1 = tt[3:6] - tt[0:3]
    e2 = tt[6:9] - tt[0:3]
    gx = e1[1] * e2[2] - e1[2] * e2[1]
    gy = e1[2] * e2[0] - e1[0] * e2[2]
    gz = e1[0] * e2[1] - e1[1] * e2[0]
    gl = torch.rsqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-20))
    dev = tt.device
    return TraceTables(
        nodes=torch.as_tensor(nodes4, dtype=torch.float32,
                              device=dev).contiguous(),
        tris=torch.cat([tt[0:3], e1, e2], dim=0).T.contiguous(),
        nrm=tri_nrm_t.to(dev, torch.float32).T.contiguous(),
        ng=torch.stack([gx * gl, gy * gl, gz * gl], dim=1).contiguous(),
        mat=tri_mat.to(dev, torch.int32).contiguous())


@dataclasses.dataclass
class PacketHit:
    t: torch.Tensor    # (N,) inf on miss
    tri: torch.Tensor  # (N,) i32 sorted slot, -1 on miss
    u: torch.Tensor    # (N,) barycentric of v1
    v: torch.Tensor    # (N,) barycentric of v2
    mat: torch.Tensor  # (N,) i32 material id (0 on miss)
    ns: torch.Tensor   # (N,3) interpolated shading normal (not normalised)
    ng: torch.Tensor   # (N,3) unit geometric normal (unoriented)


def overflow_counter(device) -> torch.Tensor:
    """A fresh (1,) int32 counter for dropped stack pushes."""
    return torch.zeros(1, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU tests and the on-card comparison)
# ---------------------------------------------------------------------------


def _safe_inv(d):
    tiny = torch.where(d >= 0, _TINY, -_TINY)
    return 1.0 / torch.where(torch.abs(d) < _TINY, tiny, d)


def _slab(lo, hi, o, inv, best):
    """Slab test of (R,3) rays against (R,3) boxes: (hit, entry t)."""
    neg = inv < 0
    near = torch.where(neg, hi, lo)
    far = torch.where(neg, lo, hi)
    tn_ = (near - o) * inv
    tf_ = (far - o) * inv
    tn = torch.maximum(torch.maximum(tn_[:, 0], tn_[:, 1]), tn_[:, 2])
    tf = torch.minimum(torch.minimum(tf_[:, 0], tf_[:, 1]), tf_[:, 2]) \
        * FAR_SCALE
    return (tn <= tf) & (tf > RAY_TMIN) & (tn < best), tn


def _tri_test(rec, o, d, best):
    """Möller-Trumbore on (R,9) [v0|e1|e2] records: (ok, t, u, v)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rec.unbind(-1)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    px, py, pz = ox - v0x, oy - v0y, oz - v0z
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    uq = px * hx + py * hy + pz * hz
    qx = py * e1z - pz * e1y
    qy = pz * e1x - px * e1z
    qz = px * e1y - py * e1x
    vq = dx * qx + dy * qy + dz * qz
    tq = e2x * qx + e2y * qy + e2z * qz
    adet = torch.abs(det)
    sg = torch.sign(det)
    u_s, v_s, t_s = uq * sg, vq * sg, tq * sg
    ok = (det != 0.0) & (u_s >= 0.0) & (v_s >= 0.0) & (u_s + v_s <= adet) \
        & (t_s > RAY_TMIN * adet) & (t_s < best * adet)
    inv = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    return ok, tq * inv, uq * inv, vq * inv


def _cswap(a, b):
    sw = a[0] > b[0]
    return ((torch.where(sw, b[0], a[0]), torch.where(sw, b[1], a[1])),
            (torch.where(sw, a[0], b[0]), torch.where(sw, a[1], b[1])))


def traverse_plain(tables: TraceTables, org, dir, t_cap, first_hit,
                   overflow, visits=None):
    """Masked per-ray stack traversal vectorised over rays.

    org/dir (N,3), t_cap (N,) f32, first_hit (N,) bool; overflow (1,) i32
    counter (incremented in place); visits: optional [node visits, leaf
    visits] list of ints, incremented in place (the work the rays need,
    for a kernel's bound).  Returns (t, tri, u, v)."""
    n = org.shape[0]
    dev = org.device
    inv = torch.stack([_safe_inv(dir[:, k]) for k in range(3)], dim=1)
    inf = torch.full((n,), math.inf, device=dev)

    root = tables.nodes[0]
    lo4 = root[0:24].reshape(4, 6)[:, 0:3]
    hi4 = root[0:24].reshape(4, 6)[:, 3:6]
    rlo = lo4.min(dim=0).values.expand(n, 3)
    rhi = hi4.max(dim=0).values.expand(n, 3)
    neg = inv < 0
    tn_ = (torch.where(neg, rhi, rlo) - org) * inv
    tf_ = (torch.where(neg, rlo, rhi) - org) * inv
    r_tn = torch.maximum(torch.maximum(tn_[:, 0], tn_[:, 1]), tn_[:, 2])
    r_tf = torch.minimum(torch.minimum(tf_[:, 0], tf_[:, 1]), tf_[:, 2]) \
        * FAR_SCALE
    hit_root = (r_tn <= r_tf) & (r_tf > RAY_TMIN)
    exit_cap = torch.where(hit_root, r_tf * 1.001 + 1e-2,
                           torch.zeros_like(r_tf))
    best = torch.where(t_cap > 0.0, torch.minimum(t_cap, exit_cap), -inf)

    tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    hu = torch.zeros(n, device=dev)
    hv = torch.zeros(n, device=dev)
    st_e = torch.zeros((n, STACK + 1), dtype=torch.int64, device=dev)
    st_t = torch.zeros((n, STACK + 1), device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.where(t_cap > 0.0, 0, -1).to(torch.int64)
    curt = torch.full((n,), -math.inf, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    slots = torch.arange(LEAF_WIDTH, device=dev)


    while True:
        alive = (cur >= 0) | (sp > 0)
        if not bool(alive.any()):
            break
        need = alive & (cur < 0)
        top = torch.clamp(sp - 1, min=0)
        cur = torch.where(need, st_e[lanes, top], cur)
        curt = torch.where(need, st_t[lanes, top], curt)
        sp = torch.where(need, sp - 1, sp)

        # pops whose entry distance is not below the ray's best are pruned
        visit = alive & (curt < best)
        is_leaf = (cur & _LEAF_BIT) != 0
        leaf = torch.nonzero(visit & is_leaf).squeeze(1)
        node = torch.nonzero(visit & ~is_leaf).squeeze(1)
        ent = cur
        cur = torch.where(alive, -1, cur)
        if visits is not None:
            visits[0] += node.numel()
            visits[1] += leaf.numel()
        if leaf.numel():
            _leaf_visit(tables, leaf, ent[leaf], org, dir, best, tri, hu, hv,
                        sp, first_hit, slots)
        if node.numel():
            drops = drops + _node_visit(tables, node, ent[node], org, inv,
                                        best, st_e, st_t, sp, cur, curt)
    overflow += drops.to(overflow.dtype)
    return torch.where(tri >= 0, best, inf), tri, hu, hv


def _leaf_visit(tables, idx, ent, org, dir, best, tri, hu, hv, sp, first_hit,
                slots):
    """Test the 8 slots of each visited leaf; updates the hit state of the
    lanes idx in place (any-hit lanes that accept stop: sp = 0)."""
    base = entry_slot(ent)
    ids = base[:, None] + slots
    k = slots.numel()
    rec = tables.tris[ids].reshape(-1, 9)
    b = best[idx]
    ok, tt, tu, tv = _tri_test(rec, org[idx].repeat_interleave(k, 0),
                               dir[idx].repeat_interleave(k, 0),
                               b.repeat_interleave(k, 0))
    ok, tt, tu, tv = (x.reshape(-1, k) for x in (ok, tt, tu, tv))
    gt = torch.full_like(b, math.inf)
    gtri = torch.zeros_like(base)
    gu = torch.zeros_like(b)
    gv = torch.zeros_like(b)
    for j in range(k):
        gb = ok[:, j] & (tt[:, j] < gt)
        gt = torch.where(gb, tt[:, j], gt)
        gtri = torch.where(gb, ids[:, j], gtri)
        gu = torch.where(gb, tu[:, j], gu)
        gv = torch.where(gb, tv[:, j], gv)
    better = gt < b
    best[idx] = torch.where(better, gt, b)
    tri[idx] = torch.where(better, gtri, tri[idx])
    hu[idx] = torch.where(better, gu, hu[idx])
    hv[idx] = torch.where(better, gv, hv[idx])
    sp[idx] = torch.where(better & first_hit[idx], 0, sp[idx])


def _node_visit(tables, idx, ent, org, inv, best, st_e, st_t, sp, cur, curt):
    """Slab-test the 4 children of each visited node, continue with the
    nearest and push the rest far-to-near; returns the dropped pushes."""
    inf = math.inf
    rec = tables.nodes[ent & 0x3FFFFF]
    o, iv, b = org[idx], inv[idx], best[idx]
    pairs = []
    for c in range(4):
        h, tn = _slab(rec[:, 6 * c:6 * c + 3], rec[:, 6 * c + 3:6 * c + 6],
                      o, iv, b)
        pairs.append((torch.where(h, tn, torch.full_like(tn, inf)),
                      rec[:, 24 + c].to(torch.int64)))
    p0, p1, p2, p3 = pairs
    p0, p1 = _cswap(p0, p1)
    p2, p3 = _cswap(p2, p3)
    p0, p2 = _cswap(p0, p2)
    p1, p3 = _cswap(p1, p3)
    p1, p2 = _cswap(p1, p2)
    s = sp[idx]
    dropped = torch.zeros((), dtype=torch.int64, device=s.device)
    for p in (p3, p2, p1):
        valid = p[0] < inf
        ok = valid & (s < STACK)
        w = torch.where(ok, s, STACK)   # column STACK is a trash slot
        st_e[idx, w] = p[1]
        st_t[idx, w] = p[0]
        s = s + ok.to(s.dtype)
        dropped = dropped + (valid & ~ok).sum()
    sp[idx] = s
    ok0 = p0[0] < inf
    cur[idx] = torch.where(ok0, p0[1], -1)
    curt[idx] = torch.where(ok0, p0[0], torch.full_like(p0[0], inf))
    return dropped


def _resolve(tables, t, tri, u, v) -> PacketHit:
    """Attach the shading attributes of the hit slots."""
    hit = tri >= 0
    slot = torch.where(hit, tri, torch.zeros_like(tri)).long()
    w = 1.0 - u - v
    n = tables.nrm[slot]
    ns = w[:, None] * n[:, 0:3] + u[:, None] * n[:, 3:6] \
        + v[:, None] * n[:, 6:9]
    zero3 = torch.zeros_like(ns)
    return PacketHit(
        t=t, tri=tri.to(torch.int32), u=u, v=v,
        mat=torch.where(hit, tables.mat[slot], 0).to(torch.int32),
        ns=torch.where(hit[:, None], ns, zero3),
        ng=torch.where(hit[:, None], tables.ng[slot], zero3))


def packet_intersect_plain(tables: TraceTables, org, dir, t_max=None, *,
                           any_hit=False, overflow=None,
                           visits=None) -> PacketHit:
    """Plain PyTorch version of the K1 launcher (same arguments; visits as
    in traverse_plain)."""
    n = org.shape[0]
    if t_max is None:
        t_max = torch.full((n,), math.inf, device=org.device)
    if overflow is None:
        overflow = overflow_counter(org.device)
    first = torch.full((n,), bool(any_hit), device=org.device)
    t, tri, u, v = traverse_plain(tables, org, dir, t_max, first, overflow,
                                  visits)
    return _resolve(tables, t, tri, u, v)


# ---------------------------------------------------------------------------
# K1 launcher
# ---------------------------------------------------------------------------


def packet_intersect(tables: TraceTables, org, dir, t_max=None, *,
                     any_hit=False, overflow=None) -> PacketHit:
    """Trace (N,3) rays: closest hit under t_max, or (any_hit=True) each
    ray's first accepted hit.  CPU tensors run the plain version; CUDA
    tensors launch K1 (csrc/traverse.cu)."""
    if org.device.type == "cpu":
        return packet_intersect_plain(tables, org, dir, t_max,
                                      any_hit=any_hit, overflow=overflow)
    n = org.shape[0]
    dev = org.device
    if t_max is None:
        t_max = torch.full((n,), math.inf, device=dev)
    if overflow is None:
        overflow = overflow_counter(dev)
    cuda.check_tensors(dev, org=(org, torch.float32, (n, 3)),
                       dir=(dir, torch.float32, (n, 3)),
                       t_max=(t_max, torch.float32, (n,)),
                       overflow=(overflow, torch.int32, (1,)))
    _check_tables(tables, dev)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    out = PacketHit(t=f32(n), tri=i32(n), u=f32(n), v=f32(n), mat=i32(n),
                    ns=f32(n, 3), ng=f32(n, 3))
    lib = cuda.library()
    cuda.launch(lib.rtrt_traverse, "packet_intersect", dev,
                tables.nodes, tables.tris, tables.nrm, tables.ng, tables.mat,
                org, dir, t_max, ctypes.c_int(n), ctypes.c_int(int(any_hit)),
                out.t, out.tri, out.u, out.v, out.mat, out.ns, out.ng,
                overflow)
    return out


def _check_tables(tables: TraceTables, dev):
    p = tables.tris.shape[0]
    cuda.check_tensors(
        dev, nodes=(tables.nodes, torch.float32, (tables.nodes.shape[0], 32)),
        tris=(tables.tris, torch.float32, (p, 9)),
        nrm=(tables.nrm, torch.float32, (p, 9)),
        ng=(tables.ng, torch.float32, (p, 3)),
        mat=(tables.mat, torch.int32, (p,)))
