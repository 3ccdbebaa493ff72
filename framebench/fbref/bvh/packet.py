# Frozen copy of rtrt_tpu_torch/bvh/packet.py
# (framebench's plain reference).
"""Ray-scene traversal: K1's plain twin (port of rtrt_tpu/bvh/packet.py::
traverse_tile), over the 4-wide SAH tree of a static scene (arity 4) and
the two-level LBVH that bvh/build.py rebuilds (arity 2, one-triangle
leaves).

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
  * a push that does not fit the stack is dropped AND counted in the
    caller's overflow counter (must stay 0 for a correct image).

The stack depth comes from the tree.  A BVH4 of L internal levels needs at
most 3 L entries (each node of the current descent keeps at most its 3 far
children), so `TraceTables` carries L and `stack`, the smallest depth of
STACK_DEPTHS that holds 3 L.  K1, K2 and the plain traversal all use that
depth: the kernels have one instantiation per entry of STACK_DEPTHS
(csrc/traverse.cuh), and a tree deeper than the deepest is refused when
its tables are built, before anything is traced.

The binary two-level tables (`pack_tables_binary`) hold one 64-byte record
a row: both child boxes and both child entries, the JAX kernel's 16 lanes
and the reference's BVHNode.  A node visit slab-tests both children,
continues with the nearer (the left one on a tie) and pushes the other, so
the stack holds at most one entry a level.  In the two-level LBVH a BLAS
node's row is tlas_internal + batch * 1023 + idx, a TLAS node's its 22-bit
field, and a leaf is one triangle.  Its tree is rebuilt every frame of an
animated scene, so its depth cannot be walked on the host (a sync): the
stack comes from the static bound of `binary_stack_bound`.

The hit id is the sorted slot; shading attributes come from the sorted
normal / geometric-normal / material tables at that slot.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .types import _BLAS_BIT, _LEAF_BIT, BATCH_SIZE, BLAS_NODES, \
    entry_batch, entry_idx, entry_slot

# the traversal stack depths (entries) of the kernels' instantiations
# (csrc/traverse.cuh STACK_SMALL, STACK_DEEP).  256 holds every tree that
# bvh/sah.py builds: its SAH splits stop at binary depth 64, the median
# splits below leave at most log2(2^21 / 8) = 18 more internal levels, and
# a BVH4 level consumes at least one binary level, so L <= 82, 3 L <= 246.
STACK_DEPTHS = (32, 256)
LEAF_WIDTH = 8       # triangle slots per leaf row of the BVH4
RAY_TMIN = 1e-4
FAR_SCALE = 1.0 + 3.6e-7
_TINY = 1e-20


@dataclasses.dataclass
class TraceTables:
    """Device-side scene tables of the traversal (GPU layout).

    nodes: the BVH4's (q, 32) f32 128-byte records from
      bvh/sah.py::bvh4_nodes — 4 child AABBs (lo xyz, hi xyz) then 4 child
      entries as exact floats (leaf bit 23, -1 = empty slot), 4 pad floats;
      or a binary tree's (M, 16) f32 64-byte records — 2 child AABBs, then
      the 2 child entries as exact floats, 2 pad floats.
    tris (P, 9) f32: sorted triangles as [v0 | v1 - v0 | v2 - v0].
    nrm (P, 9) f32: sorted vertex normals [n0 | n1 | n2].
    ng (P, 3) f32: unit geometric normal per slot.
    mat (P,) i32: material id per slot.
    The layout (init arguments, kept as attributes; the fields are the
    five tensors): tlas_internal, the TLAS rows of binary tables (B - 1 for
    the two-level LBVH, 0 for the flat SAH tree), None for a BVH4;
    leaf_width, the triangle slots a leaf entry tests (LEAF_WIDTH for a
    BVH4 and the flat SAH tree, 1 for the LBVH; None: the tree's own).
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    nrm: torch.Tensor
    ng: torch.Tensor
    mat: torch.Tensor
    tlas_internal: dataclasses.InitVar[int | None] = None
    leaf_width: dataclasses.InitVar[int | None] = None

    def __post_init__(self, tlas_internal, leaf_width):
        # not fields: the tree's layout and what derives from it (levels:
        # its internal levels, counted for a tree built on the host, the
        # static bound for two-level tables; stack: the traversal stack
        # depth of every traversal of these tables)
        self.tlas_internal = tlas_internal
        if tlas_internal is None:
            self.leaf_width = LEAF_WIDTH
            self.levels = tree_levels(self.nodes)
            self.stack = stack_depth(self.levels)
        elif leaf_width in (None, 1):
            self.leaf_width = 1
            self.levels = binary_stack_bound(self.tris.shape[0]
                                             // BATCH_SIZE)
            self.stack = binary_stack_depth(self.levels)
        else:
            self.leaf_width = leaf_width
            self.levels = tree_levels(self.nodes, arity=2)
            self.stack = binary_stack_depth(self.levels)

    @property
    def arity(self) -> int:
        return 2 if self.tlas_internal is not None else 4

    @property
    def kind(self) -> str:
        """The tree: "bvh4", "lbvh" (two-level, one-triangle leaves) or
        "sah2" (flat binary, leaf rows)."""
        if self.arity == 4:
            return "bvh4"
        return "lbvh" if self.leaf_width == 1 else "sah2"

    def to(self, device) -> "TraceTables":
        return TraceTables(*(getattr(self, f.name).to(device).contiguous()
                             for f in dataclasses.fields(self)),
                           tlas_internal=self.tlas_internal,
                           leaf_width=self.leaf_width)


def tree_levels(nodes, arity: int = 4) -> int:
    """Internal levels of a tree built on the host (the root is level 1): a
    walk from the root over the child entries of its records, the BVH4's
    (q, 32) (floats 24..27) or the flat binary tree's (M, 16) (floats 12,
    13); -1 empty, leaf bit 23, an internal entry's row its 22-bit
    field."""
    nodes = torch.as_tensor(nodes).detach().cpu()
    kids = nodes[:, 6 * arity:7 * arity].to(torch.int64)
    front = torch.zeros(1, dtype=torch.int64)
    levels = 0
    while front.numel():
        levels += 1
        e = kids[front].reshape(-1)
        front = e[(e >= 0) & ((e & _LEAF_BIT) == 0)] & 0x3FFFFF
    return levels


def stack_depth(levels: int) -> int:
    """The smallest traversal stack of STACK_DEPTHS that holds a tree of
    `levels` internal BVH4 levels (3 entries a level); ValueError when the
    deepest does not."""
    need = 3 * levels
    for depth in STACK_DEPTHS:
        if depth >= need:
            return depth
    raise ValueError(
        f"the BVH4 has {levels} internal levels and needs a {need}-entry "
        f"traversal stack; the deepest the kernels hold is "
        f"{max(STACK_DEPTHS)} entries ({max(STACK_DEPTHS) // 3} levels)")


def binary_stack_bound(num_batches: int) -> int:
    """The most entries the near-first traversal of a two-level LBVH over
    `num_batches` 1024-triangle batches holds, from shapes alone.

    A Karras tree's internal node has a larger split delta (the common
    prefix of its range, bvh/build.py::lbvh_topology) than its parent, so a
    path from the root meets at most as many internal nodes as there are
    distinct deltas: 32 values of clz(code_a ^ code_b) for 32-bit keys, and
    for equal codes the index tiebreak 32 + clz((i ^ (i + 1)) | 1), whose
    i ^ (i + 1) over n leaves takes bit_length(n - 1) values (10 for a
    BLAS of 1024 leaves, up to 10 for a TLAS of B <= 1024 batches).  A
    node visit pushes at most one entry (its far child), and the entries
    on the stack belong to distinct nodes of the current path, so the
    stack holds at most the internal depth of the TLAS plus that of a
    BLAS: at most 84 entries."""
    return (32 + (BATCH_SIZE - 1).bit_length()) \
        + (32 + (max(num_batches, 2) - 1).bit_length())


def binary_stack_depth(bound: int) -> int:
    """The smallest traversal stack of STACK_DEPTHS that holds `bound`
    entries of a binary tree (one a level); ValueError when the deepest
    does not."""
    for depth in STACK_DEPTHS:
        if depth >= bound:
            return depth
    raise ValueError(
        f"the binary tree may need a {bound}-entry traversal stack; the "
        f"deepest the kernels hold is {max(STACK_DEPTHS)} entries")


def pack_tables(bvh, tri_nrm_t, tri_mat, nodes4) -> TraceTables:
    """SceneBvh + sorted normals/materials + (q, 32) BVH4 records ->
    TraceTables (on the device of bvh.tris_t)."""
    tt = bvh.tris_t.to(torch.float32)
    tris, ng = _tri_rows(tt)
    dev = tt.device
    return TraceTables(
        nodes=torch.as_tensor(nodes4, dtype=torch.float32,
                              device=dev).contiguous(),
        tris=tris.T.contiguous(),
        nrm=tri_nrm_t.to(dev, torch.float32).T.contiguous(),
        ng=ng.contiguous(),
        mat=tri_mat.to(dev, torch.int32).contiguous())


def binary_nodes(bvh):
    """(M, 16) f32 64-byte records of a two-level SceneBvh: the 12 child-box
    floats, the two child entries as exact floats (bits 0..23 < 2^24), two
    zeros."""
    m = bvh.boxes_t.shape[1]
    dev = bvh.boxes_t.device
    return torch.cat([bvh.boxes_t.T, bvh.children_t.T.to(torch.float32),
                      torch.zeros((m, 2), device=dev)], dim=1).contiguous()


def pack_tables_binary(bvh, tri_nrm_t, tri_mat) -> TraceTables:
    """Two-level SceneBvh (bvh/build.py) + sorted normals / materials ->
    binary TraceTables (on the device of bvh.tris_t)."""
    tt = bvh.tris_t.to(torch.float32)
    tris, ng = _tri_rows(tt)
    return TraceTables(
        nodes=binary_nodes(bvh), tris=tris.T.contiguous(),
        nrm=tri_nrm_t.to(tt.device, torch.float32).T.contiguous(),
        ng=ng.contiguous(),
        mat=tri_mat.to(tt.device, torch.int32).contiguous(),
        tlas_internal=bvh.tlas_internal)


def write_tables_binary(tables: TraceTables, bvh, tri_nrm_t, tri_mat):
    """Write a rebuilt two-level SceneBvh of the same scene into binary
    `tables` in place (records, triangles, normals, geometric normals,
    materials): the tensors keep their storage and the tables their
    static stack depth, so a rebuild reads nothing back to the host."""
    tables.nodes.copy_(binary_nodes(bvh))
    refresh_tables(tables, bvh.tris_t, tri_nrm_t)
    tables.mat.copy_(tri_mat)


def _tri_rows(tt):
    """Sorted (9, P) vertex rows -> ((9, P) [v0 | v1 - v0 | v2 - v0] rows,
    (P, 3) unit geometric normals)."""
    e1 = tt[3:6] - tt[0:3]
    e2 = tt[6:9] - tt[0:3]
    gx = e1[1] * e2[2] - e1[2] * e2[1]
    gy = e1[2] * e2[0] - e1[0] * e2[2]
    gz = e1[0] * e2[1] - e1[1] * e2[0]
    gl = torch.rsqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-20))
    return (torch.cat([tt[0:3], e1, e2], dim=0),
            torch.stack([gx * gl, gy * gl, gz * gl], dim=1))


def refresh_tables(tables: TraceTables, tris_t, nrm_t):
    """Write the triangles of the sorted (9, P) vertex rows `tris_t` and
    the sorted (9, P) vertex normals `nrm_t` into `tables` in place (tris,
    ng by pack_tables' math, nrm).  The tensors keep their storage, and
    the tree's levels and stack depth stay those of its frozen topology:
    no host sync (a new TraceTables would walk the nodes on the host)."""
    tris, ng = _tri_rows(tris_t)
    tables.tris.copy_(tris.T)
    tables.ng.copy_(ng)
    tables.nrm.copy_(nrm_t.T)


@dataclasses.dataclass
class PacketHit:
    t: torch.Tensor    # (N,) inf on miss
    tri: torch.Tensor  # (N,) i32 sorted slot, -1 on miss
    u: torch.Tensor    # (N,) barycentric of v1
    v: torch.Tensor    # (N,) barycentric of v2
    mat: torch.Tensor  # (N,) i32 material id (0 on miss)
    ns: torch.Tensor   # (N,3) interpolated shading normal (not normalised)
    ng: torch.Tensor   # (N,3) unit geometric normal (unoriented)
    steps: torch.Tensor | None = None  # (N,) i32 visits (count_steps)


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
                   overflow, visits=None, max_steps=None, steps=None,
                   depth=None):
    """Masked per-ray stack traversal vectorised over rays.

    org/dir (N,3), t_cap (N,) f32, first_hit (N,) bool; overflow (1,) i32
    counter (incremented in place); visits: optional [node visits, leaf
    visits] list of ints, incremented in place (the work the rays need,
    for a kernel's bound); max_steps: optional cap on each ray's node +
    leaf visits (pops pruned by their entry distance do not count): a ray
    stops there with the best hit found so far; steps: optional (N,) int
    tensor that receives each ray's visits; depth: optional (1,) int
    counter raised to the deepest stack (entries held after a node's
    pushes) of any ray.  The stack holds tables.stack entries, as the
    kernels' does.  Returns (t, tri, u, v)."""
    n = org.shape[0]
    dev = org.device
    inv = torch.stack([_safe_inv(dir[:, k]) for k in range(3)], dim=1)
    inf = torch.full((n,), math.inf, device=dev)

    # the root's child boxes (row 0: the BVH4 root, or the TLAS root)
    kids = tables.nodes[0, 0:6 * tables.arity].reshape(tables.arity, 6)
    rlo = kids[:, 0:3].min(dim=0).values.expand(n, 3)
    rhi = kids[:, 3:6].max(dim=0).values.expand(n, 3)
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
    stack = tables.stack
    st_e = torch.zeros((n, stack + 1), dtype=torch.int64, device=dev)
    st_t = torch.zeros((n, stack + 1), device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.where(t_cap > 0.0, 0, -1).to(torch.int64)
    curt = torch.full((n,), -math.inf, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    slots = torch.arange(tables.leaf_width, device=dev)
    counting = max_steps is not None or steps is not None
    cap = math.inf if max_steps is None else max_steps
    nsteps = torch.zeros(n, dtype=torch.int64, device=dev)

    while True:
        alive = (cur >= 0) | (sp > 0)
        if counting:
            alive &= nsteps < cap
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
        if counting:
            nsteps += visit.to(nsteps.dtype)
        if leaf.numel():
            _leaf_visit(tables, leaf, ent[leaf], org, dir, best, tri, hu, hv,
                        sp, first_hit, slots)
        if node.numel():
            drops = drops + _node_visit(tables, node, ent[node], org, inv,
                                        best, st_e, st_t, sp, cur, curt,
                                        stack)
            if depth is not None:
                torch.maximum(depth, sp.max().to(depth.dtype), out=depth)
    overflow += drops.to(overflow.dtype)
    if steps is not None:
        steps.copy_(nsteps)
    return torch.where(tri >= 0, best, inf), tri, hu, hv


def _leaf_visit(tables, idx, ent, org, dir, best, tri, hu, hv, sp, first_hit,
                slots):
    """Test the slots of each visited leaf (8 in a BVH4 leaf row, 1 in a
    binary tree's leaf); updates the hit state of the lanes idx in place
    (any-hit lanes that accept stop: sp = 0)."""
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


def node_row(tables: TraceTables, ent):
    """Row of the node record of internal entries `ent`: a BLAS node of
    two-level tables sits at tlas_internal + batch * 1023 + idx, any other
    node at its 22-bit field (a TLAS node, a BVH4 node, a node of the flat
    SAH tree)."""
    row = ent & (_BLAS_BIT - 1)
    if tables.kind != "lbvh":
        return row
    return torch.where((ent & _BLAS_BIT) != 0, tables.tlas_internal
                       + entry_batch(ent) * BLAS_NODES + entry_idx(ent), row)


def _node_visit(tables, idx, ent, org, inv, best, st_e, st_t, sp, cur, curt,
                stack):
    """Slab-test the children of each visited node (4 in a BVH4, 2 in a
    binary tree), continue with the nearest and push the rest far-to-near
    onto the `stack`-deep stacks; returns the dropped pushes."""
    inf = math.inf
    rec = tables.nodes[node_row(tables, ent)]
    o, iv, b = org[idx], inv[idx], best[idx]
    arity = tables.arity
    pairs = []
    for c in range(arity):
        h, tn = _slab(rec[:, 6 * c:6 * c + 3], rec[:, 6 * c + 3:6 * c + 6],
                      o, iv, b)
        pairs.append((torch.where(h, tn, torch.full_like(tn, inf)),
                      rec[:, 6 * arity + c].to(torch.int64)))
    if arity == 4:
        p0, p1, p2, p3 = pairs
        p0, p1 = _cswap(p0, p1)
        p2, p3 = _cswap(p2, p3)
        p0, p2 = _cswap(p0, p2)
        p1, p3 = _cswap(p1, p3)
        p1, p2 = _cswap(p1, p2)
        far = (p3, p2, p1)
    else:  # the left child first on a tie
        p0, p1 = _cswap(*pairs)
        far = (p1,)
    s = sp[idx]
    dropped = torch.zeros((), dtype=torch.int64, device=s.device)
    for p in far:
        valid = p[0] < inf
        ok = valid & (s < stack)
        w = torch.where(ok, s, stack)   # column `stack` is a trash slot
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
