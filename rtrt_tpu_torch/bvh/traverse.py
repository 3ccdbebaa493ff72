"""The loop traverser (port of rtrt_tpu/bvh/traverse.py): closest-hit and
any-hit traversal of a SceneBvh (the flat binary SAH tree of a static
scene, or the two-level LBVH) as plain torch ops over all rays at once.
The wavefront integrator's loop route traces with it (render/
integrator.py, Engine(trace="loop")); the JAX CPU frame runs the same
function.

Each step of the loop is the JAX loop body for every ray: fetch the
node's row (both child boxes and entries), slab-test the two children
against the ray's best t, test leaf children's triangles inline with the
watertight test (a leaf entry covers `leaf_width` consecutive slots), go
on with the nearer internal child and push the farther, and where nothing
is left pop the topmost stacked entry that is still nearer than the best
hit (the pruned entries above it cost no step).  The JAX module holds its
48-entry stacks as a lockstep TPU layout; here every ray has its own
stack of STACK_DEPTH entries, deep enough for every tree the port builds,
so the closest hit is the same.  Every ray stops after `max_steps` steps
(the JAX loop's cap, 1024 by default) with the best hit found so far.

Triangle ids are sorted slots (-1: miss); the same slots index the sorted
vertex rows, normals and materials."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.geometry import RAY_TMIN, make_ray_aux, ray_triangle_watertight
from ..core.precision import GAMMA3
from .types import (BATCH_SIZE, BLAS_NODES, GROUP, SceneBvh, entry_batch,
                    entry_idx, entry_is_blas, entry_is_leaf)

MAX_TRAVERSAL_STEPS = 1024
# stack entries per ray: a node visit pushes at most its far child, and
# the entries on the stack are of distinct internal levels of the current
# path, so a tree of L internal levels needs L.  The SAH build's trees
# have at most 82 (bvh/packet.py, STACK_DEPTHS), the LBVH at most 84
# (packet.binary_stack_bound).  A push beyond is dropped and counted.
STACK_DEPTH = 96
_ROW_MASK = (1 << 22) - 1


@dataclasses.dataclass
class Hit:
    """Closest-hit result: sorted triangle slots, -1 on a miss."""

    t: torch.Tensor    # (N,) f32, inf on a miss
    tri: torch.Tensor  # (N,) int32
    u: torch.Tensor    # (N,) barycentric of v1
    v: torch.Tensor    # (N,) barycentric of v2


def _sel3(k, x, y, z):
    return torch.where(k == 0, x, torch.where(k == 1, y, z))


def intersect_scene(bvh: SceneBvh, org, dir, t_max=None, *, any_hit=False,
                    leaf_width: int = 1, max_steps=MAX_TRAVERSAL_STEPS,
                    overflow=None, steps=None) -> Hit:
    """Trace (N, 3) rays against the scene under t_max (N,) (None: inf).
    any_hit=True stops a ray at its first accepted hit (t / tri then
    report that hit, not the closest).  overflow: optional (1,) int counter
    of dropped pushes (incremented in place); steps: optional (N,) int
    tensor that receives each ray's steps (< max_steps for every ray that
    finished)."""
    n = org.shape[0]
    dev = org.device
    if t_max is None:
        t_max = torch.full((n,), math.inf, device=dev)
    aux = make_ray_aux(dir)
    ox, oy, oz = org.unbind(-1)
    ix, iy, iz = aux.inv_dir.unbind(-1)
    kx, ky, kz, sx, sy, sz = aux.kx, aux.ky, aux.kz, aux.sx, aux.sy, aux.sz
    neg = (ix < 0.0, iy < 0.0, iz < 0.0)
    far_scale = 1.0 + 2.0 * GAMMA3
    tlas_internal = bvh.tlas_internal
    boxes, kids, tris = bvh.boxes_t, bvh.children_t.to(torch.int64), \
        bvh.tris_t

    def slab(bc, best):
        """Slab test of the 6 gathered box components (lo xyz, hi xyz)."""
        tn, tf = None, None
        for a, (o, inv, ng) in enumerate(zip((ox, oy, oz), (ix, iy, iz),
                                             neg)):
            lo, hi = bc[a], bc[a + 3]
            na = (torch.where(ng, hi, lo) - o) * inv
            fa = (torch.where(ng, lo, hi) - o) * inv
            tn = na if tn is None else torch.maximum(tn, na)
            tf = fa if tf is None else torch.minimum(tf, fa)
        tf = tf * far_scale
        return (tn <= tf) & (tf > RAY_TMIN) & (tn < best), \
            torch.clamp(tn, min=RAY_TMIN)

    def tri_test(tc, best):
        """Watertight test on the 9 gathered vertex components."""
        def prep(c0, c1, c2):
            px, py, pz = c0 - ox, c1 - oy, c2 - oz
            return (_sel3(kx, px, py, pz), _sel3(ky, px, py, pz),
                    _sel3(kz, px, py, pz))

        axx, axy, axz = prep(tc[0], tc[1], tc[2])
        bxx, bxy, bxz = prep(tc[3], tc[4], tc[5])
        cxx, cxy, cxz = prep(tc[6], tc[7], tc[8])
        ax, ay = axx - sx * axz, axy - sy * axz
        bx, by = bxx - sx * bxz, bxy - sy * bxz
        cx, cy = cxx - sx * cxz, cxy - sy * cxz
        u = cx * by - cy * bx
        v = ax * cy - ay * cx
        w = bx * ay - by * ax
        same = ((u >= 0) & (v >= 0) & (w >= 0)) \
            | ((u <= 0) & (v <= 0) & (w <= 0))
        det = u + v + w
        t_scaled = u * (sz * axz) + v * (sz * bxz) + w * (sz * cxz)
        ts = t_scaled * torch.sign(det)
        absdet = torch.abs(det)
        hit = same & (det != 0.0) & (ts > RAY_TMIN * absdet) \
            & (ts < best * absdet)
        inv_det = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
        return hit, t_scaled * inv_det, v * inv_det, w * inv_det

    slot = torch.arange(STACK_DEPTH, device=dev)[None, :]
    lanes = torch.arange(n, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)  # the root, row 0
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    istack = torch.full((n, STACK_DEPTH), -1, dtype=torch.int64, device=dev)
    tstack = torch.full((n, STACK_DEPTH), math.inf, device=dev)
    best_t = t_max.to(torch.float32).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    nsteps = torch.zeros(n, dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    n_slots = max(leaf_width, GROUP)

    for _ in range(max_steps):
        valid = cur != -1
        alive = valid | (sp > 0)
        if not bool(alive.any()):
            break
        nsteps += alive.to(nsteps.dtype)
        # the node's row (the stack holds internal nodes only): a BLAS node
        # of the two-level tree, or any other node's 22-bit field
        row = torch.where(entry_is_blas(cur), tlas_internal + entry_batch(
            cur) * BLAS_NODES + entry_idx(cur), cur & _ROW_MASK)
        row = torch.where(valid, row, 0)
        bc = boxes[:, row]
        le, re = kids[0, row], kids[1, row]
        hl, tl = slab(bc[0:6], best_t)
        hr, tr = slab(bc[6:12], best_t)
        hl = hl & valid
        hr = hr & valid
        l_leaf, r_leaf = entry_is_leaf(le), entry_is_leaf(re)

        # leaf children: their triangles tested inline, left then right
        for child, chit, cleaf in ((le, hl, l_leaf), (re, hr, r_leaf)):
            do = chit & cleaf
            base = entry_batch(child) * BATCH_SIZE + entry_idx(child) * GROUP
            for k in range(n_slots):
                tri_idx = base + k
                tc = tris[:, torch.where(do, tri_idx, 0)]
                thit, tt, tu, tv = tri_test(tc, best_t)
                better = do & thit & (tt < best_t)
                best_t = torch.where(better, tt, best_t)
                best_tri = torch.where(better, tri_idx, best_tri)
                best_u = torch.where(better, tu, best_u)
                best_v = torch.where(better, tv, best_v)

        # internal children: the nearer next, the farther pushed
        lh = hl & ~l_leaf
        rh = hr & ~r_leaf
        both = lh & rh
        near_is_l = tl <= tr
        near_e = torch.where(near_is_l, le, re)
        far_e = torch.where(near_is_l, re, le)
        far_t = torch.maximum(tl, tr)
        push = both & (sp < STACK_DEPTH)
        dropped = dropped + (both & ~push).sum()
        onehot = push[:, None] & (slot == sp[:, None])
        istack = torch.where(onehot, far_e[:, None], istack)
        tstack = torch.where(onehot, far_t[:, None], tstack)
        sp = sp + push.to(sp.dtype)
        none = torch.full_like(cur, -1)
        nxt = torch.where(both, near_e, torch.where(
            lh, le, torch.where(rh, re, none)))
        if any_hit:
            found = best_tri >= 0
            nxt = torch.where(found, none, nxt)
            sp = torch.where(found, 0, sp)

        # pop: the topmost stacked entry still nearer than the best hit
        need_pop = (nxt == -1) & (sp > 0)
        live = (slot < sp[:, None]) & (tstack < best_t[:, None])
        top = torch.where(live, slot + 1, 0).amax(dim=1)
        sp2 = torch.clamp(top - 1, min=0)
        popped = istack[lanes, sp2]
        cur = torch.where(need_pop & (top > 0), popped, nxt)
        sp = torch.where(need_pop, torch.where(top > 0, sp2, 0), sp)

    if overflow is not None:
        overflow += dropped.to(overflow.dtype)
    if steps is not None:
        steps.copy_(nsteps)
    miss = best_tri < 0
    return Hit(torch.where(miss, math.inf, best_t), best_tri.to(torch.int32),
               best_u, best_v)


def occluded(bvh: SceneBvh, org, dir, t_max,
             max_steps=MAX_TRAVERSAL_STEPS, leaf_width: int = 1):
    """Any-hit occlusion: True where a blocker lies within t_max."""
    return intersect_scene(bvh, org, dir, t_max, any_hit=True,
                           max_steps=max_steps,
                           leaf_width=leaf_width).tri >= 0


def intersect_brute(org, dir, v0, v1, v2, valid=None, t_max=None) -> Hit:
    """O(rays x triangles) closest-hit oracle for tests, with the loop's
    watertight test: (N, 3) rays against (T, 3) vertices; valid (T,)
    masks triangles."""
    n = org.shape[0]
    if t_max is None:
        t_max = torch.full((n,), math.inf, device=org.device)
    aux = make_ray_aux(dir)
    aux = dataclasses.replace(aux, **{
        f.name: getattr(aux, f.name)[:, None] if getattr(
            aux, f.name).dim() == 1 else getattr(aux, f.name)[:, None, :]
        for f in dataclasses.fields(aux)})
    th = ray_triangle_watertight(org[:, None, :], aux, v0[None], v1[None],
                                 v2[None], RAY_TMIN, t_max[:, None])
    t = th.t
    if valid is not None:
        t = torch.where(valid[None, :], t, math.inf)
    best = torch.argmin(t, dim=1)
    bt = t.gather(1, best[:, None])[:, 0]
    miss = ~torch.isfinite(bt)
    bu = th.u.gather(1, best[:, None])[:, 0]
    bv = th.v.gather(1, best[:, None])[:, 0]
    return Hit(torch.where(miss, math.inf, bt),
               torch.where(miss, -1, best).to(torch.int32), bu, bv)
