"""Per-frame BVH4 refit for animated geometry (port of rtrt_tpu/bvh/refit.py).

The init-time SAH/BVH4 topology is frozen; each frame

  * the sorted (9, P) triangle table is displaced (engine/frame.py);
  * `leaf_bounds` recomputes the row-aligned leaf boxes with one
    reshape-reduce over slots [0, n_leaves * LEAF_WIDTH);
  * `refit_nodes4` refits the 4-wide records level-synchronously, bottom
    up: each node takes min/max over its children's boxes.

`plan_refit4` and the functional `refit_nodes4` are the JAX module's (host
numpy schedule; per level and child a masked gather).  The frame runs
`DeviceRefit`, the same levels and the same min/max on the device in a few
launches a level: one box buffer holds the leaf boxes, then the node boxes,
then a sentinel (+inf, -inf) row for empty slots, and each level is one
`index_select` of its (k, 4) child rows, an `amin` / `amax` over the
children and two `index_copy_`, into the records and into the buffer.  All
its indices are device tensors made once, so a frame's refit has no host
sync.  Empty slots hold inverted (+inf, -inf) boxes, which every slab test
of the port misses without NaN (the native collapse writes +-1e30).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .packet import LEAF_WIDTH
from .types import _LEAF_BIT


class RefitPlan(NamedTuple):
    """Static refit schedule for a 4-wide flat SAH tree (host numpy).

    Per level (leaf-most first), arrays of shape (k, 4):
      idx:    (k,)  node ids at this level
      cleaf:  child slot is a leaf
      cempty: child slot is empty (inverted box)
      clidx:  leaf index (slot_base // LEAF_WIDTH) for leaf children
      cnode:  node id for internal children
    """

    levels: tuple
    entries_f32: np.ndarray   # (q, 4) static child entries as exact f32
    q: int
    n_leaves: int


def plan_refit4(nodes4_raw: np.ndarray) -> RefitPlan:
    """The level-synchronous schedule of raw (q, 32) BVH4 records
    (bvh/sah.py::bvh4_nodes)."""
    nodes4_raw = np.asarray(nodes4_raw)
    q = nodes4_raw.shape[0]
    ent = nodes4_raw[:, 24:28].astype(np.int64)   # exact: entries < 2^24
    cempty = ent < 0
    cleaf = ((ent & _LEAF_BIT) != 0) & ~cempty
    cint = ~cempty & ~cleaf
    slot = ((ent >> 11) & 0x7FF) * 1024 + (ent & 0x7FF)
    clidx = np.where(cleaf, slot // LEAF_WIDTH, 0).astype(np.int32)
    cnode = np.where(cint, ent & 0x3FFFFF, 0).astype(np.int32)

    # children have larger ids than their parent (DFS pop order in the
    # collapse): one reverse pass assigns bottom-up levels
    level = np.zeros(q, np.int32)
    for i in range(q - 1, -1, -1):
        lv = 0
        for c in range(4):
            if cint[i, c]:
                lv = max(lv, level[cnode[i, c]] + 1)
        level[i] = lv

    levels = []
    for lv in range(int(level.max()) + 1):
        idx = np.nonzero(level == lv)[0].astype(np.int32)
        levels.append((idx, cleaf[idx], cempty[idx], clidx[idx], cnode[idx]))

    n_leaves = int(slot[cleaf].max() // LEAF_WIDTH) + 1 if cleaf.any() else 0
    return RefitPlan(levels=tuple(levels),
                     entries_f32=nodes4_raw[:, 24:28].astype(np.float32),
                     q=q, n_leaves=n_leaves)


def leaf_bounds(tris_t, n_leaves: int):
    """Row-aligned leaf boxes of the sorted (9, P) triangle table: returns
    (leaf_lo, leaf_hi), each (n_leaves, 3).  Short leaves carry duplicate
    triangles, which are harmless under min / max."""
    lo, hi = _leaf_minmax(tris_t, n_leaves)
    return lo.T.contiguous(), hi.T.contiguous()


def _leaf_minmax(tris_t, n_leaves: int):
    """(3, n_leaves) leaf minima and maxima (views of the reduction)."""
    # (vertex, axis, leaf, slot)
    c = tris_t[:, :n_leaves * LEAF_WIDTH].reshape(3, 3, n_leaves, LEAF_WIDTH)
    return c.amin(dim=(0, 3)), c.amax(dim=(0, 3))


def refit_nodes4(plan: RefitPlan, leaf_lo, leaf_hi):
    """Level-synchronous bottom-up refit in the JAX module's form (per level
    and child slot a masked gather): the refitted raw (q, 32) records."""
    dev = leaf_lo.device
    q = plan.q
    out = torch.zeros((q, 32), dtype=torch.float32, device=dev)
    nlo = torch.full((q, 3), math.inf, device=dev)
    nhi = torch.full((q, 3), -math.inf, device=dev)
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for idx, cleaf, cempty, clidx, cnode in plan.levels:
        k = idx.shape[0]
        rows = []
        box_lo = torch.full((k, 3), math.inf, device=dev)
        box_hi = torch.full((k, 3), -math.inf, device=dev)
        for c in range(4):
            lf, em = dt(cleaf[:, c:c + 1]), dt(cempty[:, c:c + 1])
            li, ni = dt(clidx[:, c]).long(), dt(cnode[:, c]).long()
            clo = torch.where(lf, leaf_lo[li], nlo[ni])
            chi = torch.where(lf, leaf_hi[li], nhi[ni])
            clo = torch.where(em, math.inf, clo)
            chi = torch.where(em, -math.inf, chi)
            rows.append(torch.cat([clo, chi], dim=1))
            box_lo = torch.minimum(box_lo, clo)
            box_hi = torch.maximum(box_hi, chi)
        ii = dt(idx).long()
        out[ii] = torch.cat(rows + [dt(plan.entries_f32[idx]),
                                    torch.zeros((k, 4), device=dev)], dim=1)
        nlo[ii] = box_lo
        nhi[ii] = box_hi
    return out


class DeviceRefit:
    """The plan's levels as device index tensors, and the frame's refit.

    The box buffer `boxes` ((n_leaves + q + 1, 6): leaf boxes, node boxes,
    the sentinel row) and the per-level (node ids, (k, 4) child rows into
    `boxes`) are made once; `refit(nodes, tris_t)` then writes the refitted
    boxes of the displaced table into the records `nodes` ((q, 32), in
    place: lanes 0-23; the entry lanes 24-27 and the zero lanes 28-31 are
    the init-time records')."""

    def __init__(self, plan: RefitPlan, device):
        self.plan = plan
        self.n_leaves = plan.n_leaves
        nl = plan.n_leaves
        sentinel = nl + plan.q
        self.boxes = torch.empty((sentinel + 1, 6), dtype=torch.float32,
                                 device=device)
        self.boxes[sentinel, 0:3] = math.inf
        self.boxes[sentinel, 3:6] = -math.inf
        self.levels = []
        for idx, cleaf, cempty, clidx, cnode in plan.levels:
            rows = np.where(cempty, sentinel,
                            np.where(cleaf, clidx, nl + cnode))
            dt = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)
            # (node ids, their rows in `boxes`, their (k, 4) child rows)
            self.levels.append((dt(idx), dt(idx + nl), dt(rows.reshape(-1))))

    def refit(self, nodes, tris_t):
        """Refit the records `nodes` (q, 32) in place from the displaced
        sorted (9, P) table `tris_t`."""
        nl = self.n_leaves
        lo, hi = _leaf_minmax(tris_t, nl)
        self.boxes[:nl, 0:3].copy_(lo.T)
        self.boxes[:nl, 3:6].copy_(hi.T)
        rec = nodes[:, 0:24]
        for idx, brow, rows in self.levels:
            cb = self.boxes.index_select(0, rows).reshape(-1, 4, 6)
            rec.index_copy_(0, idx, cb.reshape(-1, 24))
            box = torch.cat([cb[:, :, 0:3].amin(1), cb[:, :, 3:6].amax(1)],
                            dim=1)
            self.boxes.index_copy_(0, brow, box)
        return nodes
