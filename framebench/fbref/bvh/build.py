# Frozen copy of rtrt_tpu_torch/bvh/build.py
# (framebench's plain reference).
"""Two-level LBVH construction on the device (port of rtrt_tpu/bvh/build.py).

Per 1024-triangle batch: triangle boxes -> 30-bit morton codes of their
centres in the batch's box -> sort -> Karras (2012) topology -> node boxes
from a doubling sparse table of the sorted leaf boxes (every internal node
covers a contiguous range of sorted leaves).  Then the same over the
batches' boxes for the TLAS, whose leaves are pre-resolved to their
batch's BLAS root.  Every stage is a few torch ops over all batches at
once; loop counts come from static shapes (log2 of 1024 and of B), so the
build reads nothing back to the host.

The JAX form avoids gathers, which run near-serially on a TPU; on the card
a gather is cheap, so the topology reads its sparse table with index
gathers, and the sorted permutation is an index gather (ops/gather.py).
The integer results and the min / max of the same float32 boxes are those
of the JAX build bit for bit (tests/test_torch_lbvh.py).

Tree depth: an internal node's split delta (the common-prefix length of
its range, bvh/packet.py::binary_stack_bound) is larger than its parent's,
so a path from a root holds at most as many internal nodes as there are
distinct deltas.
"""

from __future__ import annotations

import torch

from ..core.geometry import triangle_aabb
from ..ops.gather import onehot_permute
from ..ops.morton import morton3d_30, normalize_to_aabb
from ..ops.reduce import bit_length, build_minmax_table, range_minmax
from ..ops.sort import PAD_KEY, sort_key_index
from .types import BATCH_SIZE, BLAS_NODES, GROUP, GROUPS_PER_BATCH, \
    SceneBvh, pack_entry


def _clz32(x):
    """Leading zeros of 32-bit values held in int64 (clz(0) = 32)."""
    return 32 - bit_length(x, 32)


def lbvh_topology(codes):
    """LBVH topology of sorted codes (..., N) (N static, >= 2; int64
    holding uint32 values; leading dims are batches).

    Returns (left, right, first, last), each (..., N - 1) int64: left /
    right use `child >= 0` = internal node index, `child < 0` = leaf index
    encoded as ~child; first / last = the inclusive sorted-leaf range of
    the internal node.  Equal codes are split by the index-XOR tiebreak
    (as if the leaf index were appended to the code).
    """
    n = codes.shape[-1]
    dev = codes.device
    log2n = max(1, (n - 1).bit_length())
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)

    # adj[k] = delta(k, k + 1), the common-prefix length of neighbours;
    # delta(i, j) = min(adj[min(i,j) .. max(i,j) - 1]) for sorted codes
    x = codes[..., :-1] ^ codes[..., 1:]
    adj = torch.where(x != 0, _clz32(x), 32 + _clz32((i ^ (i + 1)) | 1))

    # tab[k][p] = min(adj[p .. p + 2^k - 1]), -1 past the end; stored with
    # `lpad` columns of -1 on the left and one on the right, so that every
    # probe position of the searches below (-2^log2n <= p <= n - 1) reads
    # its value or -1 without a mask
    lpad = 1 << log2n
    neg = lambda m: torch.full(adj.shape[:-1] + (m,), -1, dtype=torch.int64,
                               device=dev)
    tab = [adj]
    for k in range(log2n):
        prev = tab[-1]
        sh = torch.cat([prev[..., 1 << k:], neg(min(1 << k, n - 1))], -1)
        tab.append(torch.minimum(prev, sh))
    tab = [torch.cat([neg(lpad), t, neg(1)], -1) for t in tab]

    def delta_at(lvl, start):
        """delta over the 2^lvl adjacent pairs from `start` (-1 outside)."""
        return torch.gather(tab[lvl], -1, start + lpad)

    adj_left = torch.cat([neg(1), adj[..., :-1]], -1)

    # direction: toward the longer common prefix
    d = torch.where(adj >= adj_left, 1, -1)
    delta_min = torch.where(d > 0, adj_left, adj)

    # the range length l by binary descent from the top level: grow l by
    # 2^k while the next 2^k adjacent deltas stay > delta_min; the running
    # min of the committed blocks is delta(i, j)
    ib = i.expand_as(adj)
    l = torch.zeros_like(adj)
    delta_node = torch.full_like(adj, 127)  # min identity
    for k in range(log2n, -1, -1):
        probe = delta_at(k, torch.where(d > 0, ib + l, ib - l - (1 << k)))
        grow = probe > delta_min
        l = torch.where(grow, l + (1 << k), l)
        delta_node = torch.where(grow, torch.minimum(delta_node, probe),
                                 delta_node)
    j = ib + l * d

    # split: the longest prefix (from i toward d) whose adjacent deltas all
    # stay > delta_node
    s = torch.zeros_like(adj)
    for k in range(log2n, -1, -1):
        grow = delta_at(k, torch.where(d > 0, ib + s, ib - s - (1 << k))) \
            > delta_node
        s = torch.where(grow, s + (1 << k), s)

    gamma = ib + s * d + torch.clamp(d, max=0)
    first = torch.minimum(ib, j)
    last = torch.maximum(ib, j)
    left = torch.where(first == gamma, ~gamma, gamma)
    right = torch.where(last == gamma + 1, ~(gamma + 1), gamma + 1)
    return left, right, first, last


def fit_node_boxes(left, right, first, last, gamma, leaf_lo, leaf_hi):
    """Each internal node's child-box pair [Llo, Lhi, Rlo, Rhi]: the left
    child covers sorted leaves [first, gamma], the right [gamma + 1, last];
    both are sparse-table range queries.  leaf_lo / leaf_hi (..., N, 3)
    -> (..., N - 1, 12)."""
    lo_t, hi_t = build_minmax_table(leaf_lo, leaf_hi)
    llo, lhi = range_minmax(lo_t, hi_t, first, gamma)
    rlo, rhi = range_minmax(lo_t, hi_t, gamma + 1, last)
    return torch.cat([llo, lhi, rlo, rhi], dim=-1)


def _gamma_from_children(left, right):
    """The split leaf index, from the child encoding."""
    return torch.where(left < 0, ~left, left)


def build_scene_bvh(v0, v1, v2, valid) -> SceneBvh:
    """The full two-level BVH.

    v0, v1, v2: (B, 1024, 3) f32 triangle vertices (padded slots
    arbitrary); valid: (B, 1024) bool, False for padding.  B >= 2.
    Returns a SceneBvh (on the vertices' device) with the triangles in
    sorted leaf order.
    """
    b = v0.shape[0]
    assert v0.shape[1] == BATCH_SIZE and b >= 2, (v0.shape, b)
    dev = v0.device
    inf = float("inf")
    vm = valid[..., None]

    # per-triangle boxes; padding is the empty box (never hit)
    lo, hi = triangle_aabb(v0, v1, v2)
    lo = torch.where(vm, lo, inf)
    hi = torch.where(vm, hi, -inf)

    # batch boxes + morton codes; padding sorts last
    batch_lo = lo.amin(1)
    batch_hi = hi.amax(1)
    unit = normalize_to_aabb(0.5 * (lo + hi), batch_lo[:, None],
                             batch_hi[:, None])
    codes = morton3d_30(torch.where(vm, unit, 0.0))
    codes = torch.where(valid, codes, PAD_KEY)

    # per-batch sort (reorder: sorted slot -> original in-batch index), and
    # the vertices and valid mask in that order; padding triangles collapse
    # to a point at the origin (a degenerate triangle never passes the
    # triangle test), and the sorted leaf boxes are recomputed from them
    sorted_codes, reorder = sort_key_index(codes)
    s = onehot_permute(torch.cat([v0, v1, v2, vm.to(v0.dtype)], -1),
                       reorder)
    s_valid = s[..., 9:10] > 0.5
    s_v0 = torch.where(s_valid, s[..., 0:3], 0.0)
    s_v1 = torch.where(s_valid, s[..., 3:6], 0.0)
    s_v2 = torch.where(s_valid, s[..., 6:9], 0.0)
    s_lo, s_hi = triangle_aabb(s_v0, s_v1, s_v2)
    s_lo = torch.where(s_valid, s_lo, inf)
    s_hi = torch.where(s_valid, s_hi, -inf)

    # GROUP morton-adjacent triangles a leaf (GROUP = 1: the reshape-reduce
    # is the identity, kept for the JAX form)
    g_lo = s_lo.reshape(b, GROUPS_PER_BATCH, GROUP, 3).amin(2)
    g_hi = s_hi.reshape(b, GROUPS_PER_BATCH, GROUP, 3).amax(2)
    g_codes = sorted_codes[:, ::GROUP]

    # BLAS topology + boxes, all batches at once
    left, right, first, last = lbvh_topology(g_codes)
    gamma = _gamma_from_children(left, right)
    blas_boxes = fit_node_boxes(left, right, first, last, gamma, g_lo, g_hi)

    batch_ids = torch.arange(b, dtype=torch.int64, device=dev)[:, None]

    def pack_blas(child):
        is_leaf = child < 0
        return pack_entry(torch.where(is_leaf, ~child, child), batch_ids,
                          True, is_leaf)

    blas_children = torch.stack([pack_blas(left), pack_blas(right)], -1)

    # TLAS over the batches' boxes
    valid_batch = valid.any(1)
    t_lo = torch.where(valid_batch[:, None], batch_lo, inf)
    t_hi = torch.where(valid_batch[:, None], batch_hi, -inf)
    root_lo = t_lo.amin(0)
    root_hi = t_hi.amax(0)
    t_centers = normalize_to_aabb(0.5 * (t_lo + t_hi), root_lo, root_hi)
    t_codes = torch.where(valid_batch, morton3d_30(t_centers), PAD_KEY)
    t_sorted, t_reorder = sort_key_index(t_codes)
    t_left, t_right, t_first, t_last = lbvh_topology(t_sorted)
    t_gamma = _gamma_from_children(t_left, t_right)
    tlas_boxes = fit_node_boxes(t_left, t_right, t_first, t_last, t_gamma,
                                t_lo[t_reorder], t_hi[t_reorder])

    # TLAS children: a leaf resolves to its batch's BLAS root (node 0)
    def pack_tlas(child):
        is_leaf = child < 0
        leaf_batch = t_reorder[torch.where(is_leaf, ~child, 0)]
        return torch.where(
            is_leaf, pack_entry(torch.zeros_like(child), leaf_batch, True,
                                False),
            pack_entry(torch.clamp(child, min=0), 0, False, False))

    tlas_children = torch.stack([pack_tlas(t_left), pack_tlas(t_right)], -1)

    # flatten: TLAS rows first, then every batch's BLAS rows
    flat_boxes = torch.cat([tlas_boxes, blas_boxes.reshape(
        b * BLAS_NODES, 12)], 0)
    flat_children = torch.cat([tlas_children, blas_children.reshape(
        b * BLAS_NODES, 2)], 0).to(torch.int32)
    t = b * BATCH_SIZE
    tris_t = torch.cat([s_v0.reshape(t, 3).T, s_v1.reshape(t, 3).T,
                        s_v2.reshape(t, 3).T], 0)
    return SceneBvh(
        boxes_t=flat_boxes.T.contiguous(),
        children_t=flat_children.T.contiguous(),
        tris_t=tris_t.contiguous(),
        sorted_tri_index=(batch_ids * BATCH_SIZE + reorder).reshape(-1).to(
            torch.int32),
        root_lo=root_lo, root_hi=root_hi)
