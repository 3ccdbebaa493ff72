"""Inputs shared by the refit tests on the CPU (test_torch_refit.py) and on
the card (test_torch_kernels_gpu.py): rays of every direction, a BVH4 whose
empty child slots hold the inverted (+inf, -inf) boxes that refit writes,
and a brute-force closest-hit oracle.  Imports nothing of JAX."""

import numpy as np
import torch

from rtrt_tpu_torch.bvh import packet as P
from rtrt_tpu_torch.bvh.types import _LEAF_BIT


def rays(n, seed, center, spread, device="cpu"):
    """n rays from a cube around `center`; a quarter of them axis-aligned,
    half of those with signed-zero components (inverses +-1e20 in the slab
    test)."""
    rng = np.random.default_rng(seed)
    org = (rng.uniform(-spread, spread, (n, 3)) + center).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n // 4)
    d[: n // 4] = 0.0
    d[np.arange(n // 4), axis] = rng.choice([-1.0, 1.0], n // 4)
    d[: n // 8][d[: n // 8] == 0.0] = -0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(org).to(device), torch.from_numpy(d).to(device)


def brute_hits(tables, org, d):
    """Closest accepted Moller-Trumbore hit over every slot (first slot on
    ties), float32 like the traversal: (t, slot)."""
    n, p = org.shape[0], tables.tris.shape[0]
    best = torch.full((n,), np.inf, device=org.device)
    tri = torch.full((n,), -1, dtype=torch.int64, device=org.device)
    for s in range(0, p, 256):
        rec = tables.tris[s:s + 256]
        k = rec.shape[0]
        ok, t, _, _ = P._tri_test(
            rec.repeat(n, 1), org.repeat_interleave(k, 0),
            d.repeat_interleave(k, 0),
            torch.full((n * k,), np.inf, device=org.device))
        t = torch.where(ok, t, np.inf).reshape(-1, k)
        tmin, arg = t.min(dim=1)
        better = tmin < best
        best = torch.where(better, tmin, best)
        tri = torch.where(better, s + arg, tri)
    return best, tri


def inverted_slot_case(device="cpu"):
    """A root whose child 0 is a leaf of one triangle (x, y in [0, 1] at
    z = 5) and whose children 1-3 are empty slots with inverted (+-inf)
    boxes; 1,024 rays every way through the space around it (a quarter
    axis-aligned) and 128 rays at the triangle's interior from both
    sides.  Returns (tables, org, dir) on `device`."""
    tris_t = torch.tensor([0.0, 0.0, 5.0, 1.0, 0.0, 5.0, 0.0, 1.0, 5.0])
    tris, ng = P._tri_rows(tris_t[:, None].expand(9, 8))
    nodes = torch.zeros((1, 32))
    nodes[0, 0:6] = torch.tensor([0.0, 0.0, 5.0, 1.0, 1.0, 5.0])
    for c in (1, 2, 3):
        nodes[0, 6 * c:6 * c + 3] = np.inf
        nodes[0, 6 * c + 3:6 * c + 6] = -np.inf
    nodes[0, 24:28] = torch.tensor([float(_LEAF_BIT), -1.0, -1.0, -1.0])
    tables = P.TraceTables(nodes=nodes, tris=tris.T.contiguous(),
                           nrm=torch.zeros((8, 9)), ng=ng.contiguous(),
                           mat=torch.zeros(8, dtype=torch.int32))
    org, d = rays(1024, 11, [0.0, 0.0, 0.0], 6.0)
    k = 128
    rng = np.random.default_rng(4)
    tgt = np.stack([rng.uniform(0.05, 0.4, k), rng.uniform(0.05, 0.4, k),
                    np.full(k, 5.0)], 1)
    src = tgt + np.stack([rng.uniform(-2, 2, k), rng.uniform(-2, 2, k),
                          rng.choice([-6.0, 6.0], k)], 1)
    dd = tgt - src
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    org = torch.cat([org, torch.from_numpy(src.astype(np.float32))])
    d = torch.cat([d, torch.from_numpy(dd.astype(np.float32))])
    return tables.to(device), org.to(device), d.to(device)
