"""Leaf-visit replica: kernel K7 and its plain twin (port of
tools/probe_leaf.py).

Every step of the loop visits one leaf row of `tab` with the whole
(rows, 128) ray tile: 8 Moller-Trumbore record tests, the running best per
lane, the tile-wide max of the best as the prune bound, an index popped
from a scalar stack, data-dependent branches.  The modes strip one piece
at a time (csrc/probe_leaf.cu lists them).  One launch is one thread block
on one SM: ns/visit is the latency of a visit on one SM, beside the floor
of its float operations (LANE_OPS) on that SM.

Usage: python -m rtrt_tpu_torch.tools.probe_leaf [--rows 32]
"""

from __future__ import annotations

import argparse
import ctypes
import math

import numpy as np
import torch

from ..utils import cuda, timing

MODES = ("full", "nored", "noextr", "nomath", "nocond", "rec2", "dep", "fat",
         "carry4")
MAX_ROWS = 32  # 4 lanes per thread, at most 1024 threads
RAY_TMIN = 1e-4
# float operations per lane per visit, counted from make_kernel: a
# Moller-Trumbore test is 58 (3 sub; 6 mul + 3 sub for h; 3 dots of 3 mul +
# 2 add; 6 mul + 3 sub for q; abs, sign, 3 sign products; 6 compares, 1
# add, 2 mul for the accept; divide and select for 1/det; t), a record 60
# with the running-min compare and select; the visit adds the better
# compare, its select and the tile-wide max (~1 per lane).  nomath's record
# is 7 mul + 6 add + 3.  carry4's 3 products are dead (the kernel, like
# the JAX one, drops them after the branches), so they are not counted.
_MT = 58
_REC = _MT + 2
LANE_OPS = {"full": 8 * _REC + 3, "nored": 8 * _REC + 2,
            "noextr": 8 * _REC + 3, "nomath": 8 * 16 + 3,
            "nocond": 8 * _REC + 3, "rec2": 2 * _REC + 3,
            "dep": 8 * _REC + 3, "fat": 8 * _REC + 3,
            "carry4": 8 * _REC + 3}
_LITERAL = (0.1, 0.2, 0.3, 1.0, 0.0, 0.1, 0.0, 1.0, 0.1)  # noextr's record


def tool_inputs(rows: int, device="cuda", seed: int = 0):
    """The JAX tool's inputs: tab = (arange % 5) * 0.3 - 0.5 as (128, 128)
    f32; planes (6, rows, 128) = ox oy oz dx dy dz uniform in [-1, 1) from
    default_rng(seed)."""
    tab = (np.arange(128 * 128, dtype=np.float32) % np.float32(5.0)) \
        .reshape(128, 128) * np.float32(0.3) - np.float32(0.5)
    rng = np.random.default_rng(seed)
    planes = np.stack([rng.uniform(-1, 1, (rows, 128)) for _ in range(6)])
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(planes.astype(np.float32)).to(device))


def hit_rays(shape, rng) -> np.ndarray:
    """(6, *shape) f32 rays every one of which hits every record of
    hit_rows: origins on a 1/16 grid in [-1, 1)^2 at z = -4, directions
    toward P = (0.25, 0.5, 0.5) (not normalised).  Every value is on a
    coarse dyadic grid, so the Moller-Trumbore products are exact and any
    two float32 implementations agree, whether or not they contract a
    product and a sum into one FMA."""
    ox = rng.integers(-16, 16, shape) / 16
    oy = rng.integers(-16, 16, shape) / 16
    oz = np.full(shape, -4.0)
    return np.stack([ox, oy, oz, 0.25 - ox, 0.5 - oy,
                     np.full(shape, 4.5)]).astype(np.float32)


def hit_rows(nrows: int) -> np.ndarray:
    """(nrows, 128) f32 leaf rows: record k of row r at lanes 16k..16k+8,
    [v0 | e1 | e2] with v0 = (-24, -8, z), e1 = (32, 0, 1/4),
    e2 = (64, 32, 1/2), z = -3 + ((8 r + k) * 37 % 97) / 16: large tilted
    triangles at distinct depths that hit_rays cross at u in [0.14, 0.33],
    v in [0.23, 0.29].  nomath's 7-term sum of such a record exceeds its
    0.5 threshold for every ray too (by 0.375 at least)."""
    tab = np.zeros((nrows, 128), np.float32)
    k = np.arange(8)
    for r in range(nrows):
        z = -3 + ((8 * r + k) * 37 % 97) / 16
        rec = np.stack([np.full(8, -24.0), np.full(8, -8.0), z,
                        np.full(8, 32.0), np.zeros(8), np.full(8, 0.25),
                        np.full(8, 64.0), np.full(8, 32.0),
                        np.full(8, 0.5)], 1)
        tab[r].reshape(8, 16)[:, :9] = rec
    return tab


def hit_inputs(rows: int, device="cuda", seed: int = 0):
    """Inputs on which every lane hits in every visit (and noextr's literal
    record too), so that the tile-wide bound is finite and best shows in
    the output: (tab, planes)."""
    planes = hit_rays((rows, 128), np.random.default_rng(seed))
    return (torch.from_numpy(hit_rows(128)).to(device),
            torch.from_numpy(planes).to(device))


def _tri_hits(v, o, d, best):
    """Moller-Trumbore of K records v (K, 9) against every lane: (ok, t),
    each (K, rows, 128)."""
    col = lambda c: v[:, c].reshape(-1, 1, 1)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (col(c) for c in range(9))
    (ox, oy, oz), (dx, dy, dz) = o, d
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
    inv = torch.where(det != 0.0, 1.0 / det, 0.0)
    return ok, tq * inv


def _records(row, n):
    """The first n [v0 | e1 | e2] records of a 128-lane row: (n, 9)."""
    return row.reshape(8, 16)[:n, :9]


def leaf_probe_plain(mode: str, tab, planes, steps: int):
    """Plain PyTorch version of K7: tab (128, 128), planes (6, rows, 128)
    f32 -> (rows, 128) f32."""
    o, d = planes[:3].unbind(0), planes[3:].unbind(0)
    nrec = 2 if mode == "rec2" else 8
    dev = planes.device
    stack = (torch.arange(128, device=dev) * 7) % 120
    literal = torch.tensor(_LITERAL, dtype=torch.float32,
                           device=dev).expand(nrec, 9)
    best = torch.full_like(planes[0], 1e9)
    bound = torch.tensor(1e9, device=dev)

    def leaf_visit(best, bound, base):
        v = literal if mode == "noextr" else _records(tab[base], nrec)
        if mode == "nomath":
            col = lambda c: v[:, c].reshape(-1, 1, 1)
            tt = (o[0] * col(0) + o[1] * col(1) + o[2] * col(2)
                  + d[0] * col(3) + d[1] * col(4) + d[2] * col(5) + col(6))
            ok = tt > 0.5
        else:
            ok, tt = _tri_hits(v, o, d, best)
        gt = torch.full_like(best, math.inf)
        for k in range(nrec):
            gb = ok[k] & (tt[k] < gt)
            gt = torch.where(gb, tt[k], gt)
        nb = torch.where(gt < best, gt, best)
        return nb, (bound if mode == "nored" else nb.max())

    def slab_like(best, bound):  # fat / carry4's other branch, row 0
        nf = tab[0]
        m4 = []
        for c in range(4):
            lo, hi = nf[6 * c:6 * c + 3], nf[6 * c + 3:6 * c + 6]
            tn = torch.maximum(torch.maximum((lo[0] - o[0]) * d[0],
                                             (lo[1] - o[1]) * d[1]),
                               (lo[2] - o[2]) * d[2])
            tf = torch.minimum(torch.minimum((hi[0] - o[0]) * d[0],
                                             (hi[1] - o[1]) * d[1]),
                               (hi[2] - o[2]) * d[2])
            hit = (tn <= tf) & (tn < best)
            m4.append(torch.where(hit, tn, math.inf).min())
        return best, torch.minimum(bound, m4[0] + m4[1] + m4[2] + m4[3])

    for k in range(steps):
        if mode == "dep":  # a truncating cast of |bound|, as jnp.int32
            base = int(stack[(k + int(abs(bound.item())) % 7) % 128])
        else:
            base = int(stack[k % 128])
        if mode == "nocond":
            best, bound = leaf_visit(best, bound, base)
        elif mode in ("fat", "carry4"):
            # carry4's three planes from the pre-visit best are dropped
            # after the branches: they leave the output unchanged
            if bool(bound > -1e30):
                if base >= 120:
                    best, bound = slab_like(best, bound)
                else:
                    best, bound = leaf_visit(best, bound, base)
        elif bool(bound > -1e30) and base >= 0:
            best, bound = leaf_visit(best, bound, base)
    return best + bound


def leaf_probe(mode: str, tab, planes, steps: int):
    """K7 (csrc/probe_leaf.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    if planes.device.type == "cpu":
        return leaf_probe_plain(mode, tab, planes, steps)
    rows = planes.shape[1]
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if rows % 8 or not 0 < rows <= MAX_ROWS:
        raise ValueError(f"rows {rows}: a multiple of 8 up to {MAX_ROWS}")
    dev = planes.device
    cuda.check_tensors(dev, tab=(tab, torch.float32, (128, 128)),
                       planes=(planes, torch.float32, (6, rows, 128)))
    out = torch.empty((rows, 128), dtype=torch.float32, device=dev)
    cuda.launch(cuda.library().rtrt_probe_leaf, "probe_leaf", dev,
                ctypes.c_int(MODES.index(mode)), tab, planes, out,
                ctypes.c_int(rows), ctypes.c_int(steps))
    return out


def bound(mode: str, rows: int, steps: int):
    """(ms, "bytes" or "operations"): the least time of one launch on the
    one SM it occupies (tab and the 6 planes read once, out written)."""
    lanes = rows * 128
    return timing.bound_ms(128 * 128 * 4 + 7 * lanes * 4,
                           LANE_OPS[mode] * lanes * steps,
                           share=1 / timing.SMS)


def run(mode: str, rows: int, steps: int = 400, reps: int = 10,
        device="cuda"):
    """(ns per visit, floor ns per visit) of K7 in `mode` on the card (CUDA
    events), on the JAX tool's inputs."""
    tab, planes = tool_inputs(rows, device)
    sec, _ = timing.time_chained(
        lambda _: leaf_probe(mode, tab, planes, steps), reps)
    return sec / steps * 1e9, bound(mode, rows, steps)[0] / steps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=32)
    args = ap.parse_args(argv)
    card = timing.card()
    print(card)
    results = []
    for mode in ("full", "dep"):
        ns, floor = run(mode, args.rows)
        print(f"{mode:>7}: {ns:8.1f} ns/visit  floor {floor:8.1f} ns/visit "
              f"[{card}]", flush=True)
        results.append(dict(mode=mode, ns=ns, floor_ns=floor))
    return results


if __name__ == "__main__":
    main()
