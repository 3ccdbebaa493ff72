"""The full traversal step: kernels K8 (one tile) and K9 (a grid of tiles)
and their plain twin (port of tools/probe_cores.py).

Every step pops an entry from a scalar stack shared by the (rows, 128) ray
tile, prunes it against the tile's bound, and visits a leaf (8
Moller-Trumbore record tests, running best and hit slot, tile-wide max) or
an internal node (4 slab tests, each child's tile-wide min, the
5-comparator sort, 3 predicated pushes, a drop count) of a synthetic tree
(csrc/probe_cores.cu).  K8 runs one tile on a thread-block cluster of c
blocks on c SMs (`launch_geometry`: c = 1 up to 16 rows, 2 up to 32); K9
runs 8 tiles, a cluster each, with (4608, 128) tables.  ns/step is the
latency of a step of a tile on its cluster's SMs; its floor is the float
operations of the visits this run made (LEAF_OPS, INT_OPS per lane) over
those SMs' share of the card's rate.

Usage: python -m rtrt_tpu_torch.tools.probe_cores [--rows 32]
"""

from __future__ import annotations

import argparse
import ctypes
import math

import numpy as np
import torch

from ..utils import cuda, timing
from .probe_leaf import _MT, _tri_hits, hit_rays, hit_rows
from .ubench_step import slab

MODES = ("both", "leafonly", "intonly", "depcond")
STACK = 256
MAX_ROWS = 32
# a block takes at most 16 rows: 4 lanes a thread, 32 threads a row, at most
# 512 threads, so a thread may hold 128 registers
MAX_BLOCK_ROWS = 16
NODE_ROWS, LEAF_ROWS = 512, 128  # rows an entry can address
# float operations per lane, counted from make_kernel: a leaf visit is 8
# records of a Moller-Trumbore test, the running-min compare and 2 selects,
# then the better compare, 2 selects and the tile-wide max; an internal
# visit is 4 children of a 25-operation slab test (6 selects, 6 sub, 6 mul,
# 4 min/max, 3 compares), the select and the tile-wide min.  The sort and
# the pushes are scalar work of the tile.
LEAF_OPS = 8 * (_MT + 3) + 4
INT_OPS = 4 * (25 + 2)


def tool_inputs(rows: int, tiles: int = 1, big_tables: bool = False,
                device="cuda", seed: int = 0):
    """The JAX tool's inputs, uniform in [-1, 1) from default_rng(seed):
    ntab (512 or 4608, 128), ttab (128 or 4608, 128), planes (6, tiles,
    rows, 128) = ox oy oz dx dy dz."""
    rng = np.random.default_rng(seed)
    nrows = 4608 if big_tables else NODE_ROWS
    trows = 4608 if big_tables else LEAF_ROWS
    ntab = rng.uniform(-1, 1, (nrows, 128))
    ttab = rng.uniform(-1, 1, (trows, 128))
    planes = np.stack([rng.uniform(-1, 1, (tiles, rows, 128))
                       for _ in range(6)])
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                 for x in (ntab, ttab, planes))


def box_rows(nrows: int) -> np.ndarray:
    """(nrows, 128) f32 internal-node rows: child c of row r is the box
    lo = (-8, -8, z), hi = (8, 8, z + 1 + c / 2), z = -3.5 + ((4 r + c) *
    29 % 53) / 16 (distinct within a row), and its entry (lane 24 + c) is
    (7 r + 131 c) % 512, a leaf (bit 1024) for odd c.  Every ray of
    hit_rays enters every box through its z face."""
    tab = np.zeros((nrows, 128), np.float32)
    c = np.arange(4)
    for r in range(nrows):
        z = -3.5 + ((4 * r + c) * 29 % 53) / 16
        box = np.stack([np.full(4, -8.0), np.full(4, -8.0), z,
                        np.full(4, 8.0), np.full(4, 8.0), z + 1 + c / 2], 1)
        tab[r, :24] = box.reshape(-1)
        tab[r, 24:28] = ((7 * r + 131 * c) % 512) | ((c % 2) << 10)
    return tab


def hit_inputs(rows: int, tiles: int = 1, big_tables: bool = False,
               device="cuda", seed: int = 0):
    """Inputs on which every lane hits every leaf record and every box
    (hit_rays, hit_rows, box_rows), so that the bound is finite and best,
    hit slot and drops show in the output: (ntab, ttab, planes)."""
    nrows = 4608 if big_tables else NODE_ROWS
    trows = 4608 if big_tables else LEAF_ROWS
    planes = hit_rays((tiles, rows, 128), np.random.default_rng(seed))
    return tuple(torch.from_numpy(x).to(device)
                 for x in (box_rows(nrows), hit_rows(trows), planes))


def _cswap(a, b):
    return (b, a) if a[0] > b[0] else (a, b)


def cores_probe_plain(mode: str, ntab, ttab, planes, steps: int):
    """Plain PyTorch version of K8: planes (6, rows, 128) f32 ->
    ((rows, 128) f32, (2,) i32 [leaf visits, internal visits])."""
    o, d = planes[:3].unbind(0), planes[3:].unbind(0)
    inv = tuple(1.0 / torch.where(x.abs() < 1e-20, 1e-20, x) for x in d)
    dev = planes.device
    i = torch.arange(STACK, dtype=torch.int32, device=dev)
    stack = ((i * 13) % 512) | ((i & 1) << 10)
    tstack = torch.full((STACK,), -1e30, device=dev)
    sp, bound, drops, n_leaf, n_int = 128, 1e9, 0, 0, 0
    best = torch.full_like(planes[0], 1e9)
    tri = torch.zeros(best.shape, dtype=torch.int32, device=dev)
    k = 0
    # bound and the stack's distances are float32 values held as Python
    # floats: comparing them compares the float32 values
    while k < steps and (mode != "depcond" or (sp > 0 and bound > -1e30)):
        ti = max(sp - 1, 0)
        cur, topt = int(stack[ti]), float(tstack[ti])
        sp = max(sp - 1, 0)
        if topt < bound:
            if mode == "leafonly" or (mode != "intonly" and cur & 1024):
                n_leaf += 1
                base = cur & 1023
                ok, tt = _tri_hits(ttab[base // 8].reshape(8, 16)[:, :9],
                                   o, d, best)
                gt = torch.full_like(best, math.inf)
                gi = torch.zeros_like(tri)
                for rec in range(8):
                    gb = ok[rec] & (tt[rec] < gt)
                    gt = torch.where(gb, tt[rec], gt)
                    gi = torch.where(gb, base + rec, gi)
                better = gt < best
                best = torch.where(better, gt, best)
                tri = torch.where(better, gi, tri)
                bound = best.max().item()
            else:
                n_int += 1
                nf = ntab[cur & 511]
                m4 = []
                for c in range(4):
                    h, tn = slab(nf[6 * c:6 * c + 6], o, inv, best)
                    m4.append(torch.where(h, tn, math.inf).min())
                # entries: a truncating float -> int32 cast, as astype
                p0, p1, p2, p3 = zip(torch.stack(m4).tolist(),
                                     nf[24:28].to(torch.int32).tolist())
                p0, p1 = _cswap(p0, p1)
                p2, p3 = _cswap(p2, p3)
                p0, p2 = _cswap(p0, p2)
                p1, p3 = _cswap(p1, p3)
                p1, p2 = _cswap(p1, p2)
                pushed = 0
                for j, (t, e) in enumerate((p3, p2, p1)):  # farthest first
                    if t < math.inf and sp + pushed < STACK:
                        stack[sp + pushed] = e
                        tstack[sp + pushed] = t
                        pushed += 1
                    elif j == 0 and t < math.inf:
                        drops += 1  # only the farthest child's drop counts
                sp += pushed
        sp = max(sp, 64)
        k += 1
    out = best + tri.to(torch.float32) + bound + float(drops)
    return out, torch.tensor([n_leaf, n_int], dtype=torch.int32, device=dev)


def cores_probe_grid_plain(mode: str, ntab, ttab, planes, steps: int):
    """Plain PyTorch version of K9: planes (6, tiles, rows, 128) ->
    ((tiles, rows, 128) f32, (tiles, 2) i32 visits); the tiles are
    independent (each refills its own stack)."""
    outs, visits = zip(*(cores_probe_plain(mode, ntab, ttab, planes[:, b],
                                           steps)
                         for b in range(planes.shape[1])))
    return torch.stack(outs), torch.stack(visits)


def launch_geometry(rows: int):
    """(c, block rows) of a K8 / K9 tile of (rows, 128): a cluster of c = 1
    block up to MAX_BLOCK_ROWS rows, else 2, each of rows / c rows."""
    if rows % 8 or not 0 < rows <= MAX_ROWS:
        raise ValueError(f"rows {rows}: a multiple of 8 up to {MAX_ROWS}")
    c = 1 if rows <= MAX_BLOCK_ROWS else 2
    return c, rows // c


def _launch(name, entry, mode, ntab, ttab, planes, tiles, steps):
    rows = planes.shape[-2]
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    cluster, _ = launch_geometry(rows)
    # an internal entry addresses ntab row entry & 511 and a leaf entry
    # ttab row (entry & 1023) // 8
    if ntab.shape[0] < NODE_ROWS or ttab.shape[0] < LEAF_ROWS:
        raise ValueError(f"tables of {ntab.shape[0]} and {ttab.shape[0]} "
                         f"rows: need >= {NODE_ROWS} and >= {LEAF_ROWS}")
    dev = planes.device
    cuda.check_tensors(dev, ntab=(ntab, torch.float32, (ntab.shape[0], 128)),
                       ttab=(ttab, torch.float32, (ttab.shape[0], 128)),
                       planes=(planes, torch.float32, planes.shape))
    out = torch.empty(planes.shape[1:], dtype=torch.float32, device=dev)
    visits = torch.empty(out.shape[:-2] + (2,), dtype=torch.int32,
                         device=dev)
    args = [ctypes.c_int(MODES.index(mode)), ntab, ttab, planes, out, visits,
            ctypes.c_int(rows), ctypes.c_int(cluster)]
    if tiles is not None:
        args.append(ctypes.c_int(tiles))
    cuda.launch(entry, name, dev, *args, ctypes.c_int(steps))
    return out, visits


def cores_probe(mode: str, ntab, ttab, planes, steps: int):
    """K8 (csrc/probe_cores.cu, one tile) for CUDA tensors, the plain
    version for CPU tensors: planes (6, rows, 128) -> (out, visits)."""
    if planes.device.type == "cpu":
        return cores_probe_plain(mode, ntab, ttab, planes, steps)
    if planes.dim() != 3 or planes.shape[0] != 6:
        raise ValueError(f"planes {tuple(planes.shape)}: need (6, rows, 128)")
    return _launch("probe_cores", cuda.library().rtrt_probe_cores, mode,
                   ntab, ttab, planes, None, steps)


def cores_probe_grid(mode: str, ntab, ttab, planes, steps: int):
    """K9 (csrc/probe_cores.cu, one block per tile) for CUDA tensors, the
    plain version for CPU tensors: planes (6, tiles, rows, 128) ->
    (out (tiles, rows, 128), visits (tiles, 2))."""
    if planes.device.type == "cpu":
        return cores_probe_grid_plain(mode, ntab, ttab, planes, steps)
    if planes.dim() != 4 or planes.shape[0] != 6:
        raise ValueError(f"planes {tuple(planes.shape)}: need (6, tiles, "
                         "rows, 128)")
    return _launch("probe_cores_grid", cuda.library().rtrt_probe_cores_grid,
                   mode, ntab, ttab, planes, planes.shape[1], steps)


def bound(ntab, ttab, planes, visits):
    """(ms, "bytes" or "operations"): the least time of one launch on the
    SMs its tiles' clusters fill (tables and planes read once, out written
    once; the visits this run made)."""
    tiles = planes.shape[1] if planes.dim() == 4 else 1
    lanes = planes.shape[-2] * 128
    c = launch_geometry(planes.shape[-2])[0]
    nbytes = (ntab.numel() + ttab.numel() + planes.numel()) * 4 \
        + tiles * lanes * 4
    v = visits.reshape(-1, 2).sum(0).tolist()
    return timing.bound_ms(nbytes, (v[0] * LEAF_OPS + v[1] * INT_OPS) * lanes,
                           share=tiles * c / timing.SMS)


def run(mode: str, rows: int, steps: int = 400, reps: int = 10,
        grid_tiles: int = 1, big_tables: bool = False, device="cuda"):
    """(ns per step, floor ns per step) of K8 (or K9 with grid_tiles > 1 or
    big tables) in `mode` on the card, CUDA events, on the JAX tool's
    inputs; a step of the grid is one tile's step (the JAX tool divides by
    steps x tiles), each tile on its cluster's SMs."""
    ntab, ttab, planes = tool_inputs(rows, grid_tiles, big_tables, device)
    if grid_tiles == 1 and not big_tables:
        planes = planes[:, 0].contiguous()
        fn = lambda _: cores_probe(mode, ntab, ttab, planes, steps)
    else:
        fn = lambda _: cores_probe_grid(mode, ntab, ttab, planes, steps)
    sec, _ = timing.time_chained(fn, reps)
    _, visits = fn(None)
    total = steps * grid_tiles
    return sec / total * 1e9, \
        bound(ntab, ttab, planes, visits)[0] / total * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=32)
    args = ap.parse_args(argv)
    card = timing.card()
    c = launch_geometry(args.rows)[0]
    print(f"{card}; a {args.rows}x128 tile on a cluster of {c} SMs, ns a "
          f"step of the tile")
    ns, floor = run("both", args.rows)
    print(f"  1-tile, small tables: {ns:8.1f} ns/step  floor {floor:8.1f} "
          f"ns/step [{card}]", flush=True)
    ns_g, floor_g = run("both", args.rows, steps=200, grid_tiles=8,
                        big_tables=True)
    print(f"  8-tile grid + 2.4MB tables (global memory, not staged): "
          f"{ns_g:8.1f} ns/step  floor {floor_g:8.1f} ns/step [{card}]",
          flush=True)
    return [dict(mode="both", ns=ns, floor_ns=floor),
            dict(mode="both, 8-tile grid", ns=ns_g, floor_ns=floor_g)]


if __name__ == "__main__":
    main()
