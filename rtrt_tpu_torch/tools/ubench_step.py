"""Traversal-step microbenchmark: kernel K6 and its plain twin (port of
tools/ubench_step.py).

Times stripped-down loops over one (rows, 128) ray tile that isolate the
parts of a traversal step (csrc/probe_step.cu lists the nine modes): the
loop, the record fetch, slab tests, tile-wide reductions, carried planes
and a branch.  Each launch runs the tile on one thread-block cluster of c
blocks on c SMs (`launch_geometry`: c = 1, 2, 4 for rows up to 16, 32,
64), so ns/step is the time of one step of the whole tile on its
cluster's c SMs, and each mode's floor is its float operations
(LANE_OPS) over those c SMs' share of the card's float32 rate.  A mode
under its floor would mean the compiler deleted the work.

Usage: python -m rtrt_tpu_torch.tools.ubench_step [--steps 4000]
       [--rows 64] [--reps 20]
"""

from __future__ import annotations

import argparse
import ctypes
import math

import numpy as np
import torch

from ..utils import cuda, timing

MODES = ("loop", "fetch", "slab", "extract2", "reduce2", "reduce4",
         "carry4", "carry12", "cond12")
MAX_ROWS = 64
# a block takes at most 16 rows: 4 lanes a thread, 32 threads a row, at most
# 512 threads, so a thread may hold 128 registers
MAX_BLOCK_ROWS = 16
CLUSTERS = (1, 2, 4)
# float operations per lane per step, counted from make_kernel: a slab test
# is 25 (6 selects, 6 sub, 6 mul, 4 min/max, 3 compares; the sign tests of
# the inverse direction are loop-invariant), a tile-wide min ~1 per lane
# plus the select that feeds it; selects and adds of the accumulator count
# one each
LANE_OPS = {"loop": 1, "fetch": 1, "slab": 54, "extract2": 56,
            "reduce2": 59, "reduce4": 118, "carry4": 58, "carry12": 74,
            "cond12": 74}


def tool_inputs(rows: int, device="cuda"):
    """The JAX tool's inputs: tab = arange(128 * 128) as (128, 128) f32,
    ox = linspace(0, 1) over the (rows, 128) tile."""
    tab = np.arange(128 * 128, dtype=np.float32).reshape(128, 128)
    ox = np.linspace(0, 1, rows * 128).reshape(rows, 128).astype(np.float32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(ox).to(device))


def slab(box, o, inv, best):
    """(hit, entry t) of every lane's ray (origin planes o, inverse
    direction planes inv) against the box [lo xyz | hi xyz] (6 values):
    the probes' slab test."""
    lo0, lo1, lo2, hi0, hi1, hi2 = box.unbind(0)
    (ox, oy, oz), (ix, iy, iz) = o, inv
    tn = torch.maximum(
        torch.maximum((torch.where(ix < 0, hi0, lo0) - ox) * ix,
                      (torch.where(iy < 0, hi1, lo1) - oy) * iy),
        (torch.where(iz < 0, hi2, lo2) - oz) * iz)
    tf = torch.minimum(
        torch.minimum((torch.where(ix < 0, lo0, hi0) - ox) * ix,
                      (torch.where(iy < 0, lo1, hi1) - oy) * iy),
        (torch.where(iz < 0, lo2, hi2) - oz) * iz)
    return (tn <= tf) & (tf > 1e-4) & (tn < best), tn


def step_probe_plain(mode: str, tab, ox, steps: int):
    """Plain PyTorch version of K6: tab (128, 128), ox (rows, 128) f32 ->
    (rows, 128) f32, the same function as tools/ubench_step.py's kernel."""
    oy = ox * 1.1
    oz = ox * 0.9
    o = (ox, oy, oz)
    inv = (1.0 / (ox + 2.0), 1.0 / (oy + 2.0), 1.0 / (oz + 2.0))
    inf = math.inf

    def fetch(i):  # nf[j] = tab[i // 8, (j + 16 (i % 8)) % 128], j < 15
        return torch.roll(tab[i // 8], -16 * (i % 8))[:15]

    if MODES.index(mode) <= MODES.index("reduce4"):
        acc = torch.zeros_like(ox)
        for k in range(steps):
            if mode == "loop":
                acc = acc + 1.0
                continue
            nf = fetch(k & 1023)
            if mode == "fetch":
                acc = acc + nf[0]
                continue
            hl, tl = slab(nf[0:6], o, inv, 1e9)
            hr, tr = slab(nf[6:12], o, inv, 1e9)
            live = torch.where(hl, tl, 0.0) + torch.where(hr, tr, 0.0)
            if mode == "slab":
                acc = acc + live
                continue
            if mode == "extract2":
                acc = acc + live + nf[0] + nf[6]
                continue
            minl = torch.where(hl, tl, inf).min()
            minr = torch.where(hr, tr, inf).min()
            w1 = torch.where(minl < minr, 1.0, 2.0)
            if mode == "reduce2":
                acc = acc + live + w1
                continue
            hl2, tl2 = slab(nf[3:9], o, inv, 1e9)
            hr2, tr2 = slab(nf[9:15], o, inv, 1e9)
            live = live + torch.where(hl2, tl2, 0.0) \
                + torch.where(hr2, tr2, 0.0)
            m3 = torch.where(hl2, tl2, inf).min()
            m4 = torch.where(hr2, tr2, inf).min()
            acc = acc + live + w1 + torch.where(m3 < m4, 1.0, 2.0)
        return ox + acc

    n_carry = 4 if mode == "carry4" else 12
    best = torch.full_like(ox, 1e9)
    rest = [torch.zeros_like(ox) + float(i) for i in range(n_carry - 1)]
    for k in range(steps):
        nf = fetch(k & 1023)
        hl, tl = slab(nf[0:6], o, inv, 1e9)
        hr, tr = slab(nf[6:12], o, inv, 1e9)
        nb = torch.where(hl, torch.minimum(best, tl), best)
        nr = [torch.where(hr, r + tr, r) for r in rest]
        if mode == "cond12":  # the branch on nf[0] < 1e30, as a select
            go = nf[0] < 1e30
            nb = torch.where(go, nb, best)
            nr = [torch.where(go, a, b) for a, b in zip(nr, rest)]
        best, rest = nb, nr
    return best + rest[0]


def launch_geometry(rows: int):
    """(c, block rows) of K6's launch on a (rows, 128) tile: the smallest
    cluster size c in CLUSTERS with rows <= MAX_BLOCK_ROWS * c, each of its
    c blocks taking rows / c rows."""
    if rows % 8 or not 0 < rows <= MAX_ROWS:
        raise ValueError(f"rows {rows}: a multiple of 8 up to {MAX_ROWS}")
    c = next(c for c in CLUSTERS if rows <= MAX_BLOCK_ROWS * c)
    return c, rows // c


def step_probe(mode: str, tab, ox, steps: int):
    """K6 (csrc/probe_step.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    if ox.device.type == "cpu":
        return step_probe_plain(mode, tab, ox, steps)
    rows = ox.shape[0]
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    cluster, _ = launch_geometry(rows)
    dev = ox.device
    cuda.check_tensors(dev, tab=(tab, torch.float32, (128, 128)),
                       ox=(ox, torch.float32, (rows, 128)))
    out = torch.empty_like(ox)
    # the carry modes' other planes land here, so that they stay live
    state = torch.empty((10, rows, 128), dtype=torch.float32, device=dev) \
        if mode.startswith(("carry", "cond")) else None
    cuda.launch(cuda.library().rtrt_probe_step, "probe_step", dev,
                ctypes.c_int(MODES.index(mode)), tab, ox, out, state,
                ctypes.c_int(rows), ctypes.c_int(cluster),
                ctypes.c_int(steps))
    return out


def bound(mode: str, rows: int, steps: int):
    """(ms, "bytes" or "operations"): the least time of one launch on the
    c SMs of its cluster (tab and ox read once, out written once)."""
    lanes = rows * 128
    return timing.bound_ms(128 * 128 * 4 + 2 * lanes * 4,
                           LANE_OPS[mode] * lanes * steps,
                           share=launch_geometry(rows)[0] / timing.SMS)


def run(mode: str, rows: int, steps: int = 4000, reps: int = 20,
        device="cuda"):
    """(ns per step, floor ns per step) of K6 in `mode` on the card (CUDA
    events), on the JAX tool's inputs."""
    tab, ox = tool_inputs(rows, device)
    sec, _ = timing.time_chained(
        lambda _: step_probe(mode, tab, ox, steps), reps)
    return sec / steps * 1e9, bound(mode, rows, steps)[0] / steps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    card = timing.card()
    print(card)
    c, block_rows = launch_geometry(args.rows)
    print(f"rows={args.rows} steps={args.steps} reps={args.reps}: ns/step "
          f"is a step of the tile on its cluster of {c} block(s) of "
          f"{block_rows} rows, {c} SM(s)")
    base = None
    results = []
    for mode in MODES:
        ns, floor = run(mode, args.rows, args.steps, args.reps)
        d = "" if base is None else f"  (+{ns - base:6.1f} vs loop)"
        if mode == "loop":
            base = ns
        print(f"{mode:<10} {ns:8.1f} ns/step{d}  floor {floor:8.1f} ns/step "
              f"[{card}]", flush=True)
        results.append(dict(mode=mode, ns=ns, floor_ns=floor))
    return results


if __name__ == "__main__":
    main()
