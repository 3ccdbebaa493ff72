"""72-value consume under 0, 1 or 2 data-dependent branches: kernel K10 and
its plain twin (port of tools/probe_cond.py).

Each step of the loop reads 72 values (8 records of 9) of one row of a
(128, 128) table and folds them into the (rows, 128) tile in 24 terms
a = min(a * v0 + v1, v2 + a); the next step index depends on the tile's
acc[0, 0].  The TPU probe asked whether a data-dependent branch around the
consume serialises its loads.  On the H100 each mode is a template
instantiation of one kernel (csrc/probe_consume.cu::free_consume_kernel):
flat, the consume under one branch (cond) and under two nested ones
(cond2).  The branches' tests (k & 1023) >= 0 and (k & 511) >= 0 are
always true; their masks and threshold reach the kernel as arguments, so
the compiler keeps them.  The next step index depends on element (0, 0)
alone, so a launch splits the tile over c plain blocks
(`launch_geometry`: 4 of 16 rows at 64 rows, 1 at 8), one an SM, and
every thread steps element (0, 0) itself as one more lane: no flag
crosses a warp and the step loop has no barrier.  The tool prints ns a
visit of the whole tile on its c SMs beside the floor of its float
operations on those SMs.

The plain consume loop here (`consume_loop`, `row_values`) also serves
probe_smem (K12) and probe_pressure (K13).

Usage: python -m rtrt_tpu_torch.tools.probe_cond
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..utils import cuda, timing

MODES = ("flat", "cond", "cond2")
SHAPE = (64, 128)
MAX_ROWS = 64
MAX_BLOCK_ROWS = 16  # rows a block: a block's lanes on one SM
# the branches' always-true tests (k & mask) >= thresh, passed at run time
COND_MASKS = (1023, 511)
COND_THRESH = 0
# float operations per lane per step: 24 terms of mul, add, add, min
LANE_OPS = 24 * 4
# lanes 16 r + v, r < 8, v < 9: the 72 values a step consumes
OFFSETS = tuple(16 * r + v for r in range(8) for v in range(9))


def consume_table(device="cuda"):
    """The tools' table: (arange(128 * 128) % 3) * 1e-3 + 0.5, (128, 128)
    f32 (the products are exact, so XLA's FMA gives the same values)."""
    tab = (np.arange(128 * 128, dtype=np.float32) % np.float32(3.0)) \
        .reshape(128, 128) * np.float32(1e-3) + np.float32(0.5)
    return torch.from_numpy(tab).to(device)


def tool_inputs(rows: int = SHAPE[0], device="cuda"):
    """The JAX tool's inputs: (tab, x = 0.5 everywhere).  x converges to one
    value on every lane within a step: it hides all but the consume's fixed
    point."""
    return consume_table(device), torch.full((rows, 128), 0.5,
                                             device=device)


def uniform_inputs(rows: int = SHAPE[0], device="cuda", seed: int = 0):
    """(tab, x uniform in [0, 1) from default_rng(seed)).  Each term halves
    a lane's distance to the fixed point, so these lanes too agree to the
    last bit after one step."""
    x = np.random.default_rng(seed).uniform(0, 1, (rows, 128))
    return consume_table(device), torch.from_numpy(
        x.astype(np.float32)).to(device)


def spread_inputs(rows: int = SHAPE[0], device="cuda", seed: int = 0):
    """(tab, x uniform in [-400, 0) from default_rng(seed), x[0, 0] = inf).
    Below 0 the min takes v2 + a, ~12 a step, so the lanes stay apart for
    ~30 steps; acc[0, 0] stays inf, so every step advances k by 2 (the
    data-dependent increment)."""
    x = np.random.default_rng(seed).uniform(-400, 0, (rows, 128))
    x[0, 0] = np.inf
    return consume_table(device), torch.from_numpy(
        x.astype(np.float32)).to(device)


def flip_inputs(rows: int = SHAPE[0], device="cuda", seed: int = 0):
    """(tab, x uniform in [0, 1) from default_rng(seed), x[0, 0] = 3e38).
    Without planes a step's 24 terms take acc[0, 0] to ~1.8e31 and then
    below 1e30: the step flag is true after the first step and false after
    every later one, so a kernel that reads or times element (0, 0)'s flag
    wrongly takes another k sequence.  With K13's planes (v1 * inv ~ 1.5e38
    a term) acc[0, 0] stays near 3e38 and the flag stays true."""
    x = np.random.default_rng(seed).uniform(0, 1, (rows, 128))
    x[0, 0] = 3e38
    return consume_table(device), torch.from_numpy(
        x.astype(np.float32)).to(device)


RECIPES = {"tool": tool_inputs, "uniform": uniform_inputs,
           "spread": spread_inputs, "flip": flip_inputs}


def row_values(tab, base: int):
    """The 72 values of a step at base = (7 k) % 997: row base // 8 at
    16 r + v (probe_cond.py:37-42), a (72,) tensor."""
    idx = torch.tensor(OFFSETS, device=tab.device)
    return tab[base // 8, idx]


def consume_loop(x, steps: int, values, term=None, gate=None):
    """The consume loop of probe_cond / probe_smem / probe_pressure: acc = x;
    while k < steps: if gate(k), fold values(base) into acc in 24 terms
    a = min(a * v0 + t, v2 + a), t = v1 or v1 * term(p) for term p; then
    k += 1 + (acc[0, 0] > 1e30).  Products and sums in the JAX order."""
    acc = x
    k = 0
    while k < steps:
        if gate is None or gate(k):
            v = values((k * 7) % 997).unbind(0)
            for p in range(24):
                v0, v1, v2 = v[3 * p:3 * p + 3]
                t = v1 if term is None else v1 * term(p)
                acc = torch.minimum(acc * v0 + t, v2 + acc)
        k += 1 + int(acc[0, 0] > 1e30)
    return acc


def _gate(mode: str):
    m1, m2 = COND_MASKS
    if mode == "flat":
        return None
    if mode == "cond":
        return lambda k: (k & m1) >= COND_THRESH
    return lambda k: (k & m1) >= COND_THRESH and (k & m2) >= COND_THRESH


def cond_probe_plain(mode: str, tab, x, steps: int):
    """Plain PyTorch version of K10: tab (128, 128), x (rows, 128) f32 ->
    (rows, 128) f32.  The three modes compute the same function."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return consume_loop(x, steps, lambda b: row_values(tab, b),
                        gate=_gate(mode))


def check_rows(rows: int, max_rows: int = MAX_ROWS):
    if rows % 8 or not 0 < rows <= max_rows:
        raise ValueError(f"rows {rows}: a multiple of 8 up to {max_rows}")


def launch_geometry(rows: int):
    """(c, block rows) of K10's, K12's and K16's launch on a (rows, 128)
    tile: c = ceil(rows / MAX_BLOCK_ROWS) blocks, one an SM, of ceil(rows
    / c) rows each (the last block masks the lanes past the tile)."""
    check_rows(rows)
    c = -(-rows // MAX_BLOCK_ROWS)
    return c, -(-rows // c)


def check_consume_inputs(device, tab, x):
    """What K10 and K12 take: tab (128, 128) and x (rows, 128) float32,
    contiguous, on `device`, tab 16-byte aligned (its records are read by
    float4 and K12 stages it by bulk copies).  Raises ValueError."""
    cuda.check_tensors(device, tab=(tab, torch.float32, (128, 128)),
                       x=(x, torch.float32, (x.shape[0], 128)))
    cuda.check_aligned(tab=tab)


def cond_probe(mode: str, tab, x, steps: int):
    """K10 (csrc/probe_consume.cu) for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return cond_probe_plain(mode, tab, x, steps)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    rows = x.shape[0]
    blocks, block_rows = launch_geometry(rows)
    dev = x.device
    check_consume_inputs(dev, tab, x)
    out = torch.empty_like(x)
    cuda.launch(cuda.library().rtrt_probe_cond, "probe_cond", dev,
                ctypes.c_int(MODES.index(mode)), tab, x, out,
                ctypes.c_int(rows), ctypes.c_int(steps),
                ctypes.c_int(COND_MASKS[0]), ctypes.c_int(COND_MASKS[1]),
                ctypes.c_int(COND_THRESH), ctypes.c_int(blocks),
                ctypes.c_int(block_rows))
    return out


def bound(rows: int, steps: int, lane_ops: int = LANE_OPS):
    """(ms, "bytes" or "operations"): the least time of one launch of K10
    or K12 on the c SMs it fills (launch_geometry; tab and x read once, out
    written once; the function's operations, not the shadow's)."""
    lanes = rows * 128
    return timing.bound_ms(128 * 128 * 4 + 2 * lanes * 4,
                           lane_ops * lanes * steps,
                           share=launch_geometry(rows)[0] / timing.SMS)


def run(mode: str, steps: int = 400, reps: int = 10, device="cuda"):
    """(ns per visit of the tile on its c SMs, floor ns per visit) of K10
    in `mode` on the card (CUDA events), on the JAX tool's inputs."""
    tab, x = tool_inputs(SHAPE[0], device)
    sec, _ = timing.time_chained(
        lambda _: cond_probe(mode, tab, x, steps), reps)
    return sec / steps * 1e9, bound(SHAPE[0], steps)[0] / steps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.card()
    c = launch_geometry(SHAPE[0])[0]
    print(f"{card}; a {SHAPE[0]}x128 tile on {c} SMs, ns a visit of the "
          f"whole tile")
    results = []
    for mode in MODES:
        ns, floor = run(mode)
        print(f"{mode:>6}: {ns:8.1f} ns per 72-extract visit  floor "
              f"{floor:8.1f} ns [{card}]", flush=True)
        results.append(dict(mode=mode, ns=ns, floor_ns=floor))
    return results


if __name__ == "__main__":
    main()
