"""Live planes as a hidden per-step cost: kernel K13 and its plain twin
(port of tools/probe_pressure.py).

probe_cond's 72-value consume with n_inv loop-invariant planes inv[p] =
x * (1 + 0.01 p) folded into the terms: a = min(a * v0 + v1 * inv[(i / 3)
% n_inv], v2 + a), v1 * 0.5 when n_inv = 0; the output adds
sum(inv[:1]) = x when n_inv > 0.  The TPU probe asked whether the cost
grows with the tile's rows (its vector registers).  On the H100
(csrc/probe_consume.cu::pressure_kernel) the next step index depends on
element (0, 0) alone, so a launch splits the tile over c plain blocks
(`launch_geometry`: 4 of 16 rows at 64 rows, 1 of 8 at 8), one an SM,
each of which computes element (0, 0) itself in a shadow lane of its
warp 0; 4 lanes a thread hold the planes in registers without a spill
(ptxas' spills per instantiation: chip_smoke's build lines,
`tools/sass_loops.py`).  The tool prints ns a step of the whole tile on
its c SMs beside the floor of its operations on those SMs.

Usage: python -m rtrt_tpu_torch.tools.probe_pressure
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..utils import cuda, timing
from .probe_cond import consume_loop, row_values, tool_inputs

N_INV = (0, 6, 12, 20)
ROWS = (64, 8)  # the JAX tool's tiles
MAX_BLOCK_ROWS = 16  # rows a block: a block's lanes on one SM


def lane_ops(n_inv: int) -> int:
    """Float operations per lane per step: 24 terms of mul, add, add, min,
    and the plane product when n_inv > 0 (v1 * 0.5 is one scalar product
    a step)."""
    return 24 * (5 if n_inv else 4)


def factors(n_inv: int, device="cuda"):
    """(n_inv,) f32: 1 + 0.01 p rounded to float32, as jnp rounds the
    tool's Python constant."""
    return torch.tensor([1.0 + 0.01 * p for p in range(n_inv)],
                        dtype=torch.float32, device=device)


def pressure_probe_plain(n_inv: int, tab, x, steps: int):
    """Plain PyTorch version of K13: tab (128, 128), x (rows, 128) f32 ->
    (rows, 128) f32 (probe_pressure.py:30-49)."""
    if n_inv not in N_INV:
        raise ValueError(f"n_inv {n_inv} not in {N_INV}")
    fac = factors(n_inv, x.device)
    inv = [x * fac[p] for p in range(n_inv)]
    term = (lambda p: inv[p % n_inv]) if n_inv else (lambda p: 0.5)
    acc = consume_loop(x, steps, lambda b: row_values(tab, b), term)
    return acc + inv[0] if n_inv else acc


def launch_geometry(rows: int):
    """(c, block rows) of K13's launch on a (rows, 128) tile: c = rows /
    MAX_BLOCK_ROWS blocks (at least 1), one an SM, of rows / c rows each.
    Only the JAX tool's tiles, ROWS, are accepted."""
    if rows not in ROWS:
        raise ValueError(f"rows {rows}: one of {ROWS}")
    c = max(1, rows // MAX_BLOCK_ROWS)
    return c, rows // c


def pressure_probe(n_inv: int, tab, x, steps: int):
    """K13 (csrc/probe_consume.cu) for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return pressure_probe_plain(n_inv, tab, x, steps)
    if n_inv not in N_INV:
        raise ValueError(f"n_inv {n_inv} not in {N_INV}")
    rows = x.shape[0]
    blocks, block_rows = launch_geometry(rows)
    dev = x.device
    cuda.check_tensors(dev, tab=(tab, torch.float32, (128, 128)),
                       x=(x, torch.float32, (rows, 128)))
    cuda.check_aligned(tab=tab)  # records read by float4
    fac = factors(n_inv, dev) if n_inv else None
    out = torch.empty_like(x)
    cuda.launch(cuda.library().rtrt_probe_pressure, "probe_pressure", dev,
                ctypes.c_int(n_inv), tab, x, fac, out, ctypes.c_int(rows),
                ctypes.c_int(steps), ctypes.c_int(blocks),
                ctypes.c_int(block_rows))
    return out


def bound(rows: int, steps: int, lane_ops: int):
    """(ms, "bytes" or "operations"): the least time of one launch on the c
    SMs it fills (launch_geometry; tab and x read once, out written once)."""
    lanes = rows * 128
    return timing.bound_ms(128 * 128 * 4 + 2 * lanes * 4,
                           lane_ops * lanes * steps,
                           share=launch_geometry(rows)[0] / timing.SMS)


def run(n_inv: int, rows: int, steps: int = 400, reps: int = 10,
        device="cuda"):
    """(ns per step of the tile on its c SMs, floor ns per step) of K13 on
    the card (CUDA events), on the JAX tool's inputs."""
    tab, x = tool_inputs(rows, device)
    sec, _ = timing.time_chained(
        lambda _: pressure_probe(n_inv, tab, x, steps), reps)
    return sec / steps * 1e9, \
        bound(rows, steps, lane_ops(n_inv))[0] / steps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.card()
    print(f"{card}; ns a step of the whole tile on its c SMs")
    results = []
    for rows in ROWS:
        c = launch_geometry(rows)[0]
        for n_inv in N_INV:
            ns, floor = run(n_inv, rows)
            print(f"rows={rows:2d} invariant_planes={n_inv:2d}: {ns:8.1f} "
                  f"ns/step on {c} SMs  floor {floor:8.1f} ns [{card}]",
                  flush=True)
            results.append(dict(rows=rows, n_inv=n_inv, ns=ns,
                                floor_ns=floor))
    return results


if __name__ == "__main__":
    main()
