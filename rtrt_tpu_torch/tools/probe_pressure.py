"""Live planes as a hidden per-step cost: kernel K13 and its plain twin
(port of tools/probe_pressure.py).

probe_cond's 72-value consume with n_inv loop-invariant planes inv[p] =
x * (1 + 0.01 p) folded into the terms: a = min(a * v0 + v1 * inv[(i / 3)
% n_inv], v2 + a), v1 * 0.5 when n_inv = 0; the output adds
sum(inv[:1]) = x when n_inv > 0.  The TPU probe asked whether the cost
grows with the tile's rows (its vector registers); on the H100 one launch
is one 1,024-thread block (1 lane a thread at 8 rows, 8 at 64), and the
question is what n_inv x lanes live registers per thread cost once they
pass the 64-register cap: ptxas' spills per instantiation (chip_smoke's
build lines) say whether the planes stayed live.

Usage: python -m rtrt_tpu_torch.tools.probe_pressure
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..utils import cuda, timing
from .probe_cond import bound, consume_loop, row_values, tool_inputs

N_INV = (0, 6, 12, 20)
ROWS = (64, 8)  # the JAX tool's tiles: 8 lanes a thread, and 1


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


def pressure_probe(n_inv: int, tab, x, steps: int):
    """K13 (csrc/probe_consume.cu) for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return pressure_probe_plain(n_inv, tab, x, steps)
    if n_inv not in N_INV:
        raise ValueError(f"n_inv {n_inv} not in {N_INV}")
    rows = x.shape[0]
    if rows not in ROWS:
        raise ValueError(f"rows {rows}: one of {ROWS}")
    dev = x.device
    cuda.check_tensors(dev, tab=(tab, torch.float32, (128, 128)),
                       x=(x, torch.float32, (rows, 128)))
    fac = factors(n_inv, dev) if n_inv else None
    out = torch.empty_like(x)
    cuda.launch(cuda.library().rtrt_probe_pressure, "probe_pressure", dev,
                ctypes.c_int(n_inv), tab, x, fac, out, ctypes.c_int(rows),
                ctypes.c_int(steps))
    return out


def run(n_inv: int, rows: int, steps: int = 400, reps: int = 10,
        device="cuda"):
    """(ns per visit, floor ns per visit) of K13 on the card (CUDA events),
    on the JAX tool's inputs."""
    tab, x = tool_inputs(rows, device)
    sec, _ = timing.time_chained(
        lambda _: pressure_probe(n_inv, tab, x, steps), reps)
    return sec / steps * 1e9, \
        bound(rows, steps, lane_ops(n_inv))[0] / steps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.card()
    print(card)
    results = []
    for rows in ROWS:
        for n_inv in N_INV:
            ns, floor = run(n_inv, rows)
            print(f"rows={rows:2d} invariant_planes={n_inv:2d}: {ns:8.1f} "
                  f"ns/visit  floor {floor:8.1f} ns [{card}]", flush=True)
            results.append(dict(rows=rows, n_inv=n_inv, ns=ns,
                                floor_ns=floor))
    return results


if __name__ == "__main__":
    main()
