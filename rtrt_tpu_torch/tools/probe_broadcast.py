"""Record layout, AoS against SoA: kernel K14 and its plain twin (port of
tools/probe_broadcast.py).

Each step takes the tile-wide int32 min of pend (cand), reads the 13
values of record cand & 1023, adds them into 13 carried planes on the
lanes where pend == cand, and retires those lanes (pend = 2^30): the
resolve loop's structure, each step depending on the previous one.  The
modes are the two layouts of a record (csrc/probe_record.cu):
  extract  AoS: value v of record i at tab.flat[16 i + v]
  bcast16  SoA: value v at ttab[(i // 128) * 16 + v, i % 128]
out = sum of the 13 planes + float(pend).  One launch is one thread-block
cluster of c blocks, one an SM (`launch_geometry`: c = 1, 2, 4 for rows
up to 16, 32, 64), whose tile-wide min overlaps each step's adds; the
tool prints ns per step of the tile on those c SMs at two step counts as
a linearity check, beside the floor of its operations on them.

Usage: python -m rtrt_tpu_torch.tools.probe_broadcast [--steps 400]
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..utils import cuda, timing
# K6's launch rule: a cluster of c = 1, 2, 4 blocks of at most
# ubench_step.MAX_BLOCK_ROWS rows (csrc/probe_record.cu:
# BCAST_MAX_BLOCK_ROWS)
from .ubench_step import launch_geometry

MODES = ("extract", "bcast16")
SHAPE = (64, 128)
NVAL = 13
PEND_DONE = 2 ** 30
# operations per lane per step: the compare, 13 adds and 13 selects, the
# pend select, and the lane's share of the tile-wide min (~1)
LANE_OPS = 1 + 2 * NVAL + 1 + 1


def tool_inputs(device="cuda", scale: float = 1.0, rows: int = SHAPE[0],
                modulus: int = 1024):
    """The JAX tool's inputs, times `scale`: tab = arange(128 * 128) % 7 and
    ttab = arange(16 * 8 * 128) % 7, both (128, 128) f32; pend =
    arange(rows * 128) % modulus, (rows, 128) int32 (the tool's: 64 rows,
    modulus 1024).  At scale 1 a retired lane's output is sum + 2^30, whose
    float32 spacing (128) hides the sum."""
    a = (np.arange(128 * 128, dtype=np.float32) % np.float32(7.0)) \
        .reshape(128, 128) * np.float32(scale)
    pend = (np.arange(rows * SHAPE[1], dtype=np.int32) % modulus) \
        .reshape(rows, SHAPE[1])
    return (torch.from_numpy(a).to(device), torch.from_numpy(a.copy())
            .to(device), torch.from_numpy(pend).to(device))


def scaled_inputs(device="cuda", rows: int = SHAPE[0]):
    """tool_inputs with the tables times 1024: every sum is a multiple of
    1024, exact and visible above 2^30."""
    return tool_inputs(device, 1024.0, rows)


def saturating_inputs(device="cuda", rows: int = SHAPE[0]):
    """scaled_inputs with pend = arange % 32: every lane has retired by
    step 32; from then on cand = 2^30 (record 0) and every lane, its pend
    equal to cand, adds record 0 each step."""
    return tool_inputs(device, 1024.0, rows, 32)


RECIPES = {"tool": tool_inputs, "scaled": scaled_inputs,
           "saturating": saturating_inputs}


def broadcast_probe_plain(mode: str, tab, ttab, pend, steps: int):
    """Plain PyTorch version of K14: tab, ttab (128, 128) f32, pend (rows,
    128) int32 -> (rows, 128) f32 (probe_broadcast.py:39-75)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    v = torch.arange(NVAL, device=pend.device)
    flat = tab.reshape(-1)
    acc = [torch.zeros(pend.shape, device=pend.device)] * NVAL
    for _ in range(steps):
        cand = pend.min()
        i = cand & 1023
        vals = flat[16 * i + v] if mode == "extract" \
            else ttab[(i // 128) * 16 + v, i % 128]
        m = pend == cand
        acc = [torch.where(m, a + vals[n], a) for n, a in enumerate(acc)]
        pend = torch.where(m, PEND_DONE, pend)
    out = acc[0]
    for a in acc[1:]:
        out = out + a
    return out + pend.to(torch.float32)


def broadcast_probe(mode: str, tab, ttab, pend, steps: int):
    """K14 (csrc/probe_record.cu) for CUDA tensors, the plain version for
    CPU tensors.  tab must be 16-byte aligned (its records are read by
    float4)."""
    if pend.device.type == "cpu":
        return broadcast_probe_plain(mode, tab, ttab, pend, steps)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    rows = pend.shape[0]
    cluster, _ = launch_geometry(rows)
    dev = pend.device
    cuda.check_tensors(dev, tab=(tab, torch.float32, (128, 128)),
                       ttab=(ttab, torch.float32, (128, 128)),
                       pend=(pend, torch.int32, (rows, 128)))
    cuda.check_aligned(tab=tab)
    out = torch.empty(pend.shape, dtype=torch.float32, device=dev)
    cuda.launch(cuda.library().rtrt_probe_broadcast, "probe_broadcast", dev,
                ctypes.c_int(MODES.index(mode)), tab, ttab, pend, out,
                ctypes.c_int(rows), ctypes.c_int(cluster),
                ctypes.c_int(steps))
    return out


def bound(rows: int, steps: int):
    """(ms, "bytes" or "operations"): the least time of one launch on the
    c SMs of its cluster (tab, ttab and pend read once, out written
    once)."""
    lanes = rows * 128
    return timing.bound_ms(2 * 128 * 128 * 4 + 2 * lanes * 4,
                           LANE_OPS * lanes * steps,
                           share=launch_geometry(rows)[0] / timing.SMS)


def run(mode: str, steps: int, reps: int = 10, device="cuda"):
    """(ns per step of the tile on its c SMs, floor ns per step) of K14 on
    the card (CUDA events), on the JAX tool's inputs."""
    tab, ttab, pend = tool_inputs(device)
    sec, _ = timing.time_chained(
        lambda _: broadcast_probe(mode, tab, ttab, pend, steps), reps)
    return sec / steps * 1e9, bound(SHAPE[0], steps)[0] / steps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    card = timing.card()
    print(card)
    results = []
    for mode in MODES:
        n1, floor = run(mode, args.steps)
        n2, _ = run(mode, args.steps * 2)
        print(f"{mode:<8} {n1:8.1f} ns/iter  (x2 steps: {n2:8.1f} — "
              f"linear={abs(n2 - n1) < 0.3 * max(n1, 1)})  floor "
              f"{floor:8.1f} ns [{card}]", flush=True)
        results.append(dict(mode=mode, ns=n1, ns_x2=n2, floor_ns=floor))
    return results


if __name__ == "__main__":
    main()
