"""Vector math in bf16 against float32: kernel K16 and its plain twin (port
of tools/probe_bf16.py).

Eight independent serial chains per lane over a (64, 128) tile, c_i = x +
i, each step c = min(max(c * one + 0.5 - c * 0.5, -3), 3) with one =
1.0000001 in the working type (1.0 in bf16); out = the chains' sum, as
float32.  The TPU probe asked whether bf16 (half the registers a plane)
doubles the rate of the traversal's plane math.  On the H100
(csrc/probe_bf16.cu) the bf16 mode runs the chains on packed bf16x2 pairs,
at twice the float32 rate on paper.  No lane reads another, so a launch
splits the tile over c blocks on c SMs (`launch_geometry`: c = 4 at 64
rows), the same c and 2 lanes a thread in both modes.  The tool prints ns
a step of the whole tile on its c SMs, at two step counts as a linearity
check, beside the floor of a step: the 48 operations a lane at the type's
rate on those c SMs.

Usage: python -m rtrt_tpu_torch.tools.probe_bf16
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..utils import cuda, timing
from .probe_cond import MAX_BLOCK_ROWS, launch_geometry  # K10's launch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SHAPE = (64, 128)
CHAINS = 8
OPS_PER_STEP = 6  # per chain: 2 mul, 1 add, 1 sub, 1 max, 1 min
LANE_OPS = CHAINS * OPS_PER_STEP
ONE = 1.0000001


def tool_inputs(rows: int = SHAPE[0], device="cuda"):
    """The JAX tool's input: x = linspace(0, 1) over the (rows, 128) tile.
    Its chains contract toward 1: after ~40 steps every lane sums to 8."""
    x = np.linspace(0, 1, rows * 128).reshape(rows, 128).astype(np.float32)
    return torch.from_numpy(x).to(device)


def uniform_inputs(rows: int = SHAPE[0], device="cuda", seed: int = 0):
    """x uniform in [-8, 8) from default_rng(seed): the clamps engage and,
    within a few steps, the chains have not converged."""
    x = np.random.default_rng(seed).uniform(-8, 8, (rows, 128))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def bf16_probe_plain(dtype: str, x, steps: int):
    """Plain PyTorch version of K16: x (rows, 128) f32 -> (rows, 128) f32,
    every operation in the working type (torch rounds each bf16 operation
    to bf16), in the order of probe_bf16.py:34-57."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {tuple(DTYPES)}")
    dt = DTYPES[dtype]
    const = lambda v: torch.tensor(v, dtype=dt, device=x.device)
    one, half, cap, floor = const(ONE), const(0.5), const(3.0), const(-3.0)
    xd = x.to(dt)
    ch = [xd + const(float(i)) for i in range(CHAINS)]
    for _ in range(steps):
        ch = [torch.minimum(torch.maximum(c * one + half - c * half, floor),
                            cap) for c in ch]
    acc = ch[0]
    for c in ch[1:]:
        acc = acc + c
    return acc.to(torch.float32)


def bf16_probe(dtype: str, x, steps: int):
    """K16 (csrc/probe_bf16.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return bf16_probe_plain(dtype, x, steps)
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {tuple(DTYPES)}")
    rows = x.shape[0]
    blocks, block_rows = launch_geometry(rows)
    dev = x.device
    cuda.check_tensors(dev, x=(x, torch.float32, (rows, 128)))
    out = torch.empty_like(x)
    cuda.launch(cuda.library().rtrt_probe_bf16, "probe_bf16", dev,
                ctypes.c_int(dtype == "bf16"), x, out, ctypes.c_float(ONE),
                ctypes.c_int(rows), ctypes.c_int(steps),
                ctypes.c_int(blocks), ctypes.c_int(block_rows))
    return out


def bound(dtype: str, rows: int, steps: int):
    """(ms, "bytes" or "operations"): the least time of one launch on the c
    SMs it fills (launch_geometry; x read once, out written once), the
    operations at the float32 or the bf16 rate."""
    lanes = rows * 128
    rate = timing.BF16_OPS if dtype == "bf16" else timing.F32_OPS
    return timing.bound_ms(2 * lanes * 4, LANE_OPS * lanes * steps,
                           share=launch_geometry(rows)[0] / timing.SMS,
                           rate=rate)


def run(dtype: str, steps: int, reps: int = 30, device="cuda"):
    """(ns per step of the tile on its c SMs, floor ns per step) of K16 on
    the card (CUDA events), on the JAX tool's input."""
    x = tool_inputs(SHAPE[0], device)
    sec, _ = timing.time_chained(
        lambda _: bf16_probe(dtype, x, steps), reps)
    return sec / steps * 1e9, bound(dtype, SHAPE[0], steps)[0] / steps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.card()
    c = launch_geometry(SHAPE[0])[0]
    print(f"{card}; a {SHAPE[0]}x128 tile on {c} SMs, ns a step of the "
          f"whole tile")
    results = []
    for name in DTYPES:
        n1, floor = run(name, 4000)
        n2, _ = run(name, 8000)
        print(f"{name:>5}: {n1:7.1f} ns/step ({LANE_OPS} plane-ops, "
              f"{c} SMs) -> "
              f"{n1 / LANE_OPS:6.2f} ns/plane-op  (x2 steps {n2:7.1f}, "
              f"linear={abs(n2 - n1) < 0.25 * n1})  floor {floor:7.1f} "
              f"ns/step [{card}]", flush=True)
        results.append(dict(dtype=name, ns=n1, ns_x2=n2, floor_ns=floor))
    return results


if __name__ == "__main__":
    main()
