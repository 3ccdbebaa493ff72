"""A record row's values to every lane, per-thread loads against one
coalesced load and warp shuffles: kernel K15 and its plain twin (port of
tools/probe_xpose.py).

Each step visits row stack[k % 128] of tab (stack[i] = (7 i) % 120): 8
Moller-Trumbore tests of the record [v0 | e1 | e2] at lanes 16 r .. 16 r + 8
against every ray of the (rows, 128) tile, without a tmin test, and best =
min(best, the nearest accepted t).  The TPU probe's xpose mode replaced 72
scalar extracts by a transpose and an outer product; on the H100
(csrc/probe_record.cu) the modes are
  extract  every thread loads each record itself, two 16-byte loads and
           one 4-byte load (24 uniform loads a step)
  xpose    each warp loads the row once, a float4 a lane, and broadcasts
           each value with __shfl_sync
and compute the same function: their outputs must be equal bit for bit.
No lane reads another, so a launch splits the tile over c plain blocks of
8 rows (`launch_geometry`: 4 at 32 rows), one an SM; the tool prints ns a
visit of the whole tile on its c SMs beside the floor of its operations on
those SMs.

Usage: python -m rtrt_tpu_torch.tools.probe_xpose [--rows 32] [--steps 300]
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..utils import cuda, timing
from .probe_cond import check_rows
from .probe_leaf import hit_rays, hit_rows, tool_inputs

MODES = ("extract", "xpose")
MAX_ROWS = 32  # the JAX tool's largest tile
BLOCK_ROWS = 8  # rows a block: a block's lanes on one SM
# float operations per lane per visit: 8 records of 58 (probe_leaf's 60 a
# record without the tmin test's product and compare) and the final min
LANE_OPS = 8 * 58 + 1


def hit_inputs(rows: int, device="cuda", seed: int = 0):
    """(tab, planes) on which every ray hits every record (probe_leaf's
    dyadic rays and rows): every product is exact, so any two float32
    implementations agree bit for bit."""
    planes = hit_rays((rows, 128), np.random.default_rng(seed))
    return (torch.from_numpy(hit_rows(128)).to(device),
            torch.from_numpy(planes).to(device))


def _visit(v, o, d, best):
    """The 8 tests of one row's records v (8, 9) against every lane, in the
    order of probe_xpose.py:55-78: the nearest accepted t per lane (inf if
    none)."""
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
    ok = (det != 0.0) & (uq * sg >= 0.0) & (vq * sg >= 0.0) \
        & ((uq + vq) * sg <= adet) & (tq * sg < best * adet)
    tt = tq * torch.where(det != 0.0, 1.0 / det, 0.0)
    gt = torch.full_like(best, float("inf"))
    for r in range(8):
        gt = torch.where(ok[r] & (tt[r] < gt), tt[r], gt)
    return gt


def xpose_probe_plain(mode: str, tab, planes, steps: int):
    """Plain PyTorch version of K15: tab (128, 128), planes (6, rows, 128)
    f32 -> (rows, 128) f32.  Both modes compute this function."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    o, d = planes[:3].unbind(0), planes[3:].unbind(0)
    stack = [(i * 7) % 120 for i in range(128)]
    best = torch.full_like(planes[0], 1e9)
    for k in range(steps):
        rec = tab[stack[k % 128]].reshape(8, 16)[:, :9]
        best = torch.minimum(best, _visit(rec, o, d, best))
    return best


def launch_geometry(rows: int):
    """(c, block rows) of K15's launch on a (rows, 128) tile: c = rows /
    BLOCK_ROWS blocks, one an SM, of BLOCK_ROWS rows each."""
    check_rows(rows, MAX_ROWS)
    return rows // BLOCK_ROWS, BLOCK_ROWS


def xpose_probe(mode: str, tab, planes, steps: int):
    """K15 (csrc/probe_record.cu) for CUDA tensors, the plain version for
    CPU tensors."""
    if planes.device.type == "cpu":
        return xpose_probe_plain(mode, tab, planes, steps)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    rows = planes.shape[1]
    blocks, block_rows = launch_geometry(rows)
    dev = planes.device
    cuda.check_tensors(dev, tab=(tab, torch.float32, (128, 128)),
                       planes=(planes, torch.float32, (6, rows, 128)))
    cuda.check_aligned(tab=tab)  # records read by float4
    out = torch.empty((rows, 128), dtype=torch.float32, device=dev)
    cuda.launch(cuda.library().rtrt_probe_xpose, "probe_xpose", dev,
                ctypes.c_int(MODES.index(mode)), tab, planes, out,
                ctypes.c_int(rows), ctypes.c_int(steps), ctypes.c_int(blocks),
                ctypes.c_int(block_rows))
    return out


def bound(rows: int, steps: int):
    """(ms, "bytes" or "operations"): the least time of one launch on the c
    SMs it fills (launch_geometry; tab and the 6 planes read once, out
    written)."""
    lanes = rows * 128
    return timing.bound_ms(128 * 128 * 4 + 7 * lanes * 4,
                           LANE_OPS * lanes * steps,
                           share=launch_geometry(rows)[0] / timing.SMS)


def run(mode: str, rows: int, steps: int, reps: int = 10, device="cuda"):
    """(ns per visit of the tile on its c SMs, floor ns per visit, output)
    of K15 in `mode` on the card (CUDA events), on the JAX tool's inputs."""
    tab, planes = tool_inputs(rows, device)
    sec, _ = timing.time_chained(
        lambda _: xpose_probe(mode, tab, planes, steps), reps)
    out = xpose_probe(mode, tab, planes, steps)
    return sec / steps * 1e9, bound(rows, steps)[0] / steps * 1e6, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    card = timing.card()
    c = launch_geometry(args.rows)[0]
    print(f"{card}; a {args.rows}x128 tile on {c} SMs, ns a visit of the "
          f"whole tile")
    results, outs = [], {}
    for mode in MODES:
        ns, floor, outs[mode] = run(mode, args.rows, args.steps)
        print(f"{mode:>8}: {ns:8.1f} ns/visit  floor {floor:8.1f} ns/visit "
              f"[{card}]", flush=True)
        results.append(dict(mode=mode, ns=ns, floor_ns=floor))
    same = torch.equal(outs["extract"], outs["xpose"])
    print("results match:", same)
    if not same:
        raise RuntimeError("K15: extract and xpose outputs differ")
    return results


if __name__ == "__main__":
    main()
