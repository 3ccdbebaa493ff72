"""Shared-memory capacity and staged-table loads: kernels K11 and K12 and
their plain twins (port of tools/probe_smem.py).

K11 (`smem_alloc`): out = x + s[0] + s[n - 1] through a dynamic
shared-memory buffer of n floats written at 0 and n - 1.  The TPU probe
asked how large an SMEM scratch Mosaic accepts (0.25-4 MiB); on the H100
the question is the dynamic shared memory one block may request: 48 KB
without an opt-in, the card's opt-in maximum with one.  A refusal is a
result, and comes only from the CUDA runtime's own refusal
(cudaErrorInvalidValue); every other error raises.  One launch is a grid
of rows / 8 blocks (`alloc_blocks`: 8 at 64 rows), each asking for the
buffer (the runtime grants it a block, so the edge is a block's), 256
threads a block, a float4 a thread; x must be 16-byte aligned.  Its time
is the launch's own: `run_alloc` gives CUDA events around chained calls
(the wrapper's host work included) and graph replay (the kernel alone).

K12 (`smem_consume`): probe_cond's 72-value consume loop (K10's flat
mode) with the values from
  extract  row base // 8 of the table in global memory (K10's function);
  smem     the table staged once into 64 KiB of dynamic shared memory,
           value c at flat index (base + 16 r + v) % 8000 — another
           function than extract, as in the TPU probe.
K10's kernel (csrc/probe_consume.cu::free_consume_kernel) and its launch:
the tile over probe_cond.launch_geometry(rows)'s c SMs, element (0, 0)
stepped by every thread, no barrier in the step loop; the smem
instantiation stages the table by bulk copies (one barrier) and reads it
without the modulo, which never wraps (base + 16 r + v <= 1116).

Usage: python -m rtrt_tpu_torch.tools.probe_smem
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..utils import cuda, timing
from .probe_cond import (LANE_OPS, OFFSETS, SHAPE, bound,
                         check_consume_inputs, check_rows, consume_loop,
                         launch_geometry, row_values, tool_inputs)

MODES = ("extract", "smem")
SIZES_MIB = (0.25, 0.5, 1.0, 2.0, 4.0)  # the JAX tool's scratch sizes
SMEM_DEFAULT = 48 * 1024  # bytes a block gets without the opt-in
REFUSED = -1  # csrc/probe_consume.cu: RTRT_SMEM_REFUSED
ALLOC_BLOCK_ROWS = 8  # csrc/probe_consume.cu: rows a K11 block


def smem_alloc_plain(x, n_floats: int):
    """Plain PyTorch version of K11: x (rows, 128) f32 -> x + s[0] +
    s[n - 1] with s[0] = x[0, 0], then s[n - 1] = x[0, 1]."""
    if n_floats < 1:
        raise ValueError(f"n_floats {n_floats}: at least 1")
    s = {0: x[0, 0]}
    s[n_floats - 1] = x[0, 1]
    return x + s[0] + s[n_floats - 1]


def alloc_blocks(rows: int) -> int:
    """Blocks of K11's launch on a (rows, 128) x: rows / ALLOC_BLOCK_ROWS
    (rows a multiple of 8 up to 64, else ValueError)."""
    check_rows(rows)
    return rows // ALLOC_BLOCK_ROWS


def smem_alloc(x, n_floats: int):
    """K11 for a CUDA tensor: the output, or None when the runtime refused
    n_floats * 4 bytes of dynamic shared memory for a block.  x must be
    16-byte aligned (it is read by float4).  The plain version for a CPU
    tensor."""
    if x.device.type == "cpu":
        return smem_alloc_plain(x, n_floats)
    if n_floats < 1:
        raise ValueError(f"n_floats {n_floats}: at least 1")
    rows = x.shape[0]
    alloc_blocks(rows)
    dev = x.device
    cuda.check_tensors(dev, x=(x, torch.float32, (rows, 128)))
    cuda.check_aligned(x=x)
    out = torch.empty_like(x)
    ok = cuda.launch(cuda.library().rtrt_probe_smem_alloc,
                     "probe_smem_alloc", dev, x, out, ctypes.c_int(rows),
                     ctypes.c_int(n_floats), refusal=REFUSED)
    return out if ok else None


def optin_bytes(device="cuda") -> int:
    """The card's opt-in maximum of dynamic shared memory per block
    (cudaDevAttrMaxSharedMemoryPerBlockOptin), in bytes."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n = ctypes.c_int(0)
    rc = cuda.library().rtrt_smem_optin(index, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed, cudaError {rc}")
    return n.value


def edge_sizes(device="cuda"):
    """[(label, n_floats)]: the JAX tool's five sizes, then the card's edge
    (48 KB, the opt-in maximum, one float beyond it)."""
    top = optin_bytes(device) // 4
    return ([(f"{mb:4.2f} MiB", int(mb * 2**20 / 4)) for mb in SIZES_MIB]
            + [("48 KB (no opt-in)", SMEM_DEFAULT // 4),
               (f"opt-in maximum {4 * top} B", top),
               ("opt-in maximum + 1 float", top + 1)])


def try_alloc(n_floats: int, device="cuda", rows: int = SHAPE[0]) -> bool:
    """Whether a block may hold n_floats of dynamic shared memory: K11 on
    x = 1 of (rows, 128) (the JAX tool's input at 64 rows).  An accepted
    launch must give its plain version's output, or this raises."""
    x = torch.ones((rows, SHAPE[1]), device=device)
    out = smem_alloc(x, n_floats)
    if out is None:
        return False
    if not torch.equal(out, smem_alloc_plain(x, n_floats)):
        raise RuntimeError(f"K11 at {n_floats} floats: wrong output")
    return True


def _values(mode: str, tab):
    if mode == "extract":
        return lambda base: row_values(tab, base)
    flat = tab.reshape(-1)
    offs = torch.tensor(OFFSETS, device=tab.device)
    return lambda base: flat[(base + offs) % 8000]


def smem_consume_plain(mode: str, tab, x, steps: int):
    """Plain PyTorch version of K12: tab (128, 128), x (rows, 128) f32 ->
    (rows, 128) f32 (probe_smem.py:52-81)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return consume_loop(x, steps, _values(mode, tab))


def smem_consume(mode: str, tab, x, steps: int):
    """K12 (csrc/probe_consume.cu) for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return smem_consume_plain(mode, tab, x, steps)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    rows = x.shape[0]
    blocks, block_rows = launch_geometry(rows)
    dev = x.device
    check_consume_inputs(dev, tab, x)
    out = torch.empty_like(x)
    cuda.launch(cuda.library().rtrt_probe_smem_consume,
                "probe_smem_consume", dev, ctypes.c_int(MODES.index(mode)),
                tab, x, out, ctypes.c_int(rows), ctypes.c_int(steps),
                ctypes.c_int(blocks), ctypes.c_int(block_rows))
    return out


def alloc_bound(rows: int = SHAPE[0]):
    """(ms, "bytes" or "operations") of one K11 launch on its
    alloc_blocks(rows) SMs: x read and out written once, two adds a
    lane."""
    lanes = rows * 128
    return timing.bound_ms(2 * lanes * 4, 2 * lanes,
                           share=alloc_blocks(rows) / timing.SMS)


def run_alloc(n_floats: int, reps: int = 20, device="cuda"):
    """(events ms, graph ms) per K11 launch at n_floats on the tool's x:
    CUDA events around `reps` chained calls (each call's wrapper on the
    host included), and replays of a CUDA graph of 20 calls (the kernel
    alone; at or below 48 KB no attribute call falls inside the
    capture)."""
    x = torch.ones(SHAPE, device=device)
    fn = lambda: smem_alloc(x, n_floats)
    return timing.time_ms(fn, reps), timing.time_graph_ms(fn, 20, reps)


def run(mode: str, steps: int = 400, reps: int = 10, device="cuda"):
    """(ns per visit of the tile on its c SMs, floor ns per visit) of K12
    in `mode` on the card (CUDA events), on the JAX tool's inputs."""
    tab, x = tool_inputs(SHAPE[0], device)
    sec, _ = timing.time_chained(
        lambda _: smem_consume(mode, tab, x, steps), reps)
    return sec / steps * 1e9, bound(SHAPE[0], steps, LANE_OPS)[0] / steps \
        * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.card()
    print(card)
    alloc = []
    for label, n in edge_sizes():
        ok = try_alloc(n)
        print(f"dynamic shared memory {label} ({n} floats): "
              f"{'OK' if ok else 'REJECTED'}", flush=True)
        alloc.append(dict(label=label, n_floats=n, ok=ok))
    results = []
    for mode in MODES:
        ns, floor = run(mode)
        print(f"{mode:>8}: {ns:8.1f} ns per 72-value visit  floor "
              f"{floor:8.1f} ns [{card}]", flush=True)
        results.append(dict(mode=mode, ns=ns, floor_ns=floor))
    return alloc, results


if __name__ == "__main__":
    main()
