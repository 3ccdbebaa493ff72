"""Device timing on the card (port of rtrt_tpu/utils/timing.py).

The JAX module closes every timed region with a forced value fetch because
`block_until_ready` returned early on its TPU host.  On an NVIDIA card CUDA
events and `torch.cuda.synchronize()` are reliable, so:

  * `force_ready(x)` synchronises, then reads x's first element to the host
    (a checksum the caller may ignore);
  * `time_chained(dispatch, reps, warmup)` returns (seconds per rep,
    checksum), timed with CUDA events around `reps` chained dispatches;
  * `time_ms(fn, iters)` is the same for a call that takes no argument, in
    milliseconds;
  * `time_graph_ms(fn, launches, reps)` captures `launches` back-to-back
    calls of fn in one CUDA graph and replays it `reps` times between CUDA
    events: milliseconds per call of the kernel alone.  Event timing of
    chained calls (`time_ms`) includes each call's Python wrapper (checks,
    `torch.empty`, a ctypes launch, ~20-50 us on the host); a kernel shorter
    than that is then timed at the host's pace.  A replay launches the
    captured kernels with no host work between them.

`fetch_rtt` is not ported: CUDA events time the device's own stream, so
there is no host round trip to subtract.  A result that lies on the CPU
raises: a CPU time is never a device number.

The module also holds the card's peak rates and `bound_ms`, the least time
the card could take for a piece of work (the convention of every kernel's
bound in chip_smoke.py and the tools), and `card()`, the card's name and
power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

# H100 SXM data sheet, at its 700 W limit: device memory bytes per second,
# float32 operations per second outside the tensor cores (an FMA counts as
# two), streaming multiprocessors.  BF16_OPS: bf16 operations per second
# outside the tensor cores, twice the float32 rate through packed bf16x2
# issue (Hopper architecture white paper, "Peak BF16 (non-Tensor)")
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 2 * F32_OPS
SMS = 132


def _first_tensor(x) -> torch.Tensor:
    """The first tensor of a tensor, a sequence or a dataclass."""
    if torch.is_tensor(x):
        return x
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (list, tuple)):
        for item in x:
            if item is not None:
                return _first_tensor(item)
    raise TypeError(f"no tensor in {type(x).__name__}")


def _cuda_tensor(x) -> torch.Tensor:
    t = _first_tensor(x)
    if t.device.type != "cuda":
        raise ValueError(f"timing a result on {t.device}: device times come "
                         "from the card only")
    return t


def force_ready(x) -> float:
    """Wait for x's whole dependency chain on the card; return its first
    element as float."""
    t = _cuda_tensor(x)
    torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


def time_chained(dispatch, reps: int, warmup: int = 2):
    """Time `reps` chained dispatches between CUDA events.

    dispatch: callable (previous result or None) -> result.  Returns
    (seconds per rep, checksum of the last result)."""
    r = None
    for _ in range(warmup):
        r = dispatch(r)
    if r is not None:
        _cuda_tensor(r)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        r = dispatch(r)
    end.record()
    checksum = force_ready(r)
    return start.elapsed_time(end) / 1e3 / reps, checksum


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn() over `iters` calls after `warmup`
    calls (CUDA events)."""
    return time_chained(lambda _: fn(), iters, warmup)[0] * 1e3


def time_graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Mean milliseconds per call of fn() on the card, from `reps` replays
    of a CUDA graph of `launches` back-to-back calls (one warm-up call
    before the capture, one replay after it).  fn must launch on the
    current stream and neither synchronise nor copy to the host; its
    outputs come from the graph's private memory pool."""
    _cuda_tensor(fn())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches)


def bound_ms(nbytes: float, ops: float, share: float = 1.0,
             rate: float = F32_OPS):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over `rate` (float32 by default;
    BF16_OPS for bf16 work), both scaled by `share`, the fraction of the
    card's SMs the launch can fill (a launch of b blocks: b / SMS)."""
    t_b = nbytes / (HBM_BPS * share) * 1e3
    t_o = ops / (rate * share) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device_line(device) -> str:
    """The line a tool prints first: on the card its name and power limit
    (`card()`, which raises without a card), on the CPU a note that its
    numbers are not device numbers."""
    if str(device) == "cpu":
        return "the CPU (plain versions): host numbers, not device numbers"
    return card()


def card() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them.
    Raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "false): this runs on an NVIDIA GPU only")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
