"""One run of one cell: set-up, the measured window, the traced part, the
compared frame and its plain reference, and the result line.

    python3 framebench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Set-up is everything from the process's
start to the first timed frame: imports and the CUDA context, the port's
kernel library (built by nvcc in the checkout's build/ on its first run),
the cached mesh, the Engine (its tree and sky bake) and the warm-up frames
of the cell's traffic.  The window then renders frames back to back, 2 in
flight, for `--seconds` on the host clock; frame_ms and frame_ms_p95 are
read from the frames' CUDA end events.  With --trace 1 the window is the
part with the profiler off (engine.host_ms reads it), and a few tens of
frames more (and the cell's cut frames, where a metric reads them) run
under torch.profiler (`_traced`).  Then one more frame of the same pan is
rendered with the Engine's state saved before it, the Engine is freed,
and the plain reference renders that frame from the same inputs.  The
reference also renders the run's first `chain_frames` frames (the start of
the warm-up) from its own start state, and their history is compared with
the program's after the same frames.  The numbers compared and their
limits are printed on standard error last and under the result's last
key, "check".
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
import types

import numpy as np

from . import compare, guard, manifest, profsum
from .pan import make_pan
from .scene import cached_mesh


class RunError(RuntimeError):
    """A run that prints no result: exit code 2 with the message."""


def process_start() -> float:
    """The perf_counter reading at this process's start (its start time in
    /proc/self/stat, against /proc/uptime), where Linux gives it."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def cache_dirs(root: str) -> str:
    """Fix every build and kernel cache at a path inside the checkout; the
    benchmark's own (the mesh) goes under build/framebench."""
    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    return os.path.join(build, "framebench")


def _e2e(start, ends):
    """frame_ms over the window and the 95th percentile of the intervals
    between frame completions (the first from the window's start)."""
    marks = [start] + ends
    gaps = np.array([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    return start.elapsed_time(ends[-1]) / len(ends), \
        float(np.percentile(gaps, 95))


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             root: str, t_start: float, device: str = "cuda",
             control_run: bool = False, fault=None) -> dict:
    """One run; returns the result line's object, with every number read
    (those without a limit too) under "program".  control_run: also read
    the numbers of the control, the reference with bfloat16 planes put in
    the program's place (tools/readings.py; under the result's "control").
    fault(engine, driver): a test's breakage of the timed path, applied
    before the warm-up."""
    import torch

    from . import program, reference

    cfg, traffic = cell.config, cell.traffic
    rng = np.random.default_rng(seed)
    pan = make_pan(traffic, rng)
    first = int(rng.integers(0, traffic["first_frame_max"]))
    mesh = cached_mesh(cfg["terrain"], cache_dirs(root))
    eng = program.build_engine(cfg, traffic, mesh, device)
    with tempfile.TemporaryDirectory() as tmp:
        drv = program.Driver(eng, traffic, pan, cfg["camera"], first, tmp)
    start_state = program.snapshot_state(eng)
    if fault is not None:
        fault(eng, drv)
    # the chain: the first warm-up frames from the start state, whose
    # cameras and resulting history the reference follows from its own start
    chain = []
    for _ in range(traffic["chain_frames"]):
        prev = drv.mirror.prev.copy()
        drv.frame()
        chain.append((drv.mirror.values.copy(), prev))
    chain_state = program.snapshot_state(eng)
    drv.run(frames=traffic["warmup_frames"] - len(chain))
    setup_s = time.perf_counter() - t_start

    start, ends, host = drv.run(seconds=seconds)
    frame_ms, p95 = _e2e(start, ends)
    window_frames = len(ends)
    found = guard.banned_modules()
    if found:
        raise RunError(f"loaded after the window: {found}")

    summary, gaps, cut = _traced(eng, drv, traffic, cell, device) \
        if trace else (None, [], None)

    # the compared frame: the pan's next frame from the saved state
    history, exposure = program.snapshot_state(eng)
    before = drv.frames
    prev = drv.mirror.prev.copy()
    image = drv.frame()
    out = program.frame_outputs(eng, image)
    on_card = device != "cpu"
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    camera = drv.mirror.values.copy()
    del eng, drv, image
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    t_ref = time.perf_counter()
    ref = reference.Reference(cfg, traffic, mesh, device)
    inputs = (history, exposure, (first + before) & 0xFFFFFFFF,
              reference.clock_after(before, traffic["dt"]), camera, prev,
              traffic["dt"])
    ref_out = ref.frame(*inputs)
    ref_chain = _chain(ref, chain, first, traffic["dt"])
    print(f"framebench: the reference took {time.perf_counter() - t_ref:.1f}"
          " s", file=sys.stderr)
    lbvh = cfg["bvh"] == "lbvh"
    numbers = compare.readings(out, ref_out, lbvh)
    numbers.update(compare.chain_readings(chain_state, ref_chain))
    numbers["start_state"] = compare.start_gap(start_state, ref.init_state())
    control = None
    if control_run:
        ref.plane_dtype = torch.bfloat16
        control = compare.readings(ref.frame(*inputs), ref_out, lbvh)
        control.update(compare.chain_readings(
            _chain(ref, chain, first, traffic["dt"]), ref_chain))
        control["start_state"] = 0.0  # exact in every precision
    correct, check = compare.judge(numbers, cell.limits)
    found = guard.banned_modules()
    if found:
        raise RunError(f"loaded by the run: {found}")

    pixels = ref.static.render_w * ref.static.render_h
    if trace:
        # what the per-layer readers (metrics/<name>.py) read
        ctx = types.SimpleNamespace(
            trace=summary, cut=cut, host_s=host, frame_ms=frame_ms,
            pixels=pixels, config=cfg, traffic=traffic)
        metrics = {}
        for m in cell.per_layer:
            v = manifest.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # "<quantity>.<qualifier>" is the quantity under a bound of its own
        # (BENCHMARK.json gives each such name the cells it holds for)
        values = dict(zip(manifest.QUANTITIES, (frame_ms, p95, setup_s)))
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": window_frames,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops(),
                               "idle_gaps": gaps}
    result["program"] = numbers
    if control is not None:
        result["control"] = control
    result["check"] = {k: [c["value"], c["limit"]] for k, c in check.items()}
    return result


def _chain(ref, chain, first: int, dt: float):
    """The reference's (history, exposure) after the chain's frames, rendered
    from its own start state with the cameras the program's frames took."""
    from . import reference

    history, exposure = ref.init_state()
    for k, (camera, prev) in enumerate(chain):
        out = ref.frame(history, exposure, (first + k) & 0xFFFFFFFF,
                        reference.clock_after(k, dt), camera, prev, dt)
        history, exposure = out["history"], out["exposure"]
    return history, exposure


def _traced(eng, drv, traffic, cell, device):
    """The profiled part, after the window.  `trace_frames` frames of the
    pan traced on the device alone (CUPTI's activity records, far lighter
    on the host than recording its operators) give the device's busy
    time, window, kernels and launches; `gap_frames` more, traced with
    the host's operators too, only name the idle gaps (recording each
    operator slows the host, so their times are not used); and, where a
    metric reads them, `cut_frames` frames cut after the rebuild stage.
    Returns (summary, idle gaps, cut summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import program

    host = [ProfilerActivity.CPU]
    on_card = device != "cpu"
    dev = [ProfilerActivity.CUDA] if on_card else host
    n = traffic["trace_frames"]
    with profile(activities=dev) as prof:
        drv.run(frames=n)
    summary = profsum.summarize(prof.events(), n)
    g = traffic["gap_frames"]
    with profile(activities=host + dev if on_card else host) as prof:
        drv.run(frames=g, span=record_function)
    gaps = profsum.summarize(prof.events(), g).top_gaps()
    cut = None
    if eng.rest is not None and any(
            "cut" in manifest.reader(m["name"]).NEEDS
            for m in cell.per_layer):
        n = traffic["cut_frames"]
        with profile(activities=dev) as prof:
            for _ in range(n):
                program.cut_frame(eng, drv.dt)
            if on_card:
                torch.cuda.synchronize()
        cut = profsum.summarize(prof.events(), n)
    return summary, gaps, cut


def main(argv=None, t_start=None) -> int:
    t_start = process_start() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    try:
        bench = manifest.load(root)
        cell = manifest.cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"framebench: no cell {args.workload!r} here: {e!r}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"framebench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          root, t_start)
    except RunError as e:
        print(f"framebench: {e}", file=sys.stderr)
        return 2
    for name, (value, limit) in result["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
