"""Per-stage frame profiler: the frame cut after each stage
(FrameStatic.stop_after) and timed (port of tools/profile_frame.py).

    python -m rtrt_tpu_torch.tools.profile_frame [--scene terrain]
        [--width 1920] [--height 1080] [--frames 5]
        [--stages bvh,trace,denoise,full] [--rebuild] [--trace-steps]
        [--device cuda|cpu]

The reference times its stages by the cudaDeviceSynchronize between them
(reference: src/kernel.cu:282-396).  The port's frame is a sequence of
launches with no host sync, so a stage's cost is the difference between
the frame cut after it and the frame cut after the stage before: for each
cut, `frames` chained cut frames after one warm-up frame, closed by
torch.cuda.synchronize(), on the host clock (ms per frame, cumulative), the
device busy time per frame of those frames (torch.profiler: kernels,
copies and fills on the card) and the kernel launches of one frame by
wrapper (utils/cuda.py::launch_counts).  The host-bound frame makes the
wall deltas alone misleading: the device busy column is the stage's work.
A cut frame returns the state it was given, so its frames repeat frame 0;
the "full" frames advance the state.  Cuts: bvh, trace, steps, denoise,
full (engine/frame.py); a delta is taken against the stage before in the
frame (bvh < trace < denoise < full; steps, which traces in place of
trace, against bvh).  A last row, "engine", times the Engine's own frames
(render_frame_device: on the card each a replay of its CUDA graph, after
the first frame and the two captures) and prints its graph_counts.

The Engine is the repo's at `--width x --height` (its resolution bucket
renders, upscaled to the screen size; dynamic resolution off, texture 256):
terrain (4 chunks), terrain_big (10), terrain_huge (21) or demo.
--rebuild builds it with bvh="lbvh" and rebuilds the static scene's LBVH in
every frame (Engine.static_rebuild), so the bvh cut times the build.
--trace-steps prints, in place of the timings, the traversal visits of K2's
step planes (the "steps" cut) per segment: the sum over pixels and the
mean, median, 90th percentile and maximum of a pixel (a path: one thread
a path on the card, where the JAX tool's planes are uniform over a
32x128 ray tile).

The first line printed is the card's name and power limit.  Without a card
the tool exits non-zero unless --device cpu is given; on the CPU the times
are the host's and the device busy column reads "not measured".
`main(argv)` returns what it measured (`measure`'s dict, or the steps
planes and their rows with --trace-steps) and the Engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

STAGES = ("bvh", "trace", "denoise", "full")
# the stage before each cut in the frame (a delta is taken against the
# nearest one timed); "steps" traces in place of "trace"
PREV = {"trace": "bvh", "steps": "bvh", "denoise": "trace",
        "full": "denoise"}
CHUNKS = {"terrain": 4, "terrain_big": 10, "terrain_huge": 21}


def make_engine(scene="terrain", width=1920, height=1080, rebuild=False,
                device="cuda"):
    """The profiled Engine: default FeatureFlags(), dynamic resolution
    off, texture 256; with rebuild, the LBVH rebuilt in every frame."""
    from ..engine.engine import Engine
    from ..utils.config import DynamicResolution, GlobalSettings

    settings = GlobalSettings(
        render_width=width, render_height=height,
        scene="terrain" if scene in CHUNKS else scene, texture_size=256,
        terrain_chunks=CHUNKS.get(scene, 4),
        dynamic_resolution=DynamicResolution(enabled=False))
    eng = Engine(settings, bvh="lbvh" if rebuild else "sah4", device=device)
    if rebuild:
        eng.static_rebuild()
    return eng


def cut_frame(eng, stop: str, state=None):
    """One frame of the Engine's live bucket cut after `stop` ("full": the
    whole frame), from `state` (None: the Engine's), with the Engine's
    camera, constants and counters.  Returns render_frame's result."""
    from ..engine.frame import render_frame

    static = dataclasses.replace(eng.static, stop_after=stop)
    return render_frame(static, eng.scene_data,
                        eng.state if state is None else state, eng.camera,
                        eng.prev_camera, eng.params, 1 / 60, eng.consts,
                        eng.overflow, eng.stack_depth, eng.rest)


def device_busy(step, frames: int):
    """torch.profiler over `frames` calls of step(): device busy ms per
    frame (the device-side events: kernels, copies, fills)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    return sum(dev_t(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / frames / 1e3


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(eng, stages=STAGES, frames=5):
    """Time each cut of the Engine's frame.  Returns dict(ms={cut:
    cumulative ms/frame by host clock}, busy={cut: device busy ms/frame,
    or None on the CPU}, launches={cut: {kernel: launches of one
    frame}}, outputs={cut: the first (warm-up) frame's result, from the
    Engine's state at the call}, state: that state)."""
    from ..utils import cuda

    state0 = eng.state
    out = dict(ms={}, busy={}, launches={}, outputs={}, state=state0)
    on_card = eng.device.type == "cuda"
    for stop in stages:
        eng.state = state0
        before = dict(cuda.launch_counts)
        out["outputs"][stop] = res = cut_frame(eng, stop, state0)
        _sync(eng.device)
        out["launches"][stop] = {k: v - before[k] for k, v in
                                 cuda.launch_counts.items() if v > before[k]}

        def step():
            r = cut_frame(eng, stop)
            if stop == "full":  # the whole frame advances the state
                eng.state = r[1]
            return r

        if stop == "full":
            eng.state = res[1]
        t0 = time.perf_counter()
        for _ in range(frames):
            step()
        _sync(eng.device)
        out["ms"][stop] = (time.perf_counter() - t0) / frames * 1e3
        out["busy"][stop] = device_busy(step, frames) if on_card else None
    eng.state = state0
    return out


def measure_engine(eng, frames=5, warmup=3):
    """The Engine's own frames: `warmup` of them (on the card the first,
    eager frame and the captures of the two parities' graphs), then
    `frames` timed as the cuts are.  Returns dict(ms=host ms/frame,
    busy=device busy ms/frame or None on the CPU, counts=a copy of the
    Engine's graph_counts after)."""
    step = lambda: eng.render_frame_device(1 / 60)
    for _ in range(warmup):
        step()
    _sync(eng.device)
    t0 = time.perf_counter()
    for _ in range(frames):
        step()
    _sync(eng.device)
    ms = (time.perf_counter() - t0) / frames * 1e3
    busy = device_busy(step, frames) if eng.device.type == "cuda" else None
    counts = dict(eng.graph_counts, eager=dict(eng.graph_counts["eager"]))
    return dict(ms=ms, busy=busy, counts=counts)


def step_stats(steps):
    """[(name, sum, mean, p50, p90, max)] of the (SEGMENTS + 1, h, w) step
    planes over pixels: TOTAL, then seg0, seg1, ..."""
    import torch

    rows = []
    names = ["TOTAL"] + [f"seg{k}" for k in range(steps.shape[0] - 1)]
    for name, plane in zip(names, steps):
        flat = torch.sort(plane.reshape(-1).to(torch.int64)).values.cpu()
        n = flat.numel()
        rows.append((name, int(flat.sum()), float(flat.double().mean()),
                     int(flat[n // 2]), int(flat[int(n * 0.9)]),
                     int(flat[-1])))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="terrain",
                    help="terrain, terrain_big, terrain_huge or demo")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma list of cut points to time (bvh, trace, "
                         "steps, denoise, full)")
    ap.add_argument("--rebuild", action="store_true",
                    help="rebuild the static scene's LBVH in every frame "
                         "(bvh='lbvh'), so the bvh cut times the build")
    ap.add_argument("--trace-steps", action="store_true",
                    help="print K2's traversal visits per segment over "
                         "pixels instead of stage timings")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    from ..utils.timing import device_line
    card = device_line(args.device)
    print(card)
    eng = make_engine(args.scene, args.width, args.height, args.rebuild,
                      args.device)
    head = (f"scene={args.scene} tris={eng.scene.num_tris} "
            f"{eng.render_w}x{eng.render_h} (screen {args.width}x"
            f"{args.height}, bvh={eng.bvh}"
            + (", rebuilt every frame" if args.rebuild else "") + ")")

    if args.trace_steps:
        (steps,), _ = cut_frame(eng, "steps")
        rows = step_stats(steps)
        print(f"\n{head}: traversal visits (node + leaf) per pixel, one "
              "path a pixel")
        for name, tot, mean, p50, p90, mx in rows:
            print(f"{name:<6} visits/pixel: total={tot:>11d} "
                  f"mean={mean:>8.2f} p50={p50:>5d} p90={p90:>5d} "
                  f"max={mx:>5d}")
        return dict(steps=steps, rows=rows, engine=eng)

    stages = [s.strip() for s in args.stages.split(",")]
    r = measure(eng, stages, args.frames)
    print(f"\n{head} ({args.frames} frames/stage) [{card}]")
    print(f"{'cut':<10}{'cumulative ms':>14}{'stage delta ms':>16}"
          f"{'device busy ms':>16}{'busy delta ms':>15}  launches/frame")
    for stop in stages:
        ms, busy = r["ms"][stop], r["busy"][stop]
        prev = PREV.get(stop)
        while prev is not None and prev not in r["ms"]:
            prev = PREV.get(prev)
        p_ms = r["ms"][prev] if prev else 0.0
        p_busy = (r["busy"][prev] or 0.0) if prev else 0.0
        b = (f"{busy:>16.3f}{busy - p_busy:>15.3f}" if busy is not None
             else f"{'not measured':>16}{'':>15}")
        print(f"{stop:<10}{ms:>14.2f}{ms - p_ms:>16.2f}{b}  "
              f"{r['launches'][stop]}")
    e = r["replayed"] = measure_engine(eng, args.frames)
    b = (f"{e['busy']:>16.3f}" if e["busy"] is not None
         else f"{'not measured':>16}")
    print(f"{'engine':<10}{e['ms']:>14.2f}{'':>16}{b}{'':>15}  "
          f"graph_counts={e['counts']}")
    r["engine"] = eng
    return r


if __name__ == "__main__":
    main()
    sys.exit(0)
