"""Marginal per-step cost of the real traversal: K1 with a step cap (port of
tools/probe_traverse.py).

Runs the K1 launcher (bvh/packet.py::packet_intersect) on the 1080p
terrain scene's tables with 1920x1080 primary rays (jitter 0.5, as the JAX
tool) at several caps on each ray's visits, with count_steps, and prints

    marginal cost/step = (t(capB) - t(capA)) / (stepsB - stepsA)

with steps counted exactly by the kernel (each ray writes its visits).
The kernel is the real one: the same traversal loop as the megakernel's.

The caps are smaller than the TPU tool's (24,48,96,192): those count the
steps of a whole 32x128 tile's shared loop, while K1's cap counts one
ray's own node and leaf visits, and a primary ray makes about 5.1 node and
0.9 leaf visits on this scene (PERF.md).  At 2 and 4 nearly every ray is
cut, at 8 some, at 16 few, so the differences between caps stay large.

Usage: python -m rtrt_tpu_torch.tools.probe_traverse [--caps 2,4,8,16]
       [--reps 10] [--lean]
"""

from __future__ import annotations

import argparse

import torch

from ..bvh.packet import packet_intersect
from ..core.camera import camera_basis
from ..engine.engine import Engine
from ..render.raygen import generate_rays_padded
from ..utils import timing
from ..utils.config import DynamicResolution, GlobalSettings

W, H = 1920, 1080


def terrain_primaries(device="cuda"):
    """(tables, org (N, 3), dir (N, 3)): the 1080p terrain scene's trace
    tables and its Engine camera's primary rays through pixel centres."""
    eng = Engine(GlobalSettings(render_width=W, render_height=H,
                                scene="terrain", texture_size=64,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)), device=device)
    n = W * H
    pixel_ids = torch.arange(n, dtype=torch.int32, device=device)
    jitter = torch.full((n, 2), 0.5, device=device)
    rays = generate_rays_padded(camera_basis(eng.camera), W, H, pixel_ids,
                                jitter, jitter)
    return (eng.scene_data.tables, rays.org.contiguous(),
            rays.dir.contiguous())


def measure(tables, org, dir, caps, reps: int):
    """[(cap, seconds per launch, total visits)] of K1 under each cap."""
    results = []
    for cap in caps:
        fn = lambda _, cap=cap: packet_intersect(tables, org, dir,
                                                 max_steps=cap,
                                                 count_steps=True)
        sec, _ = timing.time_chained(fn, reps)
        steps = int(fn(None).steps.sum(dtype=torch.int64))
        results.append((cap, sec, steps))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--caps", default="2,4,8,16")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--lean", action="store_true",
                    help="accepted for the JAX tool's command line: K1 "
                         "always runs the lean loop (best, slot, u, v; the "
                         "attributes are read once after it)")
    args = ap.parse_args(argv)
    card = timing.card()
    print(card)
    tables, org, dir = terrain_primaries()
    results = measure(tables, org, dir,
                      [int(c) for c in args.caps.split(",")], args.reps)
    for cap, sec, steps in results:
        print(f"cap={cap:4d}: {sec * 1e3:8.3f} ms  {steps:9d} steps "
              f"({org.shape[0]} rays) [{card}]", flush=True)
    marginal = []
    for (c1, t1, s1), (c2, t2, s2) in zip(results, results[1:]):
        if s2 == s1:
            print(f"caps {c1} and {c2} run the same steps: no marginal cost")
            continue
        ns = (t2 - t1) / (s2 - s1) * 1e9
        marginal.append(ns)
        print(f"marginal cost/step between cap {c1} and {c2}: {ns:8.4f} ns "
              f"per ray-step [{card}]")
    return results, marginal


if __name__ == "__main__":
    main()
