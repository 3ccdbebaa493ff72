"""Headless CLI: render N frames without a display, print ms/frame, write
the last image (port of rtrt_tpu/app/headless.py; the same flags, and
--device and --trace).

Usage:
  python -m rtrt_tpu_torch.app.headless --scene demo --width 480 \
      --height 270 --frames 8 --out frame.png [--orbit] [--config cfg.toml]
      [--device cpu] [--trace megakernel|packets|loop]

Dynamic resolution is off, as in the JAX CLI: the frame renders at the
bucket of --height (engine/engine.py) and comes out at --width x --height.
The first frame is reported apart (on the card it builds the kernels).
Each timed frame includes the image's copy to the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="rtrt_tpu_torch headless renderer")
    p.add_argument("--config", default=None, help="TOML config path")
    p.add_argument("--scene", default=None, help="demo | terrain | mesh:<path>")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default="frame.png", help=".png or .ppm output")
    p.add_argument("--record", default=None,
                   help="directory: dump every frame as frame_%%04d.png")
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera (exercises motion vectors)")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--no-post", action="store_true")
    p.add_argument("--ocean", action="store_true",
                   help="ray-marched ocean (plain torch, render/water.py)")
    p.add_argument("--stars", action="store_true",
                   help="night star field (render/stars.py); pair with "
                        "--time-of-day near 0.0")
    p.add_argument("--time-of-day", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions)")
    p.add_argument("--trace", default="megakernel",
                   choices=("megakernel", "packets", "loop"),
                   help="path tracer (engine/engine.py): the megakernel, "
                        "the wavefront with K1 a segment, or the wavefront "
                        "with the loop traverser")
    args = p.parse_args(argv)

    from ..engine.engine import Engine
    from ..utils.config import (DynamicResolution, FeatureFlags, load_config,
                                set_param)
    from ..utils.image import write_png, write_ppm

    settings = load_config(args.config)
    over = {}
    if args.scene:
        over["scene"] = args.scene
    if args.width:
        over["render_width"] = args.width
    if args.height:
        over["render_height"] = args.height
    over["dynamic_resolution"] = DynamicResolution(enabled=False)
    settings = dataclasses.replace(settings, **over)

    flags = FeatureFlags(denoise=not args.no_denoise,
                         postprocess=not args.no_post,
                         ocean=args.ocean, stars=args.stars)
    eng = Engine(settings, flags=flags, trace=args.trace,
                 device=args.device)
    if args.time_of_day is not None:
        eng.params = set_param(eng.params, "sky.time_of_day",
                               args.time_of_day)

    img = None
    t_first = time.perf_counter()
    eng.render_frame(dt=1 / 60)  # builds the kernels on the card
    t_compiled = time.perf_counter()
    times = []
    for i in range(args.frames):
        if args.orbit:
            eng.camera = dataclasses.replace(eng.camera,
                                             yaw=eng.camera.yaw + 0.02)
        t0 = time.perf_counter()
        img = eng.render_frame(dt=1 / 60)
        times.append(time.perf_counter() - t0)
        if args.record:
            os.makedirs(args.record, exist_ok=True)
            write_png(f"{args.record}/frame_{i:04d}.png", img)
    avg = sum(times) / len(times)
    if eng.device.type == "cuda":
        from ..utils.timing import card
        where = f"[{card()}]"
    else:
        where = "on the CPU"
    print(f"first frame: {t_compiled - t_first:.1f}s | "
          f"{args.frames} frames @ {eng.render_w}x{eng.render_h}: "
          f"{avg * 1e3:.1f} ms/frame ({1 / avg:.1f} FPS) {where}")

    if args.out.endswith(".ppm"):
        write_ppm(args.out, img)
    else:
        write_png(args.out, img)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
