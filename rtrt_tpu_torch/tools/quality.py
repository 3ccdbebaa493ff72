"""Image quality of the denoised 1-spp stream against a converged render
(port of tools/quality_1080p.py).

    python -m rtrt_tpu_torch.tools.quality [--width 1920 --height 1080]
        [--spp 64] [--frames 48] [--scene terrain] [--interlace]
        [--out last.png] [--device cuda|cpu]

The reference is the mean of `spp` raw frames (FeatureFlags(denoise=False),
post-processing on), averaged gamma-linearised (x^2.2) and re-encoded.  The
ceiling is the SSIM of its two independent halves of spp/2 frames each: no
denoiser scores much above it against this reference.  The trajectory is
the SSIM of the denoised stream (the default FeatureFlags(); interlaced
with --interlace, the reference full-rate) at frames 1, 2, 4, 8, 16, 24, 32
and `frames`, all with data_range 1.0.  Dynamic resolution is off and the
camera still.

The first line printed is the card's name and power limit; without a card
the tool exits non-zero unless --device cpu is given.  It writes the last
denoised frame only to --out.  `measure` returns the numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

CHECKPOINTS = (1, 2, 4, 8, 16, 24, 32)


def measure(width=1920, height=1080, spp=64, frames=48, scene="terrain",
            interlace=False, device="cuda", log=None):
    """Render the reference and the denoised stream; returns dict(ceiling,
    trajectory=[(frame, ssim)], final, image: the last denoised frame,
    (height, width, 3) uint8 on the device).  log: a callable that takes
    each line as it is measured (None: silent)."""
    from ..engine.engine import Engine
    from ..utils.config import DynamicResolution, FeatureFlags, \
        GlobalSettings
    from ..utils.ssim import ssim

    say = log or (lambda line: None)
    settings = GlobalSettings(
        render_width=width, render_height=height, scene=scene,
        texture_size=256, dynamic_resolution=DynamicResolution(enabled=False))

    # the converged reference, gamma-linearised before the mean
    eng_ref = Engine(settings, flags=FeatureFlags(denoise=False),
                     device=device)
    acc = acc_a = None
    for i in range(spp):
        lin = (eng_ref.render_frame_device(dt=1 / 60).to(torch.float32)
               / 255.0) ** 2.2
        acc = lin if acc is None else acc + lin
        if i + 1 == spp // 2:
            acc_a = acc
    del eng_ref
    ref = (acc / spp) ** (1 / 2.2)
    half_a = (acc_a / (spp // 2)) ** (1 / 2.2)
    half_b = ((acc - acc_a) / (spp - spp // 2)) ** (1 / 2.2)
    ceiling = ssim(half_a, half_b, data_range=1.0)
    say(f"ceiling: SSIM({spp // 2}-spp A, {spp - spp // 2}-spp B) "
        f"independent converged pair = {ceiling:.4f}")

    # the denoised 1-spp stream
    eng = Engine(dataclasses.replace(settings, interlace=interlace),
                 device=device)
    trajectory = []
    img = None
    for i in range(frames):
        img = eng.render_frame_device(dt=1 / 60)
        if i + 1 in CHECKPOINTS or i + 1 == frames:
            s = ssim(img.to(torch.float64) / 255.0, ref, data_range=1.0)
            trajectory.append((i + 1, s))
            say(f"frame {i + 1:3d}: SSIM vs {spp}-spp converged = {s:.4f}")
    return dict(ceiling=ceiling, trajectory=trajectory,
                final=trajectory[-1][1], image=img)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--scene", default="terrain")
    ap.add_argument("--interlace", action="store_true",
                    help="stream interlaced frames (the reference stays "
                         "full-rate): the interlace quality cost")
    ap.add_argument("--out", default=None,
                    help="write the last denoised frame to this PNG")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    if args.device == "cpu":
        print("on the CPU (plain versions): not a device number")
    else:
        from ..utils.timing import card
        print(card())  # raises without a card
    r = measure(args.width, args.height, args.spp, args.frames, args.scene,
                args.interlace, args.device, log=print)
    print(f"{args.width}x{args.height} {args.scene}: denoised stream SSIM = "
          f"{r['final']:.4f} after {args.frames} frames, ceiling "
          f"{r['ceiling']:.4f}")
    if args.out:
        from ..utils.image import write_png
        write_png(args.out, r["image"].cpu().numpy())
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
