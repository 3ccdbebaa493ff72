"""Sky data tool: bake the atmosphere maps and write them as PNGs (port of
tools/sky_preview.py).

    python -m rtrt_tpu_torch.tools.sky_preview OUT_DIR [--elevation 0.5]
        [--azimuth 0.2] [--sweep N] [--device cuda|cpu]

Counterpart of the reference's offline sky-data generator (reference:
tool/SkyData/skyData.cpp).  The sky is analytic, so the tool bakes the
radiance and pdf maps for a sun position (render/sky.py::bake_sky_maps)
and writes them tone-mapped for inspection (sky_map.png, sun_map.png,
sky_pdf.png), plus, with --sweep N, a strip of N sun elevations
(sweep.png).  The first line printed is the card's name and power limit;
without a card the tool exits non-zero unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def tonemap_u8(img, ev=1.0):
    """Reinhard tone map and gamma 2.2 of an HDR image to uint8."""
    x = np.asarray(img) * ev
    x = x / (1.0 + x)
    return (np.clip(x, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("--elevation", type=float, default=0.5)
    p.add_argument("--azimuth", type=float, default=0.2)
    p.add_argument("--sweep", type=int, default=0,
                   help="render N sun elevations into a strip")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..render.sky import bake_sky_maps, make_sky_params
    from ..utils.image import write_png
    from ..utils.timing import device_line

    print(device_line(args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    host = lambda t: t.cpu().numpy()
    maps = bake_sky_maps(make_sky_params(sun_elevation=args.elevation,
                                         sun_azimuth=args.azimuth,
                                         device=args.device))
    write_png(os.path.join(args.out_dir, "sky_map.png"),
              tonemap_u8(host(maps.sky_map), 2.0))
    write_png(os.path.join(args.out_dir, "sun_map.png"),
              tonemap_u8(host(maps.sun_map), 0.05))
    pdf = host(maps.sky_pdf).reshape(maps.sky_map.shape[:2])
    pdf_img = (pdf / max(pdf.max(), 1e-9)) ** 0.25
    write_png(os.path.join(args.out_dir, "sky_pdf.png"), pdf_img)
    print(f"wrote sky_map/sun_map/sky_pdf to {args.out_dir} (flux sky="
          f"{float(maps.sky_flux):.3f} sun={float(maps.sun_flux):.3f})")

    if args.sweep:
        strips = []
        for k in range(args.sweep):
            elev = -0.1 + 1.2 * k / max(args.sweep - 1, 1)
            m = bake_sky_maps(make_sky_params(sun_elevation=elev,
                                              device=args.device))
            strips.append(tonemap_u8(host(m.sky_map), 2.0))
        write_png(os.path.join(args.out_dir, "sweep.png"),
                  np.concatenate(strips, axis=0))
        print(f"wrote sweep.png ({args.sweep} elevations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
