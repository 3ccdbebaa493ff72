"""Sky-model parity evidence: the Rayleigh-Mie physical sky against the
published Perez / Preetham analytic daylight luminance (port of
tools/sky_compare.py).

    python -m rtrt_tpu_torch.tools.sky_compare [--turbidity 2.5]
        [--samples 4000] [--device cuda|cpu]

The physical sky (render/sky.py::atmosphere_radiance, on the device) and
the analytic standard (render/skyref.py::sky_luminance, numpy float64)
are compared as normalized luminance over the upper hemisphere, without
the 10-degree circumsolar core (where a single-scatter model differs from
fitted aureole terms) and the horizon band below 2 degrees, at four sun
elevations: log-luminance correlation, relative RMSE and the horizon /
zenith and sun-side / anti-sun ratios of both.  The first line printed is
the card's name and power limit; without a card the tool exits non-zero
unless --device cpu is given.  `compare` returns the numbers.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

LUMA = (0.2126, 0.7152, 0.0722)
ELEVATIONS = (0.15, 0.35, 0.7, 1.1)


def fibonacci_hemisphere(n):
    """n directions spread evenly over the upper (y > 0) hemisphere."""
    i = np.arange(n) + 0.5
    y = i / n                       # cos(theta) in (0,1): upper hemisphere
    phi = i * 2.399963229728653     # golden angle
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=-1)


def compare(sun_elevation, turbidity, n, verbose=True, device="cuda"):
    """Returns (log-correlation, relative RMSE, (horizon / zenith ours,
    Perez), (sun-side / anti-sun ours, Perez))."""
    import torch

    from ..render.sky import atmosphere_radiance, make_sky_params
    from ..render.skyref import sky_luminance

    params = make_sky_params(sun_elevation=sun_elevation, device=device)
    dirs = fibonacci_hemisphere(n).astype(np.float32)
    ours_rgb = atmosphere_radiance(torch.from_numpy(dirs).to(device),
                                   params).cpu().numpy()
    ours = ours_rgb @ np.asarray(LUMA)
    sun = params.sun_dir.cpu().numpy()
    ref = sky_luminance(dirs, sun, turbidity)

    # exclude the circumsolar core (fitted aureole vs single scatter) and
    # the horizon band below 2 deg (the model marches to the ground there)
    sun = sun.astype(np.float64)
    cosg = dirs @ (sun / np.linalg.norm(sun))
    mask = (cosg < np.cos(np.radians(10.0))) & (dirs[:, 1] > 0.035)
    a = ours[mask]
    b = ref[mask]
    a = a / a.mean()
    b = b / b.mean()
    corr = float(np.corrcoef(np.log(np.maximum(a, 1e-6)),
                             np.log(np.maximum(b, 1e-6)))[0, 1])
    rrmse = float(np.sqrt(np.mean((a - b) ** 2)) / b.mean())

    # structural ratios: horizon brightening + sun-side/anti-sun asymmetry
    def mean_where(x, m):
        return float(x[m].mean()) if m.any() else float("nan")

    horiz = (dirs[:, 1] > 0.035) & (dirs[:, 1] < 0.25) & mask
    zen = dirs[:, 1] > 0.9
    sun_side = mask & (cosg > 0.5)
    anti = mask & (cosg < -0.5)
    rh_a = mean_where(ours / ours[mask].mean(), horiz) / \
        mean_where(ours / ours[mask].mean(), zen)
    rh_b = mean_where(ref / ref[mask].mean(), horiz) / \
        mean_where(ref / ref[mask].mean(), zen)
    rs_a = float(ours[sun_side].mean() / ours[anti].mean())
    rs_b = float(ref[sun_side].mean() / ref[anti].mean())

    if verbose:
        print(f"sun_elev={sun_elevation:4.2f} turb={turbidity}: "
              f"log-corr={corr:.4f} relRMSE={rrmse:.3f}  "
              f"horizon/zenith ours={rh_a:.2f} perez={rh_b:.2f}  "
              f"sun/anti ours={rs_a:.2f} perez={rs_b:.2f}")
    return corr, rrmse, (rh_a, rh_b), (rs_a, rs_b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turbidity", type=float, default=2.5)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from ..utils.timing import device_line
    print(device_line(args.device))
    for elev in ELEVATIONS:
        compare(elev, args.turbidity, args.samples, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
