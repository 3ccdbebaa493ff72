"""denoise.k4_roofline_pct: K4's bound a pass (44 bytes a pixel,
fbench/roofline.py::k4_pass_bound_ms) over its time a launch."""

from fbench.roofline import k4_pass_bound_ms

NEEDS = ("trace",)
PATTERN = r"\bdenoise_wide_kernel\b"


def read(ctx):
    t = ctx.trace
    n = 0 if t is None else t.launches(PATTERN)
    if not n:
        return None
    bound, _ = k4_pass_bound_ms(ctx.pixels)
    return 100.0 * bound * n / (t.kernel_s(PATTERN) * 1e3)
