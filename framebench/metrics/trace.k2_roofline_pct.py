"""trace.k2_roofline_pct: K2's bound over its time a launch.  The bound is
framebench's own count (fbench/roofline.py::k2_bound_ms): the cell's
pixels and the configuration's k2_counts, visits and hits a pixel that
framebench's frozen plain traversal measured once (tools/k2_counts.py)."""

from fbench.roofline import k2_bound_ms

NEEDS = ("trace",)
PATTERN = r"\bmegakernel\b"


def read(ctx):
    t = ctx.trace
    counts = ctx.config.get("k2_counts")
    n = 0 if t is None else t.launches(PATTERN)
    if not n or counts is None:
        return None
    bound, _ = k2_bound_ms(ctx.pixels, counts)
    return 100.0 * bound * n / (t.kernel_s(PATTERN) * 1e3)
