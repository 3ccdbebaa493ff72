"""frame.mfu: the frame's counted work over its time: the least time the
card could take for K2's paths and the denoiser's four joint-bilateral
passes at the cell's pixels (fbench/roofline.py, whatever implements
them), as a share of the window's frame_ms.  It bounds what any one
kernel's roofline share can buy end to end."""

from fbench.roofline import k2_bound_ms, k4_pass_bound_ms

NEEDS = ()
K4_PASSES = 4


def read(ctx):
    counts = ctx.config.get("k2_counts")
    if counts is None or not ctx.frame_ms:
        return None
    work = k2_bound_ms(ctx.pixels, counts)[0] \
        + K4_PASSES * k4_pass_bound_ms(ctx.pixels)[0]
    return 100.0 * work / ctx.frame_ms
