"""device.busy_ms: the card's busy milliseconds a frame over the traced
frames (the union of kernel, copy and fill intervals): the frame's device
time, which the host's pace does not move."""

NEEDS = ("trace",)


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or not t.frames:
        return None
    return t.busy_s / t.frames * 1e3
