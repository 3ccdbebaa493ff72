"""device.idle_pct: the share of the traced frames' wall window in which no
kernel, copy or fill ran on the card."""

NEEDS = ("trace",)


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
