"""engine.launches: kernel launches on the card a frame, from the
profiler's kernel events over the traced frames (copies and fills not
counted)."""

NEEDS = ("trace",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return t.launches() / t.frames
