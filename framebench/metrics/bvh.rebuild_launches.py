"""bvh.rebuild_launches: kernel launches a frame of the rebuild stage (the
"bvh" cut frame's kernel events)."""

NEEDS = ("cut",)


def read(ctx):
    c = ctx.cut
    if c is None or not c.kernels:
        return None
    return c.launches() / c.frames
