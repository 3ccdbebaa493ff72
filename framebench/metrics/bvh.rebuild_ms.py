"""bvh.rebuild_ms: device busy milliseconds of the frame cut after its
animation / rebuild stage (engine/frame.py's "bvh" cut, as
tools/profile_frame.py times it): the wave, the smooth normals, the
two-level LBVH build and the tables' repack."""

NEEDS = ("cut",)


def read(ctx):
    c = ctx.cut
    if c is None or c.busy_s <= 0:
        return None
    return c.busy_s / c.frames * 1e3
