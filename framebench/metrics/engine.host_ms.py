"""engine.host_ms: the host's milliseconds a frame inside
Engine.render_frame_device (the enqueue; the host clock around each call),
mean over the traced run's window, which runs with the profiler off."""

NEEDS = ()


def read(ctx):
    if not ctx.host_s:
        return None
    return sum(ctx.host_s) / len(ctx.host_s) * 1e3
