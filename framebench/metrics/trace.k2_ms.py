"""trace.k2_ms: device milliseconds a frame of the path-trace megakernel
K2 (csrc/megakernel.cu's `megakernel` instantiations)."""

NEEDS = ("trace",)
PATTERN = r"\bmegakernel\b"


def read(ctx):
    t = ctx.trace
    if t is None or not t.launches(PATTERN):
        return None
    return t.kernel_s(PATTERN) / t.frames * 1e3
