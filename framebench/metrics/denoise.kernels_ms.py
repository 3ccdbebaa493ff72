"""denoise.kernels_ms: device milliseconds a frame of the denoiser's
hand-written kernels, K5 (history reprojection) and K4 (the a-trous
passes)."""

NEEDS = ("trace",)
PATTERN = r"\b(reproject_kernel|denoise_wide_kernel)\b"


def read(ctx):
    t = ctx.trace
    if t is None or not t.launches(PATTERN):
        return None
    return t.kernel_s(PATTERN) / t.frames * 1e3
