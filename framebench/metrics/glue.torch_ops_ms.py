"""glue.torch_ops_ms: device milliseconds a frame of every kernel that is
not one of the port's csrc/ kernels: PyTorch's own kernels of the torch-op
glue (raygen, the G-buffer finish, the denoiser's and post's torch ops)."""

NEEDS = ("trace",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.launches(csrc=False):
        return None
    return t.kernel_s(csrc=False) / t.frames * 1e3
