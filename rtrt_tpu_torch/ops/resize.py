"""Image resampling (port of rtrt_tpu/ops/resize.py::box_pool, downsample4,
upsample_linear)."""

from __future__ import annotations

import torch.nn.functional as F


def box_pool(img, k: int):
    """k x k mean pool of an (H, W, C) image (truncates ragged edges)."""
    h, w = (img.shape[0] // k) * k, (img.shape[1] // k) * k
    x = img[:h, :w].reshape(h // k, k, w // k, k, *img.shape[2:])
    return x.sum(dim=(1, 3)) / (k * k)


def downsample4(img):
    """4x4 box average — the reference's DownScale4 unit."""
    return box_pool(img, 4)


def upsample_linear(img, out_h: int, out_w: int):
    """Bilinear resize of an (H, W, C) image to (out_h, out_w): half-pixel
    centres, edge samples clamped.  For an upsample this is the function
    of jax.image.resize(..., "linear"), whose triangle kernel drops the
    taps outside the image and renormalises the rest."""
    x = img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False)
    return y[0].permute(1, 2, 0)
