"""Image resampling (port of rtrt_tpu/ops/resize.py::box_pool/downsample4)."""

from __future__ import annotations


def box_pool(img, k: int):
    """k x k mean pool of an (H, W, C) image (truncates ragged edges)."""
    h, w = (img.shape[0] // k) * k, (img.shape[1] // k) * k
    x = img[:h, :w].reshape(h // k, k, w // k, k, *img.shape[2:])
    return x.sum(dim=(1, 3)) / (k * k)


def downsample4(img):
    """4x4 box average — the reference's DownScale4 unit."""
    return box_pool(img, 4)
