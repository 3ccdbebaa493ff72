"""SSIM, the image-quality metric (port of rtrt_tpu/utils/ssim.py): an
11-tap Gaussian window with sigma 1.5, valid-mode filtering, the Wang et
al. (2004) constants c1 = (0.01 L)^2 and c2 = (0.03 L)^2 for the data
range L, and the mean over channels.

It takes numpy arrays or tensors and computes in float64, on the tensor's
device when one is a tensor (the window as one F.conv2d a plane; the JAX
module's numpy loop takes seconds at 1080p).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k = np.outer(k, k)
    return (k / k.sum()).astype(np.float64)


def _f64(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float64)
    return torch.from_numpy(np.asarray(x, np.float64)).to(device)


def ssim(a, b, data_range=255.0) -> float:
    """Mean SSIM over channels of two (H,W) or (H,W,C) images.

    `data_range` must match the images' scale: 255 for uint8-range images,
    1.0 for [0,1] ones.  A mismatched range saturates c1 and c2 and the
    metric degenerates (~0.996 for unrelated random [0,1] images with
    data_range=255), so a range above 4x the images' peak raises
    ValueError."""
    dev = next((x.device for x in (a, b) if torch.is_tensor(x)),
               torch.device("cpu"))
    a, b = _f64(a, dev), _f64(b, dev)
    if a.shape != b.shape:
        raise ValueError(f"ssim: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    peak = max(float(torch.maximum(a.max(), b.max())), 1e-12)
    if data_range > 4.0 * peak:
        raise ValueError(f"ssim data_range={data_range} but image peak="
                         f"{peak:.4g}: normalized images need "
                         f"data_range=1.0")
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = torch.from_numpy(_gaussian_kernel()).to(dev)[None, None]
    x = a.permute(2, 0, 1)[:, None]  # (C,1,H,W)
    y = b.permute(2, 0, 1)[:, None]
    mx, my = F.conv2d(x, k), F.conv2d(y, k)
    mxx, myy, mxy = F.conv2d(x * x, k), F.conv2d(y * y, k), F.conv2d(x * y, k)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / \
        ((mx * mx + my * my + c1) * (vx + vy + c2))
    return float(s.mean(dim=(1, 2, 3)).mean())
