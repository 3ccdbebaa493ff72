"""2D stencil helpers (port of rtrt_tpu/ops/stencil.py::shifted,
neighborhood, gaussian_weights).  Images are (H, W, C) or (H, W)."""

from __future__ import annotations

import numpy as np
import torch


def _edge_pad(img, py: int, px: int):
    """img padded by py rows and px columns on each side, edges repeated
    (two index_selects, any dtype)."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(-py, h + py, device=img.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-px, w + px, device=img.device), 0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def shifted(img, dy: int, dx: int):
    """Image translated by (dy, dx) with edge-clamp boundary:
    out[y, x] = img[clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape[0], img.shape[1]
    p = _edge_pad(img, abs(dy), abs(dx))
    return p[abs(dy) + dy:abs(dy) + dy + h, abs(dx) + dx:abs(dx) + dx + w]


def neighborhood(img, radius: int, stride: int = 1):
    """All (2r+1)^2 shifted copies, dy outer and dx inner: returns the
    (K, H, W, ...) stack and the matching (K, 2) integer offsets.  The
    image is edge-padded once; every tap is a view of the padded copy."""
    h, w = img.shape[0], img.shape[1]
    r = radius * stride
    p = _edge_pad(img, r, r)
    taps, offsets = [], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            y0, x0 = r + dy * stride, r + dx * stride
            taps.append(p[y0:y0 + h, x0:x0 + w])
            offsets.append((dy, dx))
    return torch.stack(taps, dim=0), torch.tensor(offsets, dtype=torch.int32)


def gaussian_weights_np(radius: int, sigma: float | None = None):
    """Normalized (2r+1)^2 gaussian tap weights, flattened (K,): computed in
    float64 and rounded to float32 once."""
    if sigma is None:
        sigma = radius * 0.5 + 0.25
    ax = np.arange(-radius, radius + 1)
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k2 = np.outer(k, k)
    return (k2 / k2.sum()).reshape(-1).astype(np.float32)


def gaussian_weights(radius: int, device, sigma: float | None = None):
    """gaussian_weights_np as a float32 tensor on `device` (copied without
    a stream sync)."""
    return torch.from_numpy(gaussian_weights_np(radius, sigma)).to(
        device, non_blocking=True)
