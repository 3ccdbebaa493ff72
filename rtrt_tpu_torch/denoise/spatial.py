"""Edge-aware spatial filters: the 7x7 half-kernel pass and the dilated
(a-trous) 5x5 chain — kernel K4 and its plain twin (port of
rtrt_tpu/denoise/spatial.py).

Joint-bilateral weight of a tap, in this order:
    w = gauss(offset) * max(0, n . n_tap)^sigma_normal
        * exp(-((z_tap - z) / (sigma_depth * max(z, 1) + 1e-6))^2)
        * [mat == mat_tap ? 1 : max(1 - sigma_material, 0)]
with sky (non-finite) depths taken as 0 and a depth weight of 0 across a
sky/surface edge; the centre is kept where the weights sum to <= 1e-6.

  * `edge_aware_pass` launches, for CUDA tensors, K4
    (csrc/denoise_wide.cu) and runs `edge_aware_pass_plain` (the JAX
    package's XLA tap-accumulation form, `_edge_aware_pass`) for CPU
    tensors.  The same kernel carries both the 7x7 (radius 3, stride 1,
    frame-alternating half kernel) and the 5x5 passes at strides 3, 6, 12:
    four launches per denoised frame.
  * `_gate_by_noise` lerps the filtered image toward the input by the tile
    noise level, as a torch op after the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.stencil import gaussian_weights, gaussian_weights_np, shifted
from ..utils import cuda
from ..utils.config import DenoiseParams


def _m_miss(p: DenoiseParams) -> float:
    """max(1 - sigma_material, 0) in float32 arithmetic."""
    return float(np.maximum(np.float32(1.0) - np.float32(p.sigma_material),
                            np.float32(0.0)))


def edge_aware_pass_plain(color, normal, depth, mat_id, p: DenoiseParams,
                          radius: int, stride: int, half_taps: bool = False,
                          parity: int = 0):
    """One joint-bilateral gaussian pass; returns the filtered colour.  Taps
    in the order dy outer, dx inner; half_taps zeroes every tap k (but the
    centre) with (k + parity) odd."""
    g = gaussian_weights(radius, color.device)
    k_half = (2 * radius + 1) ** 2 // 2
    fin_d = torch.isfinite(depth)
    safe_d = torch.where(fin_d, depth, 0.0)
    inv_sig = 1.0 / (p.sigma_depth * torch.clamp(safe_d, min=1.0) + 1e-6)
    m_miss = _m_miss(p)

    wsum = torch.zeros(depth.shape, dtype=torch.float32, device=depth.device)
    acc = torch.zeros(color.shape, dtype=torch.float32, device=color.device)
    k = -1
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            k += 1
            if half_taps and k != k_half and (k + parity) % 2 != 0:
                continue  # a zero weight adds nothing to either sum
            sy, sx = dy * stride, dx * stride
            c_t = shifted(color, sy, sx)
            n_t = shifted(normal, sy, sx)
            d_t = shifted(depth, sy, sx)
            m_t = shifted(mat_id, sy, sx)
            n_dot = (n_t[..., 0] * normal[..., 0] + n_t[..., 1] * normal[..., 1]
                     + n_t[..., 2] * normal[..., 2])
            n_w = torch.clamp(n_dot, min=0.0) ** p.sigma_normal
            fin_t = torch.isfinite(d_t)
            dz = (torch.where(fin_t, d_t, 0.0) - safe_d) * inv_sig
            d_w = torch.exp(-dz * dz)
            d_w = torch.where(fin_t == fin_d, d_w, 0.0)
            m_w = torch.where(m_t == mat_id, 1.0, m_miss)
            w = g[k] * n_w * d_w * m_w
            wsum = wsum + w
            acc = acc + c_t * w[..., None]

    out = acc / torch.clamp(wsum, min=1e-6)[..., None]
    # fall back to the center where weights vanish
    return torch.where((wsum > 1e-6)[..., None], out, color)


def edge_aware_pass(color, normal, depth, mat_id, p: DenoiseParams,
                    radius: int, stride: int, half_taps: bool = False,
                    parity: int = 0):
    """The joint-bilateral pass on (H,W,3) colour and normal, (H,W) depth
    and (H,W) int32 material ids.  CPU tensors run the plain version; CUDA
    tensors launch K4."""
    if color.device.type == "cpu":
        return edge_aware_pass_plain(color, normal, depth, mat_id, p, radius,
                                     stride, half_taps, parity)
    if radius not in (2, 3):
        raise ValueError(f"K4 takes radius 2 or 3, got {radius}")
    dev = color.device
    h, w = depth.shape
    cuda.check_tensors(dev, color=(color, torch.float32, (h, w, 3)),
                       normal=(normal, torch.float32, (h, w, 3)),
                       depth=(depth, torch.float32, (h, w)),
                       mat_id=(mat_id, torch.int32, (h, w)))
    g = gaussian_weights_np(radius)  # host array, copied into the launch
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    cuda.launch(cuda.library().rtrt_denoise_wide, "denoise_wide", dev,
                color, normal, depth, mat_id, ctypes.c_int(h), ctypes.c_int(w),
                ctypes.c_void_p(g.ctypes.data), ctypes.c_int(radius),
                ctypes.c_int(stride), ctypes.c_int(int(half_taps)),
                ctypes.c_int(int(parity) & 1),
                ctypes.c_float(p.sigma_normal), ctypes.c_float(p.sigma_depth),
                ctypes.c_float(p.sigma_material), out)
    return out


def _upsample_tiles(noise, h, w, tile):
    """Nearest-upsample a tile map to (h, w); rows and columns beyond the
    last whole tile repeat the last tile (the edge padding of the JAX
    function)."""
    ys = torch.clamp(torch.arange(h, device=noise.device) // tile,
                     max=noise.shape[0] - 1)
    xs = torch.clamp(torch.arange(w, device=noise.device) // tile,
                     max=noise.shape[1] - 1)
    return noise.index_select(0, ys).index_select(1, xs)


def _gate_by_noise(filtered, original, noise, threshold, tile: int):
    """Noise-level gating as a smooth lerp."""
    h, w = original.shape[0], original.shape[1]
    up = _upsample_tiles(noise, h, w, tile)
    gate = torch.clamp(up / max(threshold, 1e-8), 0.0, 1.0)[..., None]
    return original + (filtered - original) * gate


def spatial_filter_7x7(color, normal, depth, mat_id, noise8,
                       p: DenoiseParams, frame_parity: int = 0):
    """Full 7x7 joint-bilateral, gated by the 8x8 tile noise level,
    alternating half-kernels per frame."""
    filtered = edge_aware_pass(color, normal, depth, mat_id, p, radius=3,
                               stride=1, half_taps=True, parity=frame_parity)
    return _gate_by_noise(filtered, color, noise8, p.noise_threshold, 8)


def spatial_filter_wide(color, normal, depth, mat_id, noise16,
                        p: DenoiseParams, stride: int):
    """5x5 taps at the given stride (3/6/12 -> 15/30/60 px footprints),
    gated by the 16x16 tile noise level."""
    filtered = edge_aware_pass(color, normal, depth, mat_id, p, radius=2,
                               stride=stride)
    return _gate_by_noise(filtered, color, noise16, p.noise_threshold_16, 16)
