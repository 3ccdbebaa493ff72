# Frozen copy of rtrt_tpu_torch/render/sampling.py
# (framebench's plain reference).
"""Counter-based low-discrepancy sampling (port of rtrt_tpu/render/sampling.py).

Per-pixel Owen-scrambled Sobol with PCG hashing: deterministic in the pixel
id, the frame and the dimension pair, reproduced BIT-EXACTLY.  torch's CPU
backend has no uint32 add/shift/compare, so the uint32 math runs in int64
tensors masked with ``& 0xFFFFFFFF``; products are split into 16-bit halves
so no intermediate exceeds 2^49 (the CUDA kernels use native uint32_t).

Every hash accepts Python ints as well as int64 tensors: values shared by
all pixels (the frame index, the blue-noise sequence, per-dimension shifts)
are computed on the host and enter the tensor math as scalars, so no
device round trip is needed for them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

M32 = 0xFFFFFFFF
TWO_PI = 6.283185307179586
INV_2POW24 = 5.960464477539063e-08   # 2^-24


def u32(x):
    """Integer tensor -> int64 tensor holding a uint32 value; Python int ->
    Python int in [0, 2^32)."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & M32
    return int(x) & M32


def mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_pcg(x):
    """PCG output permutation (uint32 -> uint32)."""
    state = (mul32(x, 747796405) + 2891336453) & M32
    word = mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def hash_combine(a, b):
    """Boost-style mix of two uint32 hashes."""
    return hash_pcg(a ^ ((b + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2)) & M32))


def reverse_bits32(x):
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) & M32) | (x >> 16)


def _sobol_dim1_directions():
    vs = []
    v = 1 << 31
    for _ in range(32):
        vs.append(v)
        v ^= v >> 1
    return vs


_DIM1_V = _sobol_dim1_directions()


def _sobol_dim1(index):
    result = torch.zeros_like(index) if torch.is_tensor(index) else 0
    for k in range(32):
        result = result ^ (((index >> k) & 1) * _DIM1_V[k])
    return result


def _laine_karras_permutation(x, seed):
    x = (x + seed) & M32
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    x = x ^ mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(x, seed):
    return reverse_bits32(_laine_karras_permutation(reverse_bits32(x), seed))


def _to_unit_float(u):
    """uint32 -> [0, 1) float32 from the top 24 bits (exact; a Python int
    gives the same value as a Python float)."""
    if torch.is_tensor(u):
        return (u >> 8).to(torch.float32) * INV_2POW24
    return float(u >> 8) * INV_2POW24


def pixel_seed(pixel_id, dim_pair):
    return hash_combine(pixel_id, mul32(dim_pair, 0x9E3779B9))


def sobol_owen_pair(index, seed):
    """Decorrelated LD point (u, v) for uint32 index / seed (ints or
    tensors)."""
    shuffled = owen_scramble(index, hash_combine(seed, 0x4D595DF4))
    x = owen_scramble(reverse_bits32(shuffled),
                      hash_combine(seed, 0x968B6B5A))
    y = owen_scramble(_sobol_dim1(shuffled), hash_combine(seed, 0x6E62F19B))
    return _to_unit_float(x), _to_unit_float(y)


# ---------------------------------------------------------------------------
# inter-pixel blue-noise sample distribution
# ---------------------------------------------------------------------------


def blue_noise_mask() -> np.ndarray:
    """(64, 64, 2) float32 toroidal rank masks (fbref/resources/
    bluenoise64.npy, a copy of the repository's resources/bluenoise64.npy)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "resources", "bluenoise64.npy")
    return np.load(path)


def blue_offsets_flat(w: int, h: int, n_pad: int) -> np.ndarray:
    """Per-pixel Cranley-Patterson offsets of a row-major (h, w) image padded
    to n_pad rays: (n_pad, 2) float32 numpy."""
    m = blue_noise_mask()
    reps_y = -(-h // m.shape[0])
    reps_x = -(-w // m.shape[1])
    flat = np.tile(m, (reps_y, reps_x, 1))[:h, :w].reshape(h * w, 2)
    if n_pad > h * w:
        flat = np.concatenate(
            [flat, np.broadcast_to(flat[-1], (n_pad - h * w, 2))])
    return np.ascontiguousarray(flat)


def _dim_shift(dim_pair):
    d = u32(dim_pair)
    return (_to_unit_float(hash_pcg(d ^ 0xA511E9B3)),
            _to_unit_float(hash_pcg(d ^ 0x63D83595)))


def rand2_bn(bn2, frame, dim_pair):
    """Blue-noise-dithered LD pair: one shared Owen-Sobol sequence plus a
    per-pixel CP rotation by the mask offsets bn2 (..., 2)."""
    bu, bv = sobol_owen_pair(u32(frame), pixel_seed(0, u32(dim_pair)))
    sx, sy = _dim_shift(dim_pair)
    ox = bn2[..., 0] + sx
    oy = bn2[..., 1] + sy
    u = bu + (ox - torch.floor(ox))
    v = bv + (oy - torch.floor(oy))
    return torch.stack([u - torch.floor(u), v - torch.floor(v)], dim=-1)


# ---------------------------------------------------------------------------
# warps + MIS
# ---------------------------------------------------------------------------


def concentric_disk(u):
    """[0,1)^2 -> unit disk (Shirley-Chiu)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    one = torch.ones_like(ox)
    theta = torch.where(
        use_x,
        (np.pi / 4.0) * (oy / torch.where(ox == 0, one, ox)),
        (np.pi / 2.0) - (np.pi / 4.0) * (ox / torch.where(oy == 0, one, oy)))
    pt = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], torch.zeros_like(pt), pt)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (beta = 2)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return torch.where(f + g > 0.0,
                       (f * f) / torch.clamp(f * f + g * g, min=1e-20),
                       torch.zeros_like(f))
