"""Counter-based low-discrepancy sampling (port of rtrt_tpu/render/sampling.py).

Per-pixel Owen-scrambled Sobol with PCG hashing: deterministic in the pixel
id, the frame and the dimension pair, reproduced BIT-EXACTLY.  torch's CPU
backend has no uint32 add/shift/compare, so the uint32 math runs in int64
tensors masked with ``& 0xFFFFFFFF``; products are split into 16-bit halves
so no intermediate exceeds 2^49 (the CUDA kernels use native uint32_t).

Every hash accepts Python ints as well as int64 tensors: values shared by
all pixels (the frame index, the blue-noise sequence, per-dimension shifts)
are computed on the host and enter the tensor math as scalars, so no
device round trip is needed for them.  A frame replayed as a CUDA graph
reads them from the device instead: the frame index as a 0-d tensor, the
blue-noise sequence's point (`bn_point`) as the host computed it.
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


def wang_hash(x):
    """Wang hash (uint32 -> uint32), the reference's fallback RNG."""
    x = u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = mul32(x, 9)
    x = x ^ (x >> 4)
    x = mul32(x, 0x27D4EB2D)
    return x ^ (x >> 15)


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


def sobol_owen_2d(index, seed):
    """One decorrelated 2D low-discrepancy point per element: uint32 sample
    index and per-(pixel, dimension-pair) seed (integer tensors or ints,
    broadcast) -> (..., 2) float32 in [0, 1)."""
    u, v = sobol_owen_pair(u32(index), u32(seed))
    dev = next((x.device for x in (u, v) if torch.is_tensor(x)), None)
    u, v = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.float32, device=dev)
          for x in (u, v)))
    return torch.stack([u, v], dim=-1)


def rand2(pixel_id, frame, dim_pair):
    """(..., 2) LD floats for integer pixel ids, frame and dim pair (the
    frame an int or a 0-d integer tensor)."""
    u, v = sobol_owen_pair(u32(frame), pixel_seed(u32(pixel_id),
                                                  u32(dim_pair)))
    return torch.stack([u, v], dim=-1)


def rand1(pixel_id, frame, dim):
    return rand2(pixel_id, frame, dim)[..., 0]


def white2(pixel_id, frame, dim_pair):
    """(..., 2) hash white noise (the Wang-hash fallback path's pairs)."""
    h = hash_combine(hash_combine(u32(pixel_id), u32(frame)), u32(dim_pair))
    return torch.stack([_to_unit_float(hash_pcg(h ^ 0x1)),
                        _to_unit_float(hash_pcg(h ^ 0x2))], dim=-1)


# ---------------------------------------------------------------------------
# inter-pixel blue-noise sample distribution
# ---------------------------------------------------------------------------


def blue_noise_mask() -> np.ndarray:
    """(64, 64, 2) float32 toroidal rank masks (resources/bluenoise64.npy)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "resources", "bluenoise64.npy")
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


def bn_point(frame, dim_pair):
    """rand2_bn's pixel-independent part: the shared Owen-Sobol point (u, v)
    of (frame, dim_pair).  Python floats for an int frame; 0-d float32
    tensors for a 0-d integer tensor frame (a uint32 held on the device),
    at the cost of some 400 scalar ops."""
    return sobol_owen_pair(u32(frame), pixel_seed(0, u32(dim_pair)))


def rand2_bn(bn2, frame, dim_pair, point=None):
    """Blue-noise-dithered LD pair: one shared Owen-Sobol sequence plus a
    per-pixel CP rotation by the mask offsets bn2 (..., 2).  frame: an int
    or a 0-d integer tensor; point: bn_point(frame, dim_pair) given as a
    (2,) float32 tensor, read in place of frame (a replayed frame's
    uniforms hold it, filled from the host's floats)."""
    bu, bv = bn_point(frame, dim_pair) if point is None else point.unbind(0)
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


def cosine_hemisphere(u):
    """Cosine-weighted direction about +z; pdf cos(theta) / pi."""
    d = concentric_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)


def uniform_hemisphere(u):
    """Uniform direction about +z; pdf 1 / (2 pi)."""
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sphere(u):
    """Uniform direction on the sphere; pdf 1 / (4 pi)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_cone(u, cos_theta_max):
    """Uniform direction in the cone about +z of cos_theta_max (a float or
    a tensor of u's leading shape); pdf `uniform_cone_pdf`."""
    cos_t = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u[..., 1]
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)


def uniform_cone_pdf(cos_theta_max):
    if torch.is_tensor(cos_theta_max):
        return 1.0 / (TWO_PI * torch.clamp(1.0 - cos_theta_max, min=1e-8))
    return 1.0 / (TWO_PI * max(1.0 - cos_theta_max, 1e-8))


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (beta = 2)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return torch.where(f + g > 0.0,
                       (f * f) / torch.clamp(f * f + g * g, min=1e-20),
                       torch.zeros_like(f))
