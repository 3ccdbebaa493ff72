"""Fourier-fitted textures: image-derived materials evaluated analytically
(port of rtrt_tpu/render/ftex.py).

A tileable texture is projected once, on the host, onto a truncated 2-D
Fourier basis (numpy least squares, the JAX module's code), and a textured
hit evaluates the series at its triplanar coordinates: no texel fetch, and
the mip chain becomes exact prefiltering, a Gaussian footprint of std sigma
(tile units) scaling the term of frequency f by exp(-2 pi^2 |f|^2 sigma^2).

  * `fit_fourier_texture`, `fit_soil_fourier`, `eval_fourier_np`: host
    numpy, as JAX's, so a fit of the same texels gives the same tuples;
  * `eval_fourier_c`, `triplanar_fourier_c`, `ftex_shading_c`: component
    form in torch, the plain K2's textured branch (render/megakernel.py),
    in the JAX functions' order of operations (the constants 2 pi fx and
    -2 pi^2 f^2 are Python floats that round to float32 at the multiply);
  * `upload_ftex`: the fit beside K2's coefficient table of it
    (`pack_ftex`; csrc/kshade.cuh::ftex_shading) on a device, made once
    where the fit is made (the Engine's init), so that no frame copies from
    the host.

The fit has N_TERMS atoms of frequencies up to MAX_FREQ, and the textures
tile WORLD_SCALE times a world unit (render/texture.py): the JAX modules'
defaults.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kshade import V3, orthonormal_basis_c, vnormalize
from .texture import WORLD_SCALE

N_TERMS = 24   # cos / sin atoms a texture (fit_fourier_texture)
MAX_FREQ = 8   # their largest frequency, cycles a tile

# K2's coefficient table (csrc/kshade.cuh FTEX_*, which must equal these):
# a row a texture, a header of FTEX_HEAD floats (the 4 channel means, the
# world scale, 3 zeros), then FTEX_ATOM floats for each of the fit's
# FTEX_ATOMS atoms (2 pi fx, 2 pi fy, -2 pi^2 |f|^2, 0, the cosine term's 4
# weights, the sine term's 4 weights)
FTEX_CHANNELS = 4
FTEX_ATOMS = N_TERMS
FTEX_HEAD = 8
FTEX_ATOM = 12
FTEX_ROW = FTEX_HEAD + FTEX_ATOMS * FTEX_ATOM


class FourierTexture(NamedTuple):
    """Truncated 2-D Fourier model of one (tileable) texture.

    value(u, v) = mean + sum_k weight[k] * cos(2 pi (fx u + fy v) + phase)
    with (u, v) in tile units (period 1); nested float tuples, as JAX's."""

    freq: tuple    # K x (fx, fy) integer cycles/tile
    phase: tuple   # K floats
    weight: tuple  # K x C floats
    mean: tuple    # C floats


class FourierTextures(NamedTuple):
    """The fitted material set (albedo + AO, normal + roughness)."""

    albedo_ao: FourierTexture
    normal_rough: FourierTexture


def _atoms(max_freq):
    """(fx, fy) atoms covering every orientation once: fx in [0..F], fy in
    [-F..F], without (0, 0) and the fy <= 0 half of the fx == 0 column."""
    out = []
    for fx in range(max_freq + 1):
        for fy in range(-max_freq, max_freq + 1):
            if fx == 0 and fy <= 0:
                continue
            out.append((fx, fy))
    return out


def fit_fourier_texture(img) -> FourierTexture:
    """Least-squares fit of an (S, S, C) tileable image: lstsq over the
    full cos / sin dictionary of frequencies up to MAX_FREQ on a subsampled
    grid, keep the N_TERMS atoms of most energy, refit those (each atom a
    cosine and a sine term)."""
    img = np.asarray(img, np.float32)
    s = img.shape[0]
    sub = max(1, s // 128)
    im = img[::sub, ::sub].reshape(-1, img.shape[-1]).astype(np.float64)
    n = img[::sub, ::sub].shape[0]
    yy, xx = np.meshgrid((np.arange(n) + 0.5) / n,
                         (np.arange(n) + 0.5) / n, indexing="ij")
    u = xx.reshape(-1)
    v = yy.reshape(-1)

    mean = im.mean(axis=0)
    resid = im - mean

    atoms = _atoms(MAX_FREQ)
    cols = []
    for fx, fy in atoms:
        ang = 2 * np.pi * (fx * u + fy * v)
        cols.append(np.cos(ang))
        cols.append(np.sin(ang))
    a = np.stack(cols, axis=1)                      # (N, 2K0)
    w, *_ = np.linalg.lstsq(a, resid, rcond=None)   # (2K0, C)

    # cos + sin pair k -> its energy; keep the top n_terms atoms
    wc = w[0::2]
    ws = w[1::2]
    amp2 = (wc ** 2 + ws ** 2).sum(axis=1)
    keep = np.argsort(amp2)[::-1][:N_TERMS]

    cols = []
    for k in keep:
        fx, fy = atoms[k]
        ang = 2 * np.pi * (fx * u + fy * v)
        cols.append(np.cos(ang))
        cols.append(np.sin(ang))
    a2 = np.stack(cols, axis=1)
    w2, *_ = np.linalg.lstsq(a2, resid, rcond=None)
    wc = w2[0::2]
    ws = w2[1::2]
    # each atom stays two plain weighted cosines: phase 0 and -pi/2 (sin)
    freq = []
    phase = []
    weight = []
    for i, k in enumerate(keep):
        fx, fy = atoms[k]
        freq.append((float(fx), float(fy)))
        phase.append(0.0)
        weight.append(tuple(float(x) for x in wc[i]))
        freq.append((float(fx), float(fy)))
        phase.append(-float(np.pi / 2.0))
        weight.append(tuple(float(x) for x in ws[i]))
    return FourierTexture(tuple(freq), tuple(phase), tuple(weight),
                          tuple(float(x) for x in mean))


def fit_soil_fourier(soil) -> FourierTextures:
    """Fit the level-0 mips of a SoilTextures set (render/texture.py)."""
    def level0(mip):
        s = mip.base_size
        return mip.texels[:s * s].cpu().numpy().reshape(s, s, -1)

    return FourierTextures(
        fit_fourier_texture(level0(soil.albedo_ao)),
        fit_fourier_texture(level0(soil.normal_rough)))


def eval_fourier_np(tex: FourierTexture, u, v, sigma=0.0):
    """Numpy float64 evaluation of the series (tests)."""
    u = np.asarray(u, np.float64)[..., None]
    v = np.asarray(v, np.float64)[..., None]
    freq = np.asarray(tex.freq, np.float64)
    fx = freq[:, 0]
    fy = freq[:, 1]
    ang = 2 * np.pi * (fx * u + fy * v) + np.asarray(tex.phase)
    att = np.exp(-2 * np.pi ** 2 * (fx ** 2 + fy ** 2) * float(sigma) ** 2)
    basis = np.cos(ang) * att                       # (..., K)
    return np.asarray(tex.mean) + basis @ np.asarray(tex.weight)


def eval_fourier_c(tex: FourierTexture, u, v, sigma):
    """Component-form evaluation: u, v, sigma same-shape tensors; returns a
    list of C channel tensors."""
    k = len(tex.freq)
    c = len(tex.weight[0]) if k else len(tex.mean)
    two_pi = 2.0 * np.pi
    s2 = sigma * sigma
    acc = [torch.zeros_like(u) + float(tex.mean[ci]) for ci in range(c)]
    for i in range(k):
        fx = float(tex.freq[i][0])
        fy = float(tex.freq[i][1])
        f2 = fx * fx + fy * fy
        ang = (two_pi * fx) * u + (two_pi * fy) * v + float(tex.phase[i])
        term = torch.cos(ang) * torch.exp((-2.0 * np.pi ** 2 * f2) * s2)
        for ci in range(c):
            w = float(tex.weight[i][ci])
            if w != 0.0:
                acc[ci] = acc[ci] + w * term
    return acc


def triplanar_fourier_c(tex: FourierTexture, pos, ns, cone_w):
    """Triplanar Fourier sampling in component form: pos / ns V3, cone_w
    the footprint at the hit (world units); the projection and LOD of
    render/texture.py::triplanar_sample, sigma half the footprint in tile
    units."""
    ax = torch.abs(ns.x)
    ay = torch.abs(ns.y)
    az = torch.abs(ns.z)
    wx = ax * ax * ax * ax
    wy = ay * ay * ay * ay
    wz = az * az * az * az
    inv = 1.0 / torch.clamp(wx + wy + wz, min=1e-8)

    ws = WORLD_SCALE
    sigma = torch.clamp(cone_w, min=0.0) * (ws * 0.5)
    cx = eval_fourier_c(tex, pos.y * ws, pos.z * ws, sigma)
    cy = eval_fourier_c(tex, pos.x * ws, pos.z * ws, sigma)
    cz = eval_fourier_c(tex, pos.x * ws, pos.y * ws, sigma)
    return [(wx * a + wy * b + wz * c) * inv
            for a, b, c in zip(cx, cy, cz)]


def ftex_shading_c(ftex: FourierTextures, pos, ns, cone_width):
    """The textured material's shading from the fitted set, in the
    interface of kshade.soil_shading_c: -> (albedo * ao V3, roughness,
    normal V3)."""
    a = triplanar_fourier_c(ftex.albedo_ao, pos, ns,
                            cone_width)             # [r, g, b, ao]
    nr = triplanar_fourier_c(ftex.normal_rough, pos, ns,
                             cone_width)            # [nx, ny, nz, rough]
    ao = torch.clamp(a[3], 0.0, 1.0)
    alb = V3(torch.clamp(a[0], 0.0, 1.0) * ao,
             torch.clamp(a[1], 0.0, 1.0) * ao,
             torch.clamp(a[2], 0.0, 1.0) * ao)
    rough = torch.clamp(nr[3], 0.05, 1.0)
    # texture.apply_normal_map in component form: the texture normal is
    # y-up local; project it into the surface frame
    t, b = orthonormal_basis_c(ns)
    n2 = t * nr[0] + b * nr[2] + ns * torch.clamp(nr[1], min=0.2)
    return alb, rough, vnormalize(n2)


def pack_ftex(ftex: FourierTextures) -> np.ndarray:
    """The fit as K2's (2, FTEX_ROW) float32 coefficient table (layout at
    FTEX_ROW above).  K2 evaluates an atom's cosine and sine terms from one
    sincos of their shared angle, so each texture's terms must come in the
    pairs that fit_fourier_texture writes: the same frequency with phase 0,
    then -pi/2.  ValueError otherwise, or for another atom count than
    FTEX_ATOMS or another channel count than 4."""
    out = np.zeros((2, FTEX_ROW), np.float32)
    two_pi = 2.0 * np.pi
    for row, tex in zip(out, ftex):
        k = len(tex.freq)
        if k != 2 * FTEX_ATOMS or len(tex.mean) != FTEX_CHANNELS or any(
                len(w) != FTEX_CHANNELS for w in tex.weight):
            raise ValueError(f"a Fourier texture of {k} terms and "
                             f"{len(tex.mean)} channels: K2 takes "
                             f"{FTEX_ATOMS} cos / sin atoms of "
                             f"{FTEX_CHANNELS} channels")
        row[0:4] = tex.mean
        row[4] = WORLD_SCALE
        for a in range(FTEX_ATOMS):
            (fx, fy), (gx, gy) = tex.freq[2 * a], tex.freq[2 * a + 1]
            if (fx, fy) != (gx, gy) or tex.phase[2 * a] != 0.0 or \
                    tex.phase[2 * a + 1] != -float(np.pi / 2.0):
                raise ValueError("K2 takes Fourier textures as cos / sin "
                                 "pairs of one frequency (phase 0, -pi/2)")
            f2 = fx * fx + fy * fy
            rec = row[FTEX_HEAD + FTEX_ATOM * a:FTEX_HEAD + FTEX_ATOM * (a + 1)]
            rec[0:3] = (two_pi * fx, two_pi * fy, -2.0 * np.pi ** 2 * f2)
            rec[4:8] = tex.weight[2 * a]
            rec[8:12] = tex.weight[2 * a + 1]
    return out


class FtexTable(NamedTuple):
    """A fit beside its K2 coefficient table (pack_ftex) on a device: what
    a frame takes (FrameStatic.ftex).  The plain K2 shades from `fit`, K2
    from `table`."""

    fit: FourierTextures
    table: torch.Tensor  # (2, FTEX_ROW) float32


def upload_ftex(fit: FourierTextures, device="cuda") -> FtexTable:
    """Pack `fit` and copy its table to `device`, once: a launch then
    copies nothing from the host."""
    return FtexTable(fit, torch.from_numpy(pack_ftex(fit)).to(device))
