"""Mipmapped material textures with triplanar projection and ray-cone LOD
(port of rtrt_tpu/render/texture.py).

  * `make_soil_textures`: the framework's procedural soil set (albedo + AO,
    normal + roughness), generated on the host in numpy exactly as the JAX
    module generates it (the same value noise and the same float32 math),
    so its texels equal JAX's bit for bit; each texture becomes a flat mip
    pyramid (`build_mip_pyramid`, 2x2 box filter down to 1x1).
  * `sample_trilinear`, `triplanar_sample`, `apply_normal_map`: the gather
    path that the wavefront integrator (render/integrator.py) shades
    textured materials with when procedural_textures is off.  The
    megakernel shades them from the procedural soil or from the Fourier
    fit of this set (render/ftex.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.vecmath import normalize, orthonormal_basis

WORLD_SCALE = 0.25  # texture tiles per world unit (triplanar projection)


@dataclasses.dataclass
class MipTexture:
    """Flattened mip pyramid.  texels: (T, C) f32; level l occupies rows
    [offsets[l], offsets[l] + size_l^2), row-major (y * size_l + x)."""

    texels: torch.Tensor   # (T, C) f32
    offsets: torch.Tensor  # (L,) int64
    base_size: int         # size of level 0 (a power of two)

    @property
    def num_levels(self) -> int:
        return int(self.offsets.shape[0])


def build_mip_pyramid(img, device="cuda") -> MipTexture:
    """img: (S, S, C) float array (S a power of two) -> the full mip chain
    down to 1x1 by 2x2 box filter, on `device`."""
    img = torch.as_tensor(np.asarray(img, np.float32)).to(device)
    s = img.shape[0]
    if s & (s - 1):
        raise ValueError(f"texture size {s} is not a power of two")
    levels = [img]
    while levels[-1].shape[0] > 1:
        a = levels[-1]
        h = a.shape[0] // 2
        # the 2x2 mean summed along x, then y: XLA's order, so that every
        # level equals the JAX pyramid's bit for bit
        levels.append(a.reshape(h, 2, h, 2, a.shape[-1]).sum(3).sum(1)
                      * 0.25)
    sizes = [lv.shape[0] * lv.shape[1] for lv in levels]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    texels = torch.cat([lv.reshape(-1, lv.shape[-1]) for lv in levels], 0)
    return MipTexture(texels, torch.from_numpy(offsets).to(device), s)


def _bilinear_at_level(tex: MipTexture, uv, level):
    """Bilinear sample at the integer mip levels `level` (...,), repeat
    wrapping."""
    size = torch.clamp(tex.base_size >> level, min=1)
    off = tex.offsets[level]
    fs = size.to(torch.float32)
    x = uv[..., 0] * fs - 0.5
    y = uv[..., 1] * fs - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), size)
    x1i = torch.remainder(x0i + 1, size)
    y0i = torch.remainder(y0.to(torch.int64), size)
    y1i = torch.remainder(y0i + 1, size)
    c00 = tex.texels[off + y0i * size + x0i]
    c01 = tex.texels[off + y0i * size + x1i]
    c10 = tex.texels[off + y1i * size + x0i]
    c11 = tex.texels[off + y1i * size + x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) \
        + (c10 * (1 - fx) + c11 * fx) * fy


def sample_trilinear(tex: MipTexture, uv, lod):
    """Continuous-LOD trilinear sample; uv (..., 2) repeat-wrapped, lod
    (...,)."""
    lmax = tex.num_levels - 1
    lod = torch.clamp(lod, 0.0, float(lmax))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=lmax)
    f = (lod - l0.to(torch.float32))[..., None]
    c0 = _bilinear_at_level(tex, uv, l0)
    c1 = _bilinear_at_level(tex, uv, l1)
    return c0 * (1 - f) + c1 * f


def triplanar_sample(tex: MipTexture, pos, n, cone_width):
    """Triplanar projection sample with ray-cone LOD.  pos (..., 3) world
    hit position; n (..., 3) shading normal; cone_width (...,) the ray
    cone's world footprint at the hit; WORLD_SCALE tiles a world unit.
    Returns (..., C)."""
    world_scale = WORLD_SCALE
    w = torch.abs(n)
    w = w * w * w * w
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-8)

    texels_per_unit = world_scale * tex.base_size
    lod = torch.log2(torch.clamp(cone_width * texels_per_unit, min=1e-6))
    lod = torch.clamp(lod, min=0.0)

    uv_x = torch.stack([pos[..., 1], pos[..., 2]], dim=-1) * world_scale
    uv_y = torch.stack([pos[..., 0], pos[..., 2]], dim=-1) * world_scale
    uv_z = torch.stack([pos[..., 0], pos[..., 1]], dim=-1) * world_scale
    cx = sample_trilinear(tex, torch.remainder(uv_x, 1.0), lod)
    cy = sample_trilinear(tex, torch.remainder(uv_y, 1.0), lod)
    cz = sample_trilinear(tex, torch.remainder(uv_z, 1.0), lod)
    return w[..., 0:1] * cx + w[..., 1:2] * cy + w[..., 2:3] * cz


# ---------------------------------------------------------------------------
# the procedural soil material (init time, numpy)
# ---------------------------------------------------------------------------


def _value_noise_2d(size, cells, seed, octaves=4):
    """Tileable multi-octave value noise, (size, size) in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = np.zeros((size, size), np.float32)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        c = cells * (2 ** o)
        grid = rng.uniform(0, 1, (c, c)).astype(np.float32)
        # bilinear upsample with wrap
        ys = (np.arange(size) + 0.5) / size * c - 0.5
        y0 = np.floor(ys).astype(int)
        fy = (ys - y0)[:, None]
        xs = ys
        x0 = np.floor(xs).astype(int)
        fx = (xs - x0)[None, :]
        g = lambda yy, xx: grid[np.mod(yy, c)[:, None], np.mod(xx, c)[None, :]]
        sm = lambda t: t * t * (3 - 2 * t)
        fy_s, fx_s = sm(fy), sm(fx)
        v = (g(y0, x0) * (1 - fy_s) + g(y0 + 1, x0) * fy_s) * (1 - fx_s) \
            + (g(y0, x0 + 1) * (1 - fy_s) + g(y0 + 1, x0 + 1) * fy_s) * fx_s
        out += amp * v
        total += amp
        amp *= 0.5
    return out / total


@dataclasses.dataclass
class SoilTextures:
    """The standard material texture set."""

    albedo_ao: MipTexture      # C=4: rgb albedo + ao
    normal_rough: MipTexture   # C=4: y-up tangent normal xyz + roughness


def make_soil_textures(size=1024, seed=7, device="cuda") -> SoilTextures:
    """The soil set's mip pyramids on `device`, from level-0 images made
    on the host in numpy."""
    h = _value_noise_2d(size, 8, seed, octaves=6)          # height field
    detail = _value_noise_2d(size, 32, seed + 1, octaves=4)

    # albedo: blend of dirt browns by height + detail
    c_dark = np.array([0.23, 0.15, 0.09], np.float32)
    c_mid = np.array([0.42, 0.30, 0.18], np.float32)
    c_light = np.array([0.55, 0.47, 0.35], np.float32)
    t = np.clip(h[..., None] * 1.4 - 0.2, 0, 1)
    albedo = c_dark * (1 - t) + c_mid * t
    t2 = np.clip(detail[..., None] * 1.2 - 0.3, 0, 1)
    albedo = albedo * (1 - 0.4 * t2) + c_light * (0.4 * t2)

    # ambient occlusion from height (valleys darker)
    ao = np.clip(0.55 + 0.45 * h, 0, 1)[..., None].astype(np.float32)

    # normal from the height gradient (y-up tangent space)
    scale = 3.0
    dx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * 0.5 * size / 64.0
    dy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * 0.5 * size / 64.0
    nrm = np.stack([-dx * scale, np.ones_like(h), -dy * scale], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    rough = np.clip(0.55 + 0.4 * detail + 0.15 * (1 - h), 0.05, 1.0)[..., None]

    albedo_ao = np.concatenate([albedo, ao], axis=-1).astype(np.float32)
    normal_rough = np.concatenate([nrm, rough], axis=-1).astype(np.float32)
    return SoilTextures(build_mip_pyramid(albedo_ao, device),
                        build_mip_pyramid(normal_rough, device))


def apply_normal_map(n_geom, n_tex):
    """Perturb the geometric normal by a texture normal given in a y-up
    local frame, projected into the surface frame."""
    t, b = orthonormal_basis(n_geom)
    n = (n_tex[..., 0:1] * t + n_tex[..., 2:3] * b
         + torch.clamp(n_tex[..., 1:2], min=0.2) * n_geom)
    return normalize(n)
