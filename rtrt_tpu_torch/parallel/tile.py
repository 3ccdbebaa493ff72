"""The tile-parallel teaching frame with explicit collectives (port of
rtrt_tpu/parallel/tile.py): the image's rows shard over the ranks of a
RowMesh (parallel/frame_spmd.py), the scene replicates, and the only
cross-rank dependencies are collectives:

  * auto-exposure needs the whole image's luminance histogram ->
    `all_reduce` (`_global_histogram`; JAX: `psum`);
  * the 7x7 denoise stencil needs rows beyond the band -> a halo fetched
    from the other ranks (`_halo_exchange`; JAX: `ppermute` of the
    neighbours' rows);
  * the presented frame is gathered by the caller (frame_spmd.gather_image).

`make_tile_frame(mesh, ...)` is a reduced pipeline, not the product frame
(frame_spmd.make_spmd_frame_fn is that): raygen -> path trace (the
wavefront integrator) -> a fixed 0.2 temporal blend -> the 7x7 pass (K4
on the card) on the band and its halo -> the global exposure -> tone map.
"""

from __future__ import annotations

import torch

from ..core.camera import camera_basis, pixel_to_dir
from ..denoise.spatial import spatial_filter_7x7
from ..denoise.temporal import tile_noise_level
from ..post.exposure import (LOG_LUM_MAX, LOG_LUM_MIN, NUM_BINS,
                             exposure_compensation)
from ..post.tonemap import tonemap
from ..render.integrator import path_trace
from ..render.raygen import Rays
from ..render.sampling import rand2
from ..utils.config import DenoiseParams
from .frame_spmd import RowMesh, band_rows


def _halo_exchange(img, halo: int, mesh: RowMesh):
    """The band (Hs, W, ...) of an image sharded in equal bands over the
    mesh, with `halo` rows of the image above and below:
    (halo + Hs + halo, W, ...).  The edge ranks clamp-pad (their own edge
    row repeated); a halo deeper than a band reaches past the neighbour."""
    hs = img.shape[0]
    return band_rows(mesh, img, mesh.rank * hs - halo,
                     (mesh.rank + 1) * hs + halo)


def _global_histogram(lum_band, mesh: RowMesh):
    """The band's log-luminance histogram (NUM_BINS,) float32, summed over
    the ranks: the whole image's."""
    ll = torch.clamp((torch.log2(torch.clamp(lum_band.reshape(-1), min=1e-8))
                      - LOG_LUM_MIN) / (LOG_LUM_MAX - LOG_LUM_MIN), 0.0, 1.0)
    b = (ll * (NUM_BINS - 1)).to(torch.int64)  # truncation, as astype
    hist = torch.zeros(NUM_BINS, dtype=torch.float32,
                       device=lum_band.device).index_add_(
        0, b, torch.ones_like(ll))
    return mesh.all_reduce_sum(hist)


def make_tile_frame(mesh: RowMesh, scene_data_builder, width: int,
                    height: int, denoise_params: DenoiseParams,
                    use_packets: bool = False):
    """The rank's frame step of the reduced pipeline.

    scene_data_builder: callable (vertices) -> render.integrator.SceneData,
      called every frame on every rank (the scene replicates).
    Returns fn(vertices, camera, prev_camera, hist_color, frame_idx) ->
      (the band's (Hs, W, 3) u8 image, its new (Hs, W, 3) history), with
      hist_color the band's history and Hs = height / ranks."""
    if height % mesh.world:
        raise ValueError(f"height={height} must divide over {mesh.world} "
                         "row bands")
    hs = height // mesh.world
    dev = mesh.device

    def frame(vertices, camera, prev_camera, hist_color, frame_idx: int):
        scene = scene_data_builder(vertices)
        row0 = mesh.rank * hs
        basis = camera_basis(camera)
        aspect = width / height

        # raygen for the band's pixel rows (global uv coordinates)
        ys = (torch.arange(hs, dtype=torch.float32, device=dev)[:, None]
              + row0)
        xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        pix_ids = (ys.to(torch.int32) * width
                   + xs.to(torch.int32)).reshape(-1)
        jitter = rand2(pix_ids, frame_idx, 0)
        uv = torch.stack([xs.expand(hs, width).reshape(-1),
                          ys.expand(hs, width).reshape(-1)], dim=-1)
        uv = (uv + jitter) / torch.tensor([width, height],
                                          dtype=torch.float32, device=dev)
        d = pixel_to_dir(basis, uv, aspect)
        rays = Rays(basis.pos.expand(d.shape).contiguous(), d, uv,
                    torch.full(d.shape[:-1], 1.0, device=dev)
                    * (2.0 * basis.tan_half_fov_y / height))

        gbuf = path_trace(scene, rays, pix_ids, frame_idx,
                          camera_basis(prev_camera), aspect,
                          use_packets=use_packets)
        color = (gbuf.color * gbuf.albedo).reshape(hs, width, 3)
        normal = gbuf.normal.reshape(hs, width, 3)
        depth = gbuf.depth.reshape(hs, width)
        mat_id = gbuf.mat_id.reshape(hs, width)

        # temporal blend against the band's history (static camera terms)
        color = color * 0.2 + hist_color * (1.0 - 0.2)
        new_hist = color

        # the 7x7 pass on the band and its halo, cropped
        halo = 4
        c_h, n_h, d_h, m_h = (_halo_exchange(x, halo, mesh)
                              for x in (color, normal, depth, mat_id))
        noise8 = tile_noise_level(c_h, d_h, 8)
        color = spatial_filter_7x7(c_h, n_h, d_h, m_h, noise8,
                                   denoise_params)[halo:-halo]

        # the whole image's exposure (all-reduced histogram)
        lum = torch.sum(color * torch.tensor([0.2126, 0.7152, 0.0722],
                                             device=dev), dim=-1)
        hist = _global_histogram(lum, mesh)
        total = torch.clamp(torch.sum(hist), min=1.0)
        cdf = torch.cumsum(hist, 0) / total
        centers = LOG_LUM_MIN + (torch.arange(NUM_BINS, device=dev) + 0.5) \
            / NUM_BINS * (LOG_LUM_MAX - LOG_LUM_MIN)
        prev = cdf - hist / total
        clipped = torch.clamp(torch.clamp(cdf, max=0.9)
                              - torch.clamp(prev, min=0.4), min=0.0)
        mean_ll = torch.sum(clipped * centers) / torch.clamp(
            torch.sum(clipped), min=1e-6)
        avg_lum = 2.0 ** mean_ll
        ev = exposure_compensation(avg_lum) / torch.clamp(avg_lum, min=1e-6)

        ldr = tonemap(color * ev, 1.0, 2.2)
        u8 = torch.clamp(ldr * 255.0 + 0.5, 0, 255).to(torch.uint8)
        return u8, new_hist

    return frame
