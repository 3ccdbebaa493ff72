# Frozen copy of rtrt_tpu_torch/engine/frame.py
# (framebench's plain reference), cut to what framebench's frames reach.
"""One frame of the product path (port of rtrt_tpu/engine/frame.py::
render_frame), as framebench's cells render it: at the screen size, every
row traced, the default FeatureFlags():

  [the rebuild stage] -> raygen (blue-noise jitter + thin lens) ->
  path_trace_mega (K2's plain twin) -> finish_gbuffer -> SVGF denoise (K5
  history reprojection, K4 a-trous passes) -> sun screen position and
  visibility -> postprocess (exposure pyramid, bloom, lens flare, the
  tail K3) -> uint8.

Animation (render_frame's `rest`, a MeshPose): before raygen the frame
displaces the rest mesh's vertices by the travelling wave at the clock,
FrameState.time (float32, `advance_clock`), recomputes its smooth normals,
rebuilds the two-level LBVH (bvh/build.py) and repacks the binary tables
in place (`rebuild_tables`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bvh.build import build_scene_bvh
from ..bvh.packet import write_tables_binary
from ..bvh.types import BATCH_SIZE
from ..core.camera import Camera, camera_basis, world_to_screen
from ..denoise.pipeline import DenoiseHistory, denoise
from ..ops.gather import onehot_permute
from ..ops.reduce import segment_sum
from ..post.pipeline import dither_mask, postprocess
from ..render.megakernel import GBuffer, SceneData, path_trace_mega
from ..render.raygen import generate_rays_padded
from ..render.sampling import blue_offsets_flat, rand2_bn
from ..utils.config import FeatureFlags, RenderParams


@dataclasses.dataclass
class FrameState:
    """State carried from frame to frame."""

    exposure: torch.Tensor  # (4,) auto-exposure state (on the device)
    history: DenoiseHistory  # denoiser history
    frame_idx: int = 0      # uint32 frame counter
    time: float = 0.0       # accumulated time (s): a float32 value


@dataclasses.dataclass(frozen=True)
class FrameStatic:
    """Static frame configuration: the render (= screen) size and flags."""

    render_w: int
    render_h: int
    flags: FeatureFlags


@dataclasses.dataclass
class FrameConsts:
    """Per-resolution constant tensors, built once (make_frame_consts)."""

    pixel_ids: torch.Tensor   # (h, w) int32
    bn: torch.Tensor          # (h, w, 2) blue-noise offsets
    mask: torch.Tensor        # (64, 64) dither mask


@dataclasses.dataclass
class MeshPose:
    """The animated scene's rest mesh (on the device), whose frames rebuild
    the two-level LBVH: the vertices (V, 3), the padded triangle indices
    (B * 1024, 3), materials (B * 1024,) and valid mask (B, 1024).  The
    normals are recomputed from the displaced vertices every frame."""

    vertices: torch.Tensor
    indices: torch.Tensor
    tri_mat: torch.Tensor
    valid: torch.Tensor


# the travelling wave of animation="wave": y += WAVE_AMP * sin(WAVE_FREQ x +
# WAVE_SPEED t) * cos(0.8 WAVE_FREQ z + 1.1 t)
WAVE_AMP = 0.35
WAVE_FREQ = 0.5
WAVE_SPEED = 1.5


def advance_clock(time: float, dt: float) -> float:
    """The animation clock after a frame of dt seconds, accumulated in
    float32 as the JAX frame's jnp.float32 clock is."""
    return float(np.float32(time) + np.float32(dt))


def _f32(x):
    """A Python float rounded to float32: scalars that the JAX frame forms
    in float32 (the clock times a constant) enter torch ops exactly."""
    return float(np.float32(x))


def _wave_dy(x, z, time: float):
    """The wave's displacement along y at (x, z), in the JAX function's
    order of operations."""
    t = np.float32(time)
    return WAVE_AMP * torch.sin(x * WAVE_FREQ
                                + _f32(t * np.float32(WAVE_SPEED))) \
        * torch.cos(z * (WAVE_FREQ * 0.8) + _f32(t * np.float32(1.1)))


def displace_wave(vertices, time: float):
    """Travelling wave along y applied to (V, 3) vertices (the rebuild
    branch's form)."""
    out = vertices.clone()
    out[:, 1] += _wave_dy(vertices[:, 0], vertices[:, 2], time)
    return out


def displace_wave(vertices, time: float):
    """Travelling wave along y applied to (V, 3) vertices."""
    out = vertices.clone()
    out[:, 1] += _wave_dy(vertices[:, 0], vertices[:, 2], time)
    return out


def compute_smooth_normals(vertices, indices):
    """Area-weighted vertex normals: each triangle's cross product summed
    into its three vertices (segment sums, the JAX function's order), then
    normalised.  indices (T, 3) with padding triangles (0, 0, 0), whose
    cross product is 0."""
    v0, v1, v2 = (vertices[indices[:, k]] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    nv = vertices.shape[0]
    acc = (segment_sum(fn, indices[:, 0], nv)
           + segment_sum(fn, indices[:, 1], nv)
           + segment_sum(fn, indices[:, 2], nv))
    norm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp(norm, min=1e-12)


def build_scene_tables(num_batches: int, indices, tri_mat, valid, verts,
                       nrm):
    """Two-level LBVH of the padded scene + its sorted per-triangle
    attributes: returns (bvh, tri_nrm_t (9, P) f32, sorted_mat (P,) i32),
    on the device of `verts`.  indices (B * 1024, 3), tri_mat (B * 1024,),
    valid (B, 1024), verts / nrm (V, 3)."""
    b = num_batches
    indices = indices.to(torch.int64)
    tv = [verts[indices[:, k]].reshape(b, BATCH_SIZE, 3) for k in range(3)]
    bvh = build_scene_bvh(*tv, valid)
    # the batch-local permutation of the indices and materials
    reorder = bvh.sorted_tri_index.reshape(b, BATCH_SIZE).to(torch.int64) \
        - (torch.arange(b, device=verts.device) * BATCH_SIZE)[:, None]
    perm = onehot_permute(torch.cat(
        [indices.reshape(b, BATCH_SIZE, 3),
         tri_mat.to(torch.int64).reshape(b, BATCH_SIZE, 1)], -1), reorder)
    flat_idx = perm[..., 0:3].reshape(-1, 3)
    tri_nrm_t = torch.cat([nrm[flat_idx[:, k]].T for k in range(3)], 0)
    return bvh, tri_nrm_t, perm[..., 3].reshape(-1).to(torch.int32)


def rebuild_tables(tables, mesh: MeshPose, time: float):
    """The rebuild stage of a frame: displace the rest mesh at `time`,
    recompute its smooth normals, rebuild the two-level LBVH and write the
    frame's binary tables into `tables` in place."""
    verts = displace_wave(mesh.vertices, time)
    nrm = compute_smooth_normals(verts, mesh.indices)
    write_tables_binary(tables, *build_scene_tables(
        mesh.valid.shape[0], mesh.indices, mesh.tri_mat, mesh.valid, verts,
        nrm))


def make_frame_consts(static: FrameStatic, device) -> FrameConsts:
    """The frame's constants."""
    w, h = static.render_w, static.render_h
    ys = torch.arange(h, dtype=torch.int32, device=device)
    xs = torch.arange(w, dtype=torch.int32, device=device)
    pixel_ids = ys[:, None] * w + xs[None, :]
    bn = torch.from_numpy(blue_offsets_flat(w, h, w * h).reshape(
        h, w, 2)).to(device)
    return FrameConsts(pixel_ids, bn, dither_mask(device))


def render_frame(static: FrameStatic, scene: SceneData, state: FrameState,
                 camera: Camera, prev_camera: Camera, params: RenderParams,
                 dt: float, consts: FrameConsts, rest: MeshPose = None):
    """One full frame.  Returns (u8 image (h, w, 3), new FrameState,
    GBuffer).  rest: the rest mesh of a scene animated by the travelling
    wave, whose frame rebuilds scene.tables in place (None: a static
    scene)."""
    w, h = static.render_w, static.render_h
    dev = scene.tables.nodes.device
    if rest is not None:
        rebuild_tables(scene.tables, rest, state.time)
    frame = state.frame_idx
    pixel_ids, bn = consts.pixel_ids, consts.bn

    cam = dataclasses.replace(
        camera, aperture=torch.full((), params.sample.aperture, device=dev),
        focal_dist=torch.full((), params.sample.focal_dist, device=dev))
    basis = camera_basis(cam)
    prev_basis = camera_basis(prev_camera)
    jitter = rand2_bn(bn, frame, 0)
    lens = rand2_bn(bn, frame, 256)
    rays = generate_rays_padded(basis, w, h, pixel_ids, jitter, lens)
    gbuf: GBuffer = path_trace_mega(scene, rays, pixel_ids, frame,
                                    prev_basis, w / h, bn)
    if state.history is None:
        raise ValueError("the denoiser needs FrameState.history "
                         "(denoise.pipeline.init_history)")
    final, new_history = denoise(
        gbuf.color, gbuf.albedo, gbuf.normal, gbuf.depth, gbuf.mat_id,
        gbuf.motion, state.history, params.denoise, frame_parity=frame & 1)

    # sun screen position; visible where the depth at its pixel is sky
    sun_uv, sun_z = world_to_screen(basis, basis.pos + scene.sky.sun_dir
                                    * 1e4, w / h)
    sx = torch.clamp(torch.clamp(sun_uv[0] * w, -1.0, float(w)).to(
        torch.int64), 0, w - 1)
    sy = torch.clamp(torch.clamp(sun_uv[1] * h, -1.0, float(h)).to(
        torch.int64), 0, h - 1)
    d_sun = gbuf.depth.reshape(-1).index_select(0, (sy * w + sx).reshape(1))
    sun_visible = ((sun_z > 0) & ~torch.isfinite(d_sun[0])).to(torch.float32)

    image, new_exposure = postprocess(
        final, state.exposure, dt, sun_uv, sun_visible, params.post,
        static.flags, frame, consts.mask)
    new_state = FrameState(exposure=new_exposure, history=new_history,
                           frame_idx=(frame + 1) & 0xFFFFFFFF,
                           time=advance_clock(state.time, dt))
    return image, new_state, gbuf
