"""One frame of the static-scene product path (port of the static branch of
rtrt_tpu/engine/frame.py::render_frame with prebuilt SAH tables, the
megakernel and no interlace):

  raygen (blue-noise jitter + thin lens) -> path_trace_mega (K2, with K1's
  traversal inside) -> finish_gbuffer -> SVGF denoise (K5 history
  reprojection, K4 a-trous passes; or color * albedo with the denoiser
  off) -> sun screen position and visibility -> postprocess (exposure
  pyramid, bloom, lens flare, the fused tail K3) -> uint8.

The port runs eagerly: each frame is a sequence of torch ops and kernel
launches (K2, K5, four K4, K3 with the default flags), with every tensor
on the scene's device and no host sync.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import Camera, camera_basis, world_to_screen
from ..denoise.pipeline import DenoiseHistory, denoise
from ..post.pipeline import dither_mask, postprocess
from ..render.integrator import GBuffer, SceneData
from ..render.megakernel import path_trace_mega
from ..render.raygen import generate_rays_padded
from ..render.sampling import blue_offsets_flat, rand2, rand2_bn
from ..utils.config import FeatureFlags, RenderParams


@dataclasses.dataclass
class FrameState:
    """State carried from frame to frame."""

    exposure: torch.Tensor  # (4,) auto-exposure state (on the device)
    history: DenoiseHistory = None  # denoiser history (flags.denoise)
    frame_idx: int = 0      # uint32 frame counter
    time: float = 0.0       # accumulated time (s)


@dataclasses.dataclass(frozen=True)
class FrameStatic:
    """Static frame configuration."""

    render_w: int
    render_h: int
    screen_w: int
    screen_h: int
    flags: FeatureFlags


@dataclasses.dataclass
class FrameConsts:
    """Per-resolution constant tensors, built once (make_frame_consts)."""

    pixel_ids: torch.Tensor   # (h, w) int32
    bn: torch.Tensor          # (h, w, 2) blue-noise offsets, or None
    mask: torch.Tensor        # (64, 64) dither mask


def check_flags(flags: FeatureFlags):
    """Raise NotImplementedError for a flag whose pass is not ported."""
    for name in ("ocean", "stars", "fourier_textures"):
        if getattr(flags, name):
            raise NotImplementedError(
                f"FeatureFlags.{name}=True is not ported to rtrt_tpu_torch "
                f"yet (see ROADMAP.md); set {name}=False")


def make_frame_consts(static: FrameStatic, device) -> FrameConsts:
    w, h = static.render_w, static.render_h
    ys = torch.arange(h, dtype=torch.int32, device=device)
    xs = torch.arange(w, dtype=torch.int32, device=device)
    pixel_ids = ys[:, None] * w + xs[None, :]
    bn = None
    if static.flags.blue_noise:
        bn = torch.from_numpy(blue_offsets_flat(w, h, w * h).reshape(
            h, w, 2)).to(device)
    return FrameConsts(pixel_ids, bn, dither_mask(device))


def render_frame(static: FrameStatic, scene: SceneData, state: FrameState,
                 camera: Camera, prev_camera: Camera, params: RenderParams,
                 dt: float, consts: FrameConsts = None, overflow=None,
                 stack_depth=None):
    """One full frame.  Returns (u8 image (screen_h, screen_w, 3),
    new FrameState, GBuffer).  overflow: optional (1,) int32 counter of
    dropped traversal-stack pushes; stack_depth: optional (1,) int32
    counter raised to the deepest traversal stack."""
    check_flags(static.flags)
    w, h = static.render_w, static.render_h
    dev = scene.tables.nodes.device
    if consts is None:
        consts = make_frame_consts(static, dev)
    frame = state.frame_idx

    cam = dataclasses.replace(
        camera, aperture=torch.full((), params.sample.aperture, device=dev),
        focal_dist=torch.full((), params.sample.focal_dist, device=dev))
    basis = camera_basis(cam)
    prev_basis = camera_basis(prev_camera)
    if consts.bn is not None:
        jitter = rand2_bn(consts.bn, frame, 0)
        lens = rand2_bn(consts.bn, frame, 256)
    else:
        jitter = rand2(consts.pixel_ids, frame, 0)
        lens = rand2(consts.pixel_ids, frame, 256)
    rays = generate_rays_padded(basis, w, h, consts.pixel_ids, jitter, lens)

    gbuf: GBuffer = path_trace_mega(
        scene, rays, consts.pixel_ids, frame, prev_basis, w / h,
        use_proctex=static.flags.procedural_textures, bn=consts.bn,
        overflow=overflow, stack_depth=stack_depth)

    if static.flags.denoise:
        if state.history is None:
            raise ValueError("FeatureFlags.denoise needs FrameState.history "
                             "(denoise.pipeline.init_history)")
        final, new_history = denoise(
            gbuf.color, gbuf.albedo, gbuf.normal, gbuf.depth, gbuf.mat_id,
            gbuf.motion, state.history, params.denoise, static.flags,
            frame_parity=frame & 1)
    else:
        final = gbuf.color * gbuf.albedo
        new_history = state.history

    # sun screen position; visible where the depth at its pixel is sky
    # (read on the device: no host sync)
    sun_uv, sun_z = world_to_screen(basis, basis.pos + scene.sky.sun_dir
                                    * 1e4, w / h)
    sx = torch.clamp(torch.clamp(sun_uv[0] * w, -1.0, float(w)).to(
        torch.int64), 0, w - 1)
    sy = torch.clamp(torch.clamp(sun_uv[1] * h, -1.0, float(h)).to(
        torch.int64), 0, h - 1)
    d_sun = gbuf.depth.reshape(-1).index_select(0, (sy * w + sx).reshape(1))
    sun_visible = ((sun_z > 0) & ~torch.isfinite(d_sun[0])).to(torch.float32)

    sw, sh = static.screen_w, static.screen_h
    if static.flags.postprocess:
        image, new_exposure = postprocess(
            final, state.exposure, dt, sun_uv, sun_visible, params.post,
            static.flags, sh, sw, frame, mask=consts.mask)
    else:
        if (sh, sw) != (h, w):
            raise NotImplementedError(
                "output upscale is not ported yet (see ROADMAP.md)")
        ldr = torch.clamp(final, 0.0, 1.0) ** (1.0 / 2.2)
        image = (ldr * 255.0 + 0.5).to(torch.uint8)
        new_exposure = state.exposure

    new_state = FrameState(exposure=new_exposure, history=new_history,
                           frame_idx=(frame + 1) & 0xFFFFFFFF,
                           time=state.time + dt)
    return image, new_state, gbuf
