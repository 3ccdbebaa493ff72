"""Engine: the public host runtime of the port (port of the static-scene
part of rtrt_tpu/engine/engine.py).

`Engine(settings, flags, device="cuda").render_frame()` builds the scene,
its SAH/BVH4 tables and the sky once, then renders frames through
engine/frame.py::render_frame.  The device is explicit: with
``device="cuda"`` and no card it raises; it never falls back to the CPU.
One fixed resolution bucket: the frame renders at the settings' own size.

With the default FeatureFlags() a frame is denoised (K5, K4), bloomed,
lens-flared and tone-mapped (K3).  Settings whose pass is not ported raise
NotImplementedError naming the setting (ROADMAP.md lists the queue):
interlace, dynamic_resolution.enabled, animation != "none", ocean, stars,
fourier_textures, sky_model="preetham", load_camera_at_init.
"""

from __future__ import annotations

import math
import time

import torch

from ..bvh.packet import overflow_counter, pack_tables
from ..bvh.sah import build_scene_tables_sah, bvh4_nodes
from ..core.camera import make_camera
from ..denoise.pipeline import init_history
from ..post.exposure import init_exposure_state
from ..render.integrator import SceneData
from ..render.sky import (bake_sky_maps, finalize_sky_maps, make_sky_params,
                          sun_direction_from_time)
from ..utils.config import (FeatureFlags, GlobalSettings, RenderParams,
                            default_params)
from .frame import (FrameState, FrameStatic, check_flags, make_frame_consts,
                    render_frame)
from .scene import (HostScene, build_demo_scene, build_mesh_scene,
                    build_terrain_scene, padded_arrays)

SAH_LEAF = 8  # row-aligned leaf width of the static SAH tree


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to rtrt_tpu_torch yet (see ROADMAP.md)")


class Engine:
    """Public API: `Engine(settings, flags, device="cuda").render_frame()
    -> (H, W, 3) uint8`."""

    def __init__(self, settings: GlobalSettings | None = None,
                 flags: FeatureFlags | None = None,
                 scene: HostScene | None = None,
                 params: RenderParams | None = None,
                 animation: str = "none", device="cuda"):
        self.settings = settings or GlobalSettings()
        self.flags = flags or FeatureFlags()
        self.params = params or default_params()
        s = self.settings
        check_flags(self.flags)
        if s.interlace:
            _unsupported("GlobalSettings.interlace=True")
        if s.dynamic_resolution.enabled:
            _unsupported("GlobalSettings.dynamic_resolution.enabled=True")
        if animation != "none":
            _unsupported(f"animation={animation!r}")
        if s.sky_model != "physical":
            _unsupported(f"sky_model={s.sky_model!r}")
        if s.load_camera_at_init:
            _unsupported("GlobalSettings.load_camera_at_init=True (camera "
                         "persistence)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device")
        self.init_seconds = {}

        t0 = time.perf_counter()
        if scene is not None:
            self.scene = scene
        elif s.scene == "terrain":
            self.scene = build_terrain_scene(s)
        elif s.scene == "demo":
            self.scene = build_demo_scene()
        elif s.scene.startswith("mesh:"):
            from ..content.meshio import load_mesh
            self.scene = build_mesh_scene(*load_mesh(s.scene[5:]))
        else:
            raise ValueError(f"unknown scene '{s.scene}'")
        self.init_seconds["scene"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        pad = padded_arrays(self.scene)
        bvh, nrm_t, mat_s = build_scene_tables_sah(
            self.scene.num_batches, pad["indices"], pad["tri_mat"],
            pad["valid"], self.scene.vertices, self.scene.normals,
            leaf_max=SAH_LEAF)
        tables = pack_tables(bvh, nrm_t, mat_s, bvh4_nodes(bvh)).to(
            self.device)
        self.init_seconds["sah"] = time.perf_counter() - t0
        lights = self.scene.lights
        self.scene_data = SceneData(
            tables=tables, materials=self.scene.materials.to(self.device),
            sky=None,
            lights=None if lights is None else lights.to(self.device))

        t0 = time.perf_counter()
        self._sky_key = None
        self._maybe_regen_sky()
        self.init_seconds["sky"] = time.perf_counter() - t0

        self.camera = make_camera(pos=(0.0, 8.0, -18.0), yaw=0.0,
                                  pitch=-0.25, fov_y=1.1, device=self.device)
        self.prev_camera = self.camera
        history = None
        if self.flags.denoise:
            history = init_history(s.render_height, s.render_width,
                                   half=self.flags.half_history,
                                   device=self.device)
        self.state = FrameState(exposure=init_exposure_state(self.device),
                                history=history)
        self.static = FrameStatic(render_w=s.render_width,
                                  render_h=s.render_height,
                                  screen_w=s.render_width,
                                  screen_h=s.render_height, flags=self.flags)
        self.consts = make_frame_consts(self.static, self.device)
        self.overflow = overflow_counter(self.device)
        self.last_gbuffer = None
        self._last_time = None

    def _maybe_regen_sky(self):
        """Re-bake the sky when its parameters changed."""
        sp = self.params.sky
        key = (sp.time_of_day, sp.sun_axis_angle, sp.sun_intensity,
               sp.rayleigh, sp.mie, sp.mie_g)
        if key == self._sky_key:
            return
        self._sky_key = key
        sun = sun_direction_from_time(sp.time_of_day, sp.sun_axis_angle)
        elev = math.asin(max(-1.0, min(1.0, float(sun[1]))))
        azim = math.atan2(float(sun[0]), float(sun[2]))
        sky_params = make_sky_params(
            sun_elevation=elev, sun_azimuth=azim,
            sun_intensity=sp.sun_intensity, rayleigh_scale=sp.rayleigh,
            mie_scale=sp.mie, mie_g=sp.mie_g, device=self.device)
        self.scene_data.sky = finalize_sky_maps(bake_sky_maps(sky_params))

    def render_frame_device(self, dt: float | None = None) -> torch.Tensor:
        """Render one frame; returns the (H, W, 3) uint8 image on the device
        (enqueued, not synchronised)."""
        now = time.perf_counter()
        if dt is None:
            dt = 1.0 / 60.0 if self._last_time is None \
                else now - self._last_time
        self._last_time = now
        self._maybe_regen_sky()
        image, self.state, self.last_gbuffer = render_frame(
            self.static, self.scene_data, self.state, self.camera,
            self.prev_camera, self.params, max(dt, 1e-4), self.consts,
            self.overflow)
        self.prev_camera = self.camera
        return image

    def render_frame(self, dt: float | None = None):
        """Render one frame; returns the (H, W, 3) uint8 image as numpy."""
        return self.render_frame_device(dt).cpu().numpy()
