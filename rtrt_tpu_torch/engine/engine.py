"""Engine: the public host runtime of the port — init, per-frame rendering,
resolution buckets and the dynamic-resolution controller, camera input and
persistence (port of the static-scene part of rtrt_tpu/engine/engine.py).

`Engine(settings, flags, device="cuda").render_frame()` builds the scene,
its BVH tables and the sky once, then renders frames through
engine/frame.py::render_frame.  ``bvh`` picks the tree: "sah4" (the
default) the host-built SAH tree collapsed to a BVH4, "lbvh" the two-level
LBVH built on the device (bvh/build.py) and traced by K1 / K2's binary
instantiation, "sah2" the host-built flat binary SAH tree with 8-slot leaf
rows, traced by their binary leaf-row instantiation.  "sah2" is there for
parity with the JAX Engine's RTRT_SAH=2 and is never the faster choice:
on the 1080p terrain its K2 is slower than the BVH4's (PERF.md §6), with
the same images within bounds.  The device is
explicit: with ``device="cuda"`` and no card it raises; it never falls
back to the CPU.

Resolution buckets, as in the JAX Engine: a frame renders at the 16:9
bucket of its height (`_BUCKET_HEIGHTS`; the first bucket at or above
``settings.render_height``) and its image comes out at the settings' size
(`render_w` x `render_h` -> ``render_width`` x ``render_height``, by the
Catmull-Rom upscale where they differ).  With dynamic resolution on, the
controller moves one bucket down or up after each frame from that frame's
dt; a switch resets the denoiser history to the new size.

With the default FeatureFlags() a frame is denoised (K5, K4), bloomed,
lens-flared and tone-mapped (K3); FeatureFlags(ocean=True, stars=True)
add the ocean and the star field to the environment of escaped rays.
Every FeatureFlags combination of the JAX Engine renders: with
temporal_filter off, the second temporal pass fetches its history through
the ±1 px shift stencil (denoise/temporal.py), as the JAX frame does.
RTRT_HISTORY_FILTER=bilinear switches K5 to its bilinear instantiation
(denoise/reproject.py), and RTRT_DEBUG=1 turns on the frame's NaN guards
(utils/debug.py).
``animation="wave"`` animates the scene with a travelling wave: with
"sah4" the tables' topology is frozen at init and every frame refits its
boxes (engine/frame.py::animate_tables, bvh/refit.py); with "lbvh" every
frame displaces the vertices, recomputes the smooth normals and rebuilds
the LBVH (engine/frame.py::rebuild_tables); "sah2" has no animated form.
In the JAX Engine these are its default on a TPU (RTRT_SAH=4,
RTRT_REFIT=1), its static scene with RTRT_SAH=0 or RTRT_SAH=2 (the flat
tree), and its animated scene with RTRT_REFIT=0 or off a TPU.
FeatureFlags(fourier_textures=True) fits the soil texture set
(render/texture.py, sized by ``settings.texture_size``) to its Fourier
series at init (render/ftex.py), and K2 shades textured materials from the
fit; ``settings.sky_model`` picks the physical or the Preetham sky
(render/sky.py::SKY_MODELS; another value raises ValueError at init).
Another animation than "none" or "wave" raises NotImplementedError
(ROADMAP.md lists what is not ported).

``trace`` picks the path tracer (`TRACE_ROUTES`): "megakernel" (the
default) traces a frame in one K2 launch; "packets" runs the wavefront
integrator (render/integrator.py::path_trace) with K1 launched once a
bounce segment on the same tables (the JAX Engine's RTRT_MEGAKERNEL=0 on a
TPU); "loop" runs the wavefront with the loop traverser (bvh/traverse.py),
plain torch on the Engine's device, over the tables' SceneBvh (the JAX
Engine's route off a TPU).  "loop" traverses the static tree, so it takes
no animation.  The wavefront routes shade textured materials with the
procedural soil, or with procedural_textures off with the soil texture set
of ``settings.texture_size`` (built at init), never with a Fourier fit
(fourier_textures fits only for the megakernel).

On a CUDA device `render_frame_device` replays the frame as a CUDA graph,
one a (resolution bucket, frame parity): the parity picks the interlaced
field and the denoiser's alternating half kernel.  A key's first frame
runs the frame once eagerly (its results dropped: K2's occupancy query,
the allocator's sizes, the constants of utils/consts.py), captures it into
a graph of a pool shared by the graphs, and replays it; later frames of
the key only replay it.  What changes from frame to frame goes to the
device first: the frame index, clock products, dt and both cameras in
FrameUniforms (engine/frame.py), written by one copy from a ring of
pinned slots; the Engine's state in the bucket's graph inputs, the
exposure state and history planes that every graph of the bucket reads
and writes its new ones into (copied there on the device where the state
holds other tensors: after the eager first frame, load_state or a state
set from outside).  So `state`, `last_gbuffer` and the image are the
graphs' tensors, which their next replays overwrite.  The parameters, the
sky, the rest pose and the module switches read at each call
(RTRT_SEGMENTS, RTRT_HISTORY_FILTER) are baked into the graphs: a change
of them captures anew, into a new pool.  The first frame of a history
(not valid yet), the CPU, the wavefront routes (their samples hash the
frame index per ray), ocean or stars (their clock is a host float),
RTRT_DEBUG's NaN guards (host reads) and a cut frame run eagerly; a
capture that raises leaves its key eager, the reason in
`graph_failures`.  `graph_counts` counts the frames replayed, the graphs
captured and the frames run eagerly by reason.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..bvh.packet import (overflow_counter, pack_tables, pack_tables_binary,
                          pack_tables_sah2)
from ..bvh.refit import DeviceRefit, plan_refit4
from ..bvh.sah import build_scene_tables_sah, bvh4_nodes
from ..core.camera import Camera
from ..denoise import reproject
from ..denoise.pipeline import DenoiseHistory, init_history
from ..post.exposure import init_exposure_state
from ..render import integrator
from ..render.ftex import fit_soil_fourier, upload_ftex
from ..render.integrator import GBuffer, SceneData
from ..render.sky import (SKY_MODELS, bake_sky_maps, finalize_sky_maps,
                          make_sky_params, sun_direction_from_time)
from ..render.texture import make_soil_textures
from ..utils import cuda, debug
from ..utils.config import (FeatureFlags, GlobalSettings, RenderParams,
                            default_params)
from ..utils.timer import FpsLog, Timer
from .frame import (U_CAMERA, U_PREV_CAMERA, U_WORDS, FrameState,
                    FrameStatic, FrameUniforms, MeshPose, RestPose,
                    advance_clock, build_scene_tables, make_frame_consts,
                    render_frame, uniform_words)
from .scene import (HostScene, build_demo_scene, build_mesh_scene,
                    build_terrain_scene, padded_arrays)

SAH_LEAF = 8  # row-aligned leaf width of the static SAH trees
BVH_KINDS = ("sah4", "lbvh", "sah2")
# trace route -> (FrameStatic.use_megakernel, .use_packets)
TRACE_ROUTES = {"megakernel": (True, True), "packets": (False, True),
                "loop": (False, False)}

_BUCKET_HEIGHTS = (270, 360, 540, 720, 1080, 1440, 2160)
# pinned slots of the per-frame uniforms: a slot is written again only
# after the copy that last read it has run, so the host runs at most this
# many frames ahead of the card
UNIFORM_SLOTS = 4
# the history planes that a replayed frame reads and writes back
_HISTORY_PLANES = tuple(f for f in DenoiseHistory._fields if f != "valid")


def _bucket_for(height: int):
    for h in _BUCKET_HEIGHTS:
        if h >= height:
            return h
    return _BUCKET_HEIGHTS[-1]


def interlace_for(settings_interlace: bool, h: int) -> bool:
    """Whether a bucket of height h interlaces: RTRT_INTERLACE=1 / 0 over
    GlobalSettings.interlace, and only at an even height, as the JAX
    Engine decides (rtrt_tpu/engine/engine.py:353-359)."""
    env = os.environ.get("RTRT_INTERLACE",
                         "1" if settings_interlace else "0")
    return env == "1" and h % 2 == 0


def _res_for_height(h: int):
    """16:9, width snapped to a multiple of 16 (reference: kernel.cu:96-98)."""
    w = (h * 16 // 9) // 16 * 16
    return w, h


class _FrameGraph(NamedTuple):
    """A captured frame, the outputs its replays write and the kernel
    launches each replay makes (utils/cuda.py::launch_counts keys)."""

    graph: torch.cuda.CUDAGraph
    image: torch.Tensor
    gbuffer: GBuffer
    launches: dict


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to rtrt_tpu_torch yet (see ROADMAP.md)")


class Engine:
    """Public API: `Engine(settings, flags, device="cuda").render_frame()
    -> (H, W, 3) uint8`."""

    MOVE_SPEED = 8.0
    LOOK_SPEED = 0.003

    def __init__(self, settings: GlobalSettings | None = None,
                 flags: FeatureFlags | None = None,
                 scene: HostScene | None = None,
                 params: RenderParams | None = None,
                 animation: str = "none", bvh: str = "sah4",
                 trace: str = "megakernel", device="cuda"):
        self.settings = settings or GlobalSettings()
        self.flags = flags or FeatureFlags()
        self.params = params or default_params()
        s = self.settings
        if animation not in ("none", "wave"):
            _unsupported(f"animation={animation!r}")
        if bvh not in BVH_KINDS:
            raise ValueError(f"bvh={bvh!r}: expected one of {BVH_KINDS}")
        if trace not in TRACE_ROUTES:
            raise ValueError(f"trace={trace!r}: expected one of "
                             f"{tuple(TRACE_ROUTES)}")
        if trace == "loop" and animation != "none":
            raise ValueError(
                f"trace='loop' with animation={animation!r}: the loop "
                "traverser walks the static SceneBvh; an animated scene "
                "takes trace='packets' or 'megakernel'")
        if s.sky_model not in SKY_MODELS:
            raise ValueError(f"settings.sky_model={s.sky_model!r}: expected "
                             f"one of {SKY_MODELS}")
        if bvh == "sah2" and animation != "none":
            raise ValueError(
                f"bvh='sah2' with animation={animation!r}: the flat SAH tree "
                "is built once on the host; an animated scene takes "
                "bvh='lbvh' (rebuilt every frame, as the JAX Engine does "
                "with RTRT_SAH=2) or 'sah4' (refitted)")
        self.bvh = bvh
        self.trace = trace
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
        self.rest = None
        # tree: the SceneBvh, sorted normals and materials that the tables
        # pack (the loop route's tables)
        if bvh == "sah4":
            tables, tree = self._sah4_tables(pad, animation)
        elif bvh == "sah2":
            tree = build_scene_tables_sah(
                self.scene.num_batches, pad["indices"], pad["tri_mat"],
                pad["valid"], self.scene.vertices, self.scene.normals,
                leaf_max=SAH_LEAF)
            tables = pack_tables_sah2(*tree).to(self.device)
        else:
            tables, tree = self._lbvh_tables(pad, animation)
        self.init_seconds[bvh] = time.perf_counter() - t0
        loop = {}
        if trace == "loop":
            loop = dict(bvh=tree[0].to(self.device),
                        tri_nrm_t=tree[1].to(self.device),
                        tri_mat=tree[2].to(self.device, torch.int32))

        # the Fourier fit of the soil texture set (host lstsq) and K2's
        # table of it on the device, once
        self.ftex = None
        if self.flags.fourier_textures and trace == "megakernel":
            t0 = time.perf_counter()
            self.ftex = upload_ftex(fit_soil_fourier(make_soil_textures(
                s.texture_size, device=self.device)), self.device)
            self.init_seconds["textures"] = time.perf_counter() - t0
        # the soil texture set of the wavefront's gather texturing
        textures = None
        if trace != "megakernel" and not self.flags.procedural_textures:
            textures = make_soil_textures(s.texture_size, device=self.device)
        lights = self.scene.lights
        self.scene_data = SceneData(
            tables=tables, materials=self.scene.materials.to(self.device),
            sky=None,
            lights=None if lights is None else lights.to(self.device),
            textures=textures, **loop)

        t0 = time.perf_counter()
        self._sky_key = None
        self._maybe_regen_sky()
        self.init_seconds["sky"] = time.perf_counter() - t0

        self._set_camera(pos=(0.0, 8.0, -18.0), yaw=0.0, pitch=-0.25,
                         fov_y=1.1, aperture=0.0, focal_dist=5.0)
        self.prev_camera = self.camera
        if s.load_camera_at_init and os.path.exists(s.camera_path):
            self.load_camera(s.camera_path)

        self.state = FrameState(exposure=init_exposure_state(self.device))
        # bucket height -> (FrameStatic, FrameConsts), built at the first
        # switch to it.  The JAX Engine also compiles the neighbouring
        # buckets' frame programs in the background; the port runs
        # eagerly and has nothing to compile ahead.
        self._frames = {}
        self._cur_bucket = None
        self.render_w = self.render_h = 0
        self._set_bucket(_bucket_for(s.render_height))

        self.overflow = overflow_counter(self.device)
        # the deepest traversal stack of any frame (entries)
        self.stack_depth = overflow_counter(self.device)
        # the traced G-buffer of the last frame (with interlace, the
        # field's h/2 rows; the frame denoises the reconstructed planes)
        self.last_gbuffer = None
        self.timer = Timer()
        self.fps_log = FpsLog()
        self._input = dict(keys=set(), last_cursor=None)
        # the frame as CUDA graphs (module docstring): graph_counts holds
        # the frames replayed, the graphs captured and the frames run
        # eagerly by reason; graph_failures, (bucket, parity) -> why that
        # key's capture failed
        self.graph_counts = dict(replayed=0, captured=0, eager={})
        self.graph_failures = {}
        self._graphs = {}       # (bucket, parity) -> _FrameGraph
        self._graph_env = None  # what the graphs baked in (_replay)
        self._graph_io = {}     # bucket -> FrameState the graphs read
        self._graph_pool = None
        self._uniforms = None   # FrameUniforms, its ring of pinned slots

    def _sah4_tables(self, pad, animation):
        """The SAH/BVH4 tables, built on the host, and the tree they
        collapse (SceneBvh, sorted normals, materials); an animated scene
        keeps the rest pose (the sorted (9, P) vertex rows and normals) and
        the frozen tree's refit schedule on the device."""
        bvh, nrm_t, mat_s = build_scene_tables_sah(
            self.scene.num_batches, pad["indices"], pad["tri_mat"],
            pad["valid"], self.scene.vertices, self.scene.normals,
            leaf_max=SAH_LEAF)
        raw4 = bvh4_nodes(bvh)
        if animation == "wave":
            self.rest = RestPose(
                tris_t=bvh.tris_t.to(self.device).contiguous(),
                nrm_t=nrm_t.to(self.device).contiguous(),
                refit=DeviceRefit(plan_refit4(raw4), self.device))
        return (pack_tables(bvh, nrm_t, mat_s, raw4).to(self.device),
                (bvh, nrm_t, mat_s))

    def _lbvh_tables(self, pad, animation):
        """The two-level LBVH's binary tables, built on the device, and the
        tree (SceneBvh, sorted normals, materials); an animated scene keeps
        its rest mesh there and rebuilds every frame."""
        mesh = self._mesh_pose(pad)
        if animation == "wave":
            self.rest = mesh
        tree = build_scene_tables(
            self.scene.num_batches, mesh.indices, mesh.tri_mat, mesh.valid,
            mesh.vertices,
            torch.from_numpy(self.scene.normals).to(self.device))
        return pack_tables_binary(*tree), tree

    def _mesh_pose(self, pad, normals=None) -> MeshPose:
        dev = self.device
        return MeshPose(
            vertices=torch.from_numpy(self.scene.vertices).to(dev),
            indices=torch.from_numpy(pad["indices"]).to(dev, torch.int64),
            tri_mat=torch.from_numpy(pad["tri_mat"]).to(dev, torch.int32),
            valid=torch.from_numpy(pad["valid"]).to(dev), normals=normals)

    def static_rebuild(self):
        """From the next frame on, rebuild the static scene's two-level
        LBVH in every frame (the JAX frame without the Engine's prebuilt
        tables, which profile_frame's --rebuild forces): `rest` becomes a
        MeshPose of the unmoved scene with its normals.  Needs
        bvh="lbvh" (the binary tables the rebuild writes) and a static
        scene."""
        if self.bvh != "lbvh" or self.rest is not None:
            raise ValueError("static_rebuild needs Engine(bvh='lbvh') with "
                             "animation='none'")
        self.rest = self._mesh_pose(
            padded_arrays(self.scene),
            normals=torch.from_numpy(self.scene.normals).to(self.device))

    # ------------------------------------------------------------------
    # resolution buckets / dynamic resolution
    # ------------------------------------------------------------------

    def _set_bucket(self, bucket_h: int):
        """Render at bucket `bucket_h` from the next frame on: its frame
        configuration and constants, and an empty history of its size
        (the exposure state carries over)."""
        if bucket_h == self._cur_bucket:
            return
        self._cur_bucket = bucket_h
        self.render_w, self.render_h = _res_for_height(bucket_h)
        if bucket_h not in self._frames:
            s = self.settings
            mega, packets = TRACE_ROUTES[self.trace]
            static = FrameStatic(render_w=self.render_w,
                                 render_h=self.render_h,
                                 screen_w=s.render_width,
                                 screen_h=s.render_height, flags=self.flags,
                                 interlace=interlace_for(
                                     s.interlace, self.render_h),
                                 ftex=self.ftex,
                                 use_megakernel=mega, use_packets=packets)
            self._frames[bucket_h] = (static,
                                      make_frame_consts(static, self.device))
        self.static, self.consts = self._frames[bucket_h]
        if self.flags.denoise:
            self.state = dataclasses.replace(self.state, history=init_history(
                self.render_h, self.render_w, half=self.flags.half_history,
                device=self.device))

    def _dynamic_resolution_step(self, frame_time: float):
        """Move one bucket to hold the target frame rate (reference
        controller: kernel.cu:78-114, here bucket-snapped)."""
        dr = self.settings.dynamic_resolution
        if not dr.enabled or frame_time <= 0.0:
            return
        fps = 1.0 / frame_time
        idx = _BUCKET_HEIGHTS.index(self._cur_bucket)
        if fps < dr.target_fps - dr.deadband_fps and idx > 0:
            self._set_bucket(_BUCKET_HEIGHTS[idx - 1])
        elif fps > dr.target_fps + dr.deadband_fps * 4 and \
                idx < len(_BUCKET_HEIGHTS) - 1:
            nh = _BUCKET_HEIGHTS[idx + 1]
            if nh <= self.settings.render_height:
                self._set_bucket(nh)

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
        self.scene_data.sky = finalize_sky_maps(bake_sky_maps(
            sky_params, model=self.settings.sky_model))

    # ------------------------------------------------------------------
    # per-frame
    # ------------------------------------------------------------------

    def render_frame_device(self, dt: float | None = None) -> torch.Tensor:
        """Render one frame; returns the (screen_h, screen_w, 3) uint8 image
        on the device (enqueued, not synchronised).  dt: the frame time in
        seconds; None takes the interval since the last call
        (`Timer.update`), which is also what the dynamic-resolution
        controller then sees.  A replayed frame's image is its graph's
        output, which the next replay of that graph (two frames on)
        overwrites."""
        if dt is None:
            dt = self.timer.update()
        self._update_camera_from_input(dt)
        self._maybe_regen_sky()
        why = self._eager_reason()
        image = None
        if why is None:
            image = self._replay(max(dt, 1e-4))
            why = None if image is not None else "capture_failed"
        if why is not None:
            eager = self.graph_counts["eager"]
            eager[why] = eager.get(why, 0) + 1
            image, self.state, self.last_gbuffer = render_frame(
                self.static, self.scene_data, self.state, self.camera,
                self.prev_camera, self.params, max(dt, 1e-4), self.consts,
                self.overflow, self.stack_depth, self.rest)
        self.prev_camera = self.camera
        self._dynamic_resolution_step(dt)
        self.fps_log.maybe_log(self.timer.fps, self.render_w, self.render_h,
                               self.graph_counts)
        return image

    def render_frame(self, dt: float | None = None):
        """Render one frame; returns the (H, W, 3) uint8 image as numpy."""
        return self.render_frame_device(dt).cpu().numpy()

    # ------------------------------------------------------------------
    # the frame as CUDA graphs
    # ------------------------------------------------------------------

    def _eager_reason(self) -> str | None:
        """Why this frame runs eagerly (its graph_counts["eager"] key), or
        None where it replays a graph."""
        if self.device.type != "cuda":
            return "cpu"
        if not self.static.use_megakernel:
            return "wavefront"  # its samples hash the frame index per ray
        if self.flags.ocean or self.flags.stars:
            return "environment_clock"  # a host float in the environment
        if debug.DEBUG:
            return "debug"  # the NaN guards read counts to the host
        if self.static.stop_after != "full":
            return "cut"
        history = self.state.history
        if history is not None and not history.valid:
            return "first_frame"
        return None

    def _replay(self, dt: float):
        """This frame by its (bucket, parity)'s graph, captured here at
        the key's first frame; returns the image, or None where the capture
        failed (the frame then runs eagerly)."""
        # what the graphs bake in: the parameters, the module switches
        # that the frame reads at each call (RTRT_SEGMENTS,
        # RTRT_HISTORY_FILTER), and the sky and rest pose, by identity
        env = (dataclasses.astuple(self.params), integrator.SEGMENTS,
               reproject.HISTORY_FILTER, self.scene_data.sky, self.rest)
        old = self._graph_env
        if old is None or env[:3] != old[:3] or \
                any(a is not b for a, b in zip(env[3:], old[3:])):
            # another of them: the new graphs go into a new pool (a pool
            # whose graphs are all gone takes no new capture while their
            # outputs live on)
            self._graphs.clear()
            self.graph_failures.clear()
            self._graph_pool = None
            self._graph_env = env
        st = self.state
        key = (self._cur_bucket, st.frame_idx & 1)
        if key in self.graph_failures:
            return None
        self._write_uniforms(st, dt)
        io = self._graph_inputs(st)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, st, io, dt)
            if entry is None:
                return None
        entry.graph.replay()
        self.graph_counts["replayed"] += 1
        for name, n in entry.launches.items():
            cuda.launch_counts[name] += n
        self.state = FrameState(exposure=io.exposure, history=io.history,
                                frame_idx=(st.frame_idx + 1) & 0xFFFFFFFF,
                                time=advance_clock(st.time, dt))
        self.last_gbuffer = entry.gbuffer
        return entry.image

    def _capture(self, key, st: FrameState, io: FrameState, dt: float):
        """Warm the frame up eagerly (its results dropped), then capture it
        into a graph of the shared pool that reads `io` and the uniforms and
        writes the new history and exposure back into `io`.  None where the
        capture raised: the key's frames then run eagerly, the reason in
        graph_failures."""
        u = self._uniforms
        state = dataclasses.replace(st, exposure=io.exposure,
                                    history=io.history)

        def frame(history_out):
            return render_frame(
                self.static, self.scene_data, state, u.camera,
                u.prev_camera, self.params, dt, self.consts, self.overflow,
                self.stack_depth, self.rest, uniforms=u,
                history_out=history_out)

        # launch_counts count the frames delivered: not the warm-up, whose
        # results are dropped, nor the capture, which runs nothing (each
        # replay adds its graph's launches)
        counts = dict(cuda.launch_counts)
        frame(None)
        cuda.launch_counts.update(counts)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: another thread's CUDA calls (a viewer's) do not
            # break the capture
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                image, new_state, gbuffer = frame(io.history)
                io.exposure.copy_(new_state.exposure)
        except Exception as e:  # any capture fault: the key runs eagerly
            self.graph_failures[key] = f"{type(e).__name__}: {e}"
            return None
        finally:
            launches = {k: n - counts[k]
                        for k, n in cuda.launch_counts.items()
                        if n != counts[k]}
            cuda.launch_counts.update(counts)
        entry = self._graphs[key] = _FrameGraph(graph, image, gbuffer,
                                                launches)
        self.graph_counts["captured"] += 1
        return entry

    def _graph_inputs(self, st: FrameState) -> FrameState:
        """The bucket's graph inputs: the exposure state and history planes
        its graphs read and write back, holding st's values (copied on the
        device from st's own tensors where those are others: the eager
        first frame's, or load_state's)."""
        io = self._graph_io.get(self._cur_bucket)
        hist = st.history
        if io is None:
            io = self._graph_io[self._cur_bucket] = FrameState(
                exposure=st.exposure.clone(),
                history=None if hist is None else hist._replace(
                    valid=True, **{f: getattr(hist, f).clone()
                                   for f in _HISTORY_PLANES}))
            return io
        pairs = [(io.exposure, st.exposure)]
        if hist is not None:
            pairs += [(getattr(io.history, f), getattr(hist, f))
                      for f in _HISTORY_PLANES]
        for dst, src in pairs:
            if dst is not src:
                dst.copy_(src)
        return io

    def _write_uniforms(self, st: FrameState, dt: float):
        """This frame's FrameUniforms, in one copy from a pinned slot; a
        camera known only on the device is copied there."""
        if self._uniforms is None:
            self._uniforms = FrameUniforms(torch.zeros(
                U_WORDS, dtype=torch.int32, device=self.device))
            self._slots = [
                (torch.zeros(U_WORDS, dtype=torch.int32).pin_memory(),
                 torch.cuda.Event()) for _ in range(UNIFORM_SLOTS)]
            self._slot = 0
        host, copied = self._slots[self._slot]
        self._slot = (self._slot + 1) % UNIFORM_SLOTS
        copied.synchronize()  # the copy that last read the slot has run
        host.numpy()[:] = uniform_words(st.frame_idx, self._cam_host,
                                        self._prev_cam_host, st.time, dt)
        words = self._uniforms.words
        words.copy_(host, non_blocking=True)
        copied.record()
        f = words.view(torch.float32)
        for k, cam, known in ((U_CAMERA, self.camera, self._cam_host),
                              (U_PREV_CAMERA, self.prev_camera,
                               self._prev_cam_host)):
            if known is None:
                f[k:k + 8].copy_(torch.cat([cam.pos.reshape(3)] + [
                    x.reshape(1) for x in (cam.yaw, cam.pitch, cam.fov_y,
                                           cam.aperture, cam.focal_dist)]))

    # ------------------------------------------------------------------
    # camera: the device tensors the frame reads, and a host copy of
    # their float32 values that input and persistence read and write
    # ------------------------------------------------------------------

    @property
    def camera(self) -> Camera:
        return self._camera

    @camera.setter
    def camera(self, cam: Camera):
        """A camera set from outside: its host copy is read from the device
        when input or persistence next needs it."""
        self._camera = cam
        self._cam_host = None

    @property
    def prev_camera(self) -> Camera:
        """The camera of the last frame (the motion vectors' previous
        view)."""
        return self._prev_camera

    @prev_camera.setter
    def prev_camera(self, cam: Camera):
        self._prev_camera = cam
        self._prev_cam_host = self._cam_host if cam is self._camera else None

    def _set_camera(self, pos, yaw, pitch, fov_y, aperture, focal_dist):
        """Camera from host values, in one copy to the device that does not
        synchronise the stream."""
        v = np.array([*pos, yaw, pitch, fov_y, aperture, focal_dist],
                     np.float32)
        t = torch.from_numpy(v).to(self.device, non_blocking=True)
        self._camera = Camera(t[0:3], t[3], t[4], t[5], t[6], t[7])
        self._cam_host = v

    def _camera_host(self) -> np.ndarray:
        """[pos x, y, z, yaw, pitch, fov_y, aperture, focal_dist] float32."""
        if self._cam_host is None:
            c = self._camera
            self._cam_host = torch.cat(
                [c.pos.reshape(3)] + [x.reshape(1) for x in (
                    c.yaw, c.pitch, c.fov_y, c.aperture, c.focal_dist)]
            ).to(torch.float32).cpu().numpy()
        return self._cam_host

    # ------------------------------------------------------------------
    # input control (reference: src/inputControl.cu:29-113)
    # ------------------------------------------------------------------

    def key_event(self, key: str, down: bool):
        key = key.lower()
        if down:
            self._input["keys"].add(key)
        else:
            self._input["keys"].discard(key)

    def cursor_event(self, x: float, y: float):
        last = self._input["last_cursor"]
        self._input["last_cursor"] = (x, y)
        if last is None:
            return
        dx, dy = x - last[0], y - last[1]
        v = self._camera_host().copy()
        v[3] = v[3] + np.float32(dx * self.LOOK_SPEED)
        v[4] = np.clip(v[4] - np.float32(dy * self.LOOK_SPEED), -1.5, 1.5)
        self._set_camera(v[0:3], *v[3:])

    def _update_camera_from_input(self, dt: float):
        keys = self._input["keys"]
        if not keys:
            return
        v = self._camera_host()
        cy, sy = math.cos(float(v[3])), math.sin(float(v[3]))
        fwd = np.array([sy, 0.0, cy])
        right = np.array([cy, 0.0, -sy])
        move = np.zeros(3)
        if "w" in keys:
            move += fwd
        if "s" in keys:
            move -= fwd
        if "d" in keys:
            move += right
        if "a" in keys:
            move -= right
        if "c" in keys:
            move += np.array([0.0, 1.0, 0.0])
        if "x" in keys:
            move -= np.array([0.0, 1.0, 0.0])
        if np.any(move):
            pos = v[0:3].astype(np.float64) + move * (self.MOVE_SPEED * dt)
            self._set_camera(pos, *v[3:])

    # ------------------------------------------------------------------
    # camera persistence (reference: inputControl.cu:115-150, camera.bin);
    # the JSON of rtrt_tpu's Engine, so either package loads the other's
    # ------------------------------------------------------------------

    def save_camera(self, path: str | None = None):
        path = path or self.settings.camera_path
        v = [float(x) for x in self._camera_host()]
        data = dict(pos=v[0:3], yaw=v[3], pitch=v[4], fov_y=v[5],
                    aperture=v[6], focal_dist=v[7])
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    def load_camera(self, path: str | None = None):
        path = path or self.settings.camera_path
        with open(path) as f:
            d = json.load(f)
        self._set_camera(pos=d["pos"], yaw=d["yaw"], pitch=d["pitch"],
                         fov_y=d["fov_y"], aperture=d["aperture"],
                         focal_dist=d["focal_dist"])

    # ------------------------------------------------------------------
    # full-state checkpoint / resume: bucket, exposure, frame counter and
    # time, denoiser history and camera, one npz key per field
    # ------------------------------------------------------------------

    def save_state(self, path: str):
        st = self.state
        arrays = dict(bucket=np.int64(self._cur_bucket),
                      exposure=st.exposure.cpu().numpy(),
                      frame_idx=np.int64(st.frame_idx),
                      time=np.float64(st.time), camera=self._camera_host())
        if st.history is not None:
            for f in DenoiseHistory._fields:
                x = getattr(st.history, f)
                arrays[f"history_{f}"] = (np.bool_(x) if f == "valid"
                                          else x.cpu().float().numpy()
                                          if x.is_floating_point()
                                          else x.cpu().numpy())
        np.savez_compressed(path, **arrays)

    def load_state(self, path: str):
        d = np.load(path)
        self._set_bucket(int(d["bucket"]))
        hdt = torch.bfloat16 if self.flags.half_history else torch.float32

        def plane(f):
            x = torch.from_numpy(d[f"history_{f}"]).to(self.device)
            return x.to(hdt) if x.is_floating_point() else x

        history = None
        if "history_valid" in d:
            history = DenoiseHistory(**{
                f: bool(d["history_valid"]) if f == "valid" else plane(f)
                for f in DenoiseHistory._fields})
        self.state = FrameState(
            exposure=torch.from_numpy(d["exposure"]).to(self.device),
            history=history, frame_idx=int(d["frame_idx"]),
            time=float(d["time"]))
        cam = d["camera"]
        self._set_camera(cam[0:3], *cam[3:])
        self.prev_camera = self.camera
