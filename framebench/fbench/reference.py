"""The plain reference of one frame: fbref, a frozen copy of the port's
plain path (every kernel replaced by its plain twin, cut to what the
cells' frames reach), which imports nothing of the port, JAX or the JAX
package, and takes nothing the program made.  It is the port's own
semantics at the time of the copy, not an implementation written apart
from it: it holds every later change of the program to them (PERF.md §2).

From the benchmark's own mesh it builds its own tree (the two-level LBVH,
built on the card, for either configuration: the closest hit does not
depend on the tree), its own sky bake, frame constants and material rows;
from the camera values that the benchmark's input replay works out
(pan.CameraMirror) and the frame counter and clock that the benchmark
counts, it renders the frames that the program rendered: from its own
start state, the run's first frames (the chain), and from the program's
history and exposure, the frame after the window.

`plane_dtype=torch.bfloat16` is the control: the reference with each float
plane it passes between stages (a waving scene's displaced vertices, the
G-buffer and the denoised colour) stored in bfloat16, the nearest
precision below the float32 that the configuration states for them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .scene import material_entries, padded


class Reference:
    def __init__(self, config: dict, traffic: dict, mesh, device,
                 plane_dtype=torch.float32):
        from fbref.bvh.packet import pack_tables_binary
        from fbref.engine import frame as F
        from fbref.render import bsdf
        from fbref.render.megakernel import SceneData
        from fbref.utils.config import FeatureFlags, default_params

        self.F = F
        self.device = torch.device(device)
        self.plane_dtype = plane_dtype
        dev = self.device
        vertices, indices, normals = mesh
        idx, tri_mat, valid = padded(indices)
        pose = F.MeshPose(
            vertices=torch.from_numpy(vertices).to(dev),
            indices=torch.from_numpy(idx).to(dev, torch.int64),
            tri_mat=torch.from_numpy(tri_mat).to(dev, torch.int32),
            valid=torch.from_numpy(valid).to(dev))
        nrm = torch.from_numpy(normals).to(dev)
        tables = pack_tables_binary(*F.build_scene_tables(
            valid.shape[0], pose.indices, pose.tri_mat, pose.valid,
            pose.vertices, nrm))
        # a waving scene rebuilds its tables from the rest mesh every frame
        self.rest = pose if config["animation"] == "wave" else None
        self.params = default_params()
        self.flags = FeatureFlags()
        self.scene = SceneData(
            tables=tables, materials=bsdf.make_materials(
                material_entries(config, bsdf)).to(dev),
            sky=self._sky())
        if (traffic["width"], config["interlace"]) != \
                (_res_for_height(traffic["height"])[0], False):
            raise ValueError("the reference renders every row at the "
                             "screen size")
        self.static = F.FrameStatic(render_w=traffic["width"],
                                    render_h=traffic["height"],
                                    flags=self.flags)
        self.consts = F.make_frame_consts(self.static, dev)

    def init_state(self):
        """The reference's (history, exposure) before a first frame."""
        from fbref.denoise.pipeline import init_history
        from fbref.post.exposure import init_exposure_state
        return (init_history(self.static.render_h, self.static.render_w,
                             device=self.device),
                init_exposure_state(self.device))

    def _sky(self):
        """The sky bake of the default sky parameters (a copy of the
        Engine's _maybe_regen_sky)."""
        from fbref.render.sky import (bake_sky_maps, finalize_sky_maps,
                                      make_sky_params,
                                      sun_direction_from_time)
        sp = self.params.sky
        sun = sun_direction_from_time(sp.time_of_day, sp.sun_axis_angle)
        elev = math.asin(max(-1.0, min(1.0, float(sun[1]))))
        azim = math.atan2(float(sun[0]), float(sun[2]))
        return finalize_sky_maps(bake_sky_maps(make_sky_params(
            sun_elevation=elev, sun_azimuth=azim,
            sun_intensity=sp.sun_intensity, rayleigh_scale=sp.rayleigh,
            mie_scale=sp.mie, mie_g=sp.mie_g, device=self.device)))

    def camera(self, values):
        from fbref.core.camera import Camera
        t = torch.from_numpy(np.asarray(values, np.float32)).to(self.device)
        return Camera(t[0:3], t[3], t[4], t[5], t[6], t[7])

    def frame(self, history, exposure, frame_idx: int, clock: float,
              camera, prev_camera, dt: float):
        """The frame from the given state: (u8 image, G-buffer planes, new
        history, new exposure, triangle records of the traced tables)."""
        from fbref.denoise.pipeline import DenoiseHistory
        F = self.F
        state = F.FrameState(
            exposure=exposure.to(self.device),
            history=DenoiseHistory(**history._asdict()),
            frame_idx=frame_idx, time=clock)
        with _Rounded(self.F, self.plane_dtype):
            image, new, gbuf = F.render_frame(
                self.static, self.scene, state, self.camera(camera),
                self.camera(prev_camera), self.params, max(dt, 1e-4),
                self.consts, self.rest)
        return dict(image=image,
                    gbuffer={f.name: getattr(gbuf, f.name)
                             for f in dataclasses.fields(gbuf)},
                    history=new.history, exposure=new.exposure,
                    # the tables are rebuilt in place by the next frame
                    tris=self.scene.tables.tris.clone())


class _Rounded:
    """For a dtype below float32 (the control): the displaced vertices, the
    G-buffer planes and the denoised colour of the frame module F rounded
    to it where each stage hands them on."""

    def __init__(self, F, dtype):
        self.F, self.dtype, self.saved = F, dtype, None

    def __enter__(self):
        if self.dtype == torch.float32:
            return self
        F, dt = self.F, self.dtype
        self.saved = (F.path_trace_mega, F.denoise, F.displace_wave)
        trace, den, wave = self.saved
        rnd = lambda x: x.to(dt).to(x.dtype) if x.is_floating_point() else x

        def path_trace_mega(*a, **k):
            g = trace(*a, **k)
            return dataclasses.replace(g, **{
                f.name: rnd(getattr(g, f.name))
                for f in dataclasses.fields(g)})

        def denoise(*a, **k):
            final, hist = den(*a, **k)
            return rnd(final), hist

        F.path_trace_mega, F.denoise = path_trace_mega, denoise
        F.displace_wave = lambda v, t: rnd(wave(v, t))
        return self

    def __exit__(self, *exc):
        if self.saved is not None:
            (self.F.path_trace_mega, self.F.denoise,
             self.F.displace_wave) = self.saved
        return False


def clock_after(frames: int, dt: float) -> float:
    """The animation clock after `frames` frames of dt seconds, accumulated
    in float32 as the frame's FrameState.time is."""
    t = np.float32(0.0)
    for _ in range(frames):
        t = np.float32(t + np.float32(dt))
    return float(t)


def _res_for_height(h: int):
    """16:9, the width snapped to a multiple of 16 (the bucket's size)."""
    return (h * 16 // 9) // 16 * 16, h
