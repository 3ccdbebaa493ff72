"""The system under test: rtrt_tpu_torch's Engine, built from a cell's
configuration and driven frame by frame through its own input path.

Everything of the port is imported here, inside functions, and nowhere else
in framebench (the per-layer cut frame of `cut_frame` included): the port
is the code under test, and the benchmark takes from it only its frames,
their state and its kernel names.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from .pan import CameraMirror, Pan
from .scene import batches, material_entries


def build_engine(config: dict, traffic: dict, mesh, device="cuda"):
    """The cell's Engine, handed the benchmark's mesh as a HostScene, with
    dynamic resolution off and the default FeatureFlags()."""
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.engine.scene import HostScene
    from rtrt_tpu_torch.render import bsdf
    from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                             GlobalSettings)

    vertices, indices, normals = mesh
    scene = HostScene(vertices=vertices, indices=indices, normals=normals,
                      tri_mat=np.zeros(indices.shape[0], np.int32),
                      num_batches=batches(indices.shape[0]),
                      materials=bsdf.make_materials(
                          material_entries(config, bsdf)))
    settings = GlobalSettings(
        render_width=traffic["width"], render_height=traffic["height"],
        texture_size=config["texture_size"],
        terrain_seed=config["terrain"]["seed"],
        terrain_chunks=config["terrain"]["chunks_x"],
        interlace=config["interlace"],
        dynamic_resolution=DynamicResolution(
            enabled=config["dynamic_resolution"]))
    return Engine(settings, FeatureFlags(), scene=scene, bvh=config["bvh"],
                  animation=config["animation"], device=device)


class Driver:
    """Drives an Engine as the viewer does: one cursor event a frame (the
    pan), then `render_frame_device(dt)`, with `in_flight` frames enqueued
    at most (a frame waits on the CUDA event of the frame `in_flight`
    before it).  `mirror` replays every event for the reference; `frames`
    counts the frames rendered."""

    def __init__(self, eng, traffic: dict, pan: Pan, camera: dict,
                 first_frame: int, scratch_dir: str):
        self.eng = eng
        self.dt = float(traffic["dt"])
        self.in_flight = int(traffic["frames_in_flight"])
        self.pan = pan
        look = float(traffic["pan"]["look_speed"])
        yaw = float(np.float32(pan.x(0) * look))
        start = dict(camera, yaw=yaw)
        # the start view goes in through the Engine's camera persistence
        fd, path = tempfile.mkstemp(suffix=".json", dir=scratch_dir)
        with os.fdopen(fd, "w") as f:
            json.dump(start, f)
        try:
            eng.load_camera(path)
        finally:
            os.remove(path)
        self.mirror = CameraMirror(np.float32(
            [*start["pos"], yaw, start["pitch"], start["fov_y"],
             start["aperture"], start["focal_dist"]]), look)
        eng.state = dataclasses.replace(eng.state, frame_idx=first_frame)
        self.first_frame = first_frame
        self.frames = 0
        self._event(0)

    def _event(self, k: int):
        x, y = float(self.pan.x(k)), float(self.pan.y_px)
        self.eng.cursor_event(x, y)
        self.mirror.cursor(x, y)

    def frame(self):
        """One frame: the next pan step, then the frame; returns the u8
        image on the device (enqueued)."""
        self._event(self.frames + 1)
        image = self.eng.render_frame_device(self.dt)
        self.mirror.end_frame()
        self.frames += 1
        return image

    def run(self, frames: int | None = None, seconds: float | None = None,
            span=None):
        """Frames back to back until `frames` are rendered or `seconds` have
        passed on the host clock (at least one).  Returns (start event, the
        frames' end events, host seconds of each render_frame_device
        call).  span(name) optionally wraps each frame's call and each
        wait in a named context (the traced part's labels)."""
        span = span or (lambda name: contextlib.nullcontext())
        on_card = self.eng.device.type == "cuda"
        event = (lambda: torch.cuda.Event(enable_timing=True)) if on_card \
            else HostEvent
        ring = collections.deque()
        ends, host = [], []
        start = event()
        start.record()
        t0 = time.perf_counter()
        while True:
            if len(ring) >= self.in_flight:
                with span("fbench.wait"):
                    ring.popleft().synchronize()
            h0 = time.perf_counter()
            with span("fbench.frame"):
                self.frame()
            host.append(time.perf_counter() - h0)
            ev = event()
            ev.record()
            ring.append(ev)
            ends.append(ev)
            if frames is not None and len(ends) >= frames:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        return start, ends, host


class HostEvent:
    """A CUDA event's stand-in for an Engine on the CPU (the tests' plain
    runs): the host clock at record(), whose frames are done on return."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def cut_frame(eng, dt: float, stop: str = "bvh"):
    """One frame of the Engine cut after `stop` (engine/frame.py's cut
    points, as rtrt_tpu_torch/tools/profile_frame.py cuts it): with "bvh"
    the animation or rebuild stage alone.  It returns the state it was
    given, so the Engine's next frame is unchanged."""
    from rtrt_tpu_torch.engine.frame import render_frame

    static = dataclasses.replace(eng.static, stop_after=stop)
    return render_frame(static, eng.scene_data, eng.state, eng.camera,
                        eng.prev_camera, eng.params, dt, eng.consts,
                        eng.overflow, eng.stack_depth, eng.rest)


def snapshot_state(eng):
    """The Engine's frame state as the reference takes it: clones of the
    denoiser history's planes and the exposure state."""
    st = eng.state
    h = st.history
    history = None if h is None else type(h)(**{
        f: getattr(h, f).clone() if torch.is_tensor(getattr(h, f))
        else getattr(h, f) for f in h._fields})
    return history, st.exposure.clone()


def frame_outputs(eng, image):
    """What the compared frame produced: the u8 image, the traced G-buffer,
    the new history and exposure, and the triangle records of the tables
    the frame traced."""
    g = eng.last_gbuffer
    return dict(image=image, gbuffer={f.name: getattr(g, f.name)
                                      for f in dataclasses.fields(g)},
                history=eng.state.history, exposure=eng.state.exposure,
                tris=eng.scene_data.tables.tris)
