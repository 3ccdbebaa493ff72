"""The per-frame values that a frame replayed as a CUDA graph reads from the
device (engine/frame.py::FrameUniforms), on the CPU: every reader gives
the same bits from the device form as from the host's Python scalars.

  * rand2_bn / rand2 from a 0-d integer tensor frame (uint32 values past
    2^31 too), and rand2_bn from its precomputed point;
  * the dither shift hashed from a tensor frame (postprocess, tail_params);
  * the travelling wave from its float32 clock products (wave_phases);
  * a whole frame through render_frame with uniforms and the history
    written into given planes, against the plain call, on the static BVH4,
    the rebuilt LBVH under the wave, the refitted BVH4 and the interlaced
    frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rtrt_tpu_torch.core.camera import Camera
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.engine.frame import (BN_DIMS, FrameState, FrameUniforms,
                                         U_WORDS, displace_wave,
                                         displace_wave_rows, render_frame,
                                         uniform_words, wave_normal_rows,
                                         wave_phases)
from rtrt_tpu_torch.post.pipeline import postprocess
from rtrt_tpu_torch.post.tail import tail_params
from rtrt_tpu_torch.render.sampling import bn_point, rand2, rand2_bn
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings, default_params)
from rtrt_tpu_torch.utils.consts import device_const

torch.set_num_threads(2)
FRAMES = (0, 1, 77, 2**31 - 1, 2**31 + 5, 2**32 - 1)
PLANES = ("color", "color2", "depth", "mat_id", "count")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else \
        x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _frame_tensor(frame: int):
    """The frame index as FrameUniforms holds it: (1,) int32 bits."""
    return torch.from_numpy(np.array([frame], np.uint32).view(np.int32))


@pytest.mark.parametrize("frame", FRAMES)
def test_samples_from_a_device_frame_index(frame):
    rng = np.random.default_rng(frame % 1000)
    bn = torch.from_numpy(rng.random((6, 5, 2), dtype=np.float32))
    ids = torch.arange(30, dtype=torch.int32).reshape(6, 5)
    t = _frame_tensor(frame)
    for d in BN_DIMS:
        ref = rand2_bn(bn, frame, d)
        assert _same(rand2_bn(bn, t.reshape(()), d), ref)
        point = torch.tensor(bn_point(frame, d), dtype=torch.float32)
        assert _same(rand2_bn(bn, None, d, point=point), ref)
        assert _same(rand2(ids, t, d), rand2(ids, frame, d))
    words = uniform_words(frame, None, None, 0.0, 1 / 60)
    u = FrameUniforms(torch.from_numpy(words))
    assert int(u.frame[0]) & 0xFFFFFFFF == frame
    for row, d in zip(u.bn, BN_DIMS):
        assert _same(row, torch.tensor(bn_point(frame, d),
                                       dtype=torch.float32))


@pytest.mark.parametrize("frame", FRAMES)
def test_dither_shift_from_a_device_frame_index(frame):
    rng = np.random.default_rng(3)
    color = torch.from_numpy(rng.random((16, 32, 3), dtype=np.float32) * 4)
    p = default_params().post
    flags = FeatureFlags()
    exposure = torch.tensor([1.0, 0.5, 2.0, 1.0])
    sun = torch.tensor([0.4, 0.3])
    vis = torch.ones(())
    dt = np.float32(1 / 60)
    a = postprocess(color, exposure, float(dt), sun, vis, p, flags, 16, 32,
                    frame)
    b = postprocess(color, exposure, torch.tensor(dt), sun, vis, p, flags,
                    16, 32, _frame_tensor(frame))
    assert _same(a[0], b[0]) and _same(a[1], b[1])
    fs = 0.2890625
    assert _same(tail_params(exposure[0], 1.0, 2.2, 0.5, fs, "cpu"),
                 tail_params(exposure[0], 1.0, 2.2, 0.5, torch.tensor(fs),
                             "cpu"))


@pytest.mark.parametrize("time", [0.0, 1 / 60, 3.7, 1234.5678])
def test_wave_from_its_clock_products(time):
    rng = np.random.default_rng(5)
    verts = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32) * 9)
    rows = torch.from_numpy(rng.normal(size=(9, 40)).astype(np.float32) * 9)
    nrm = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(3, 3, 40)).astype(np.float32)), dim=1).reshape(9, 40)
    words = uniform_words(0, None, None, time, 1 / 60)
    phases = FrameUniforms(torch.from_numpy(words)).wave
    assert [float(x) for x in phases] == list(wave_phases(time))
    assert _same(displace_wave(verts, phases), displace_wave(verts, time))
    assert _same(displace_wave_rows(rows, phases),
                 displace_wave_rows(rows, time))
    assert _same(wave_normal_rows(nrm, rows, phases),
                 wave_normal_rows(nrm, rows, time))


def _engine(bvh="sah4", animation="none", interlace=False):
    return Engine(GlobalSettings(
        scene="terrain", render_width=48, render_height=27, texture_size=64,
        terrain_chunks=1, interlace=interlace,
        dynamic_resolution=DynamicResolution(enabled=False)),
        FeatureFlags(), bvh=bvh, animation=animation, device="cpu")


def _copy(st: FrameState) -> FrameState:
    return dataclasses.replace(st, exposure=st.exposure.clone(),
                               history=st.history._replace(**{
                                   p: getattr(st.history, p).clone()
                                   for p in PLANES}))


def _host(cam: Camera) -> np.ndarray:
    return torch.cat([cam.pos.reshape(3)] + [x.reshape(1) for x in (
        cam.yaw, cam.pitch, cam.fov_y, cam.aperture, cam.focal_dist)]).numpy()


@pytest.mark.parametrize("case", [("sah4", "none", False),
                                  ("lbvh", "wave", False),
                                  ("sah4", "wave", False),
                                  ("sah4", "none", True)],
                         ids=["sah4", "lbvh_wave", "sah4_refit",
                              "interlace"])
def test_frame_from_uniforms_matches_the_host_values(case):
    eng = _engine(*case)
    eng.state = dataclasses.replace(eng.state, frame_idx=2**31 + 6)
    for k in range(2):
        eng.cursor_event(10.0 + 3 * k, 5.0)
        eng.render_frame_device(1 / 60)
    assert eng.graph_counts == dict(replayed=0, captured=0,
                                    eager={"cpu": 2})
    eng.cursor_event(20.0, 5.0)
    st, dt = eng.state, 1 / 60
    args = (eng.static, eng.scene_data)
    rest = (eng.params, dt, eng.consts, eng.overflow, eng.stack_depth,
            eng.rest)
    a = render_frame(*args, _copy(st), eng.camera, eng.prev_camera, *rest)
    words = uniform_words(st.frame_idx, _host(eng.camera),
                          _host(eng.prev_camera), st.time, dt)
    assert words.shape == (U_WORDS,)
    u = FrameUniforms(torch.from_numpy(words))
    into = _copy(st)
    # the cameras given are not read: the uniforms' are
    b = render_frame(*args, into, None, None, *rest, uniforms=u,
                     history_out=into.history)
    assert _same(a[0], b[0])
    assert _same(a[1].exposure, b[1].exposure)
    assert (a[1].frame_idx, a[1].time) == (b[1].frame_idx, b[1].time)
    for p in PLANES:
        assert getattr(b[1].history, p) is getattr(into.history, p)
        assert _same(getattr(a[1].history, p), getattr(b[1].history, p)), p
    for f in dataclasses.fields(a[2]):
        assert _same(getattr(a[2], f.name), getattr(b[2], f.name)), f.name


def test_engine_tracks_its_cameras_host_values():
    eng = _engine()
    assert eng._prev_cam_host is eng._cam_host is not None
    eng.cursor_event(1.0, 1.0)
    eng.cursor_event(5.0, 1.0)
    before = eng._cam_host
    eng.render_frame_device(1 / 60)
    assert eng._prev_cam_host is before  # the frame's camera became prev
    # a camera set from outside has no host copy until one is read
    eng.camera = dataclasses.replace(eng.camera)
    eng.prev_camera = eng.camera
    assert eng._cam_host is None and eng._prev_cam_host is None


def test_device_const_is_built_once():
    a = device_const((1.0, 2.0), "cpu")
    assert a is device_const((1.0, 2.0), "cpu")
    assert a.dtype == torch.float32 and a.tolist() == [1.0, 2.0]
    b = device_const((1.0, 2.0), "cpu", torch.float64)
    assert b is not a and b.dtype == torch.float64
