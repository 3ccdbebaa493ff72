"""The Engine's frame replayed as a CUDA graph against the same frames run
eagerly, on the card (`python -m pytest -m gpu
tests/test_torch_frame_graph_gpu.py`; every test skips without one).

Two Engines are built alike from the same scene; the twin's frames are
held eager (its `_eager_reason` always answers), and both get the same
cursor events and frame times.  Each frame's u8 image, traced G-buffer,
new history and exposure state are compared plane by plane.

Tolerances: none on the static BVH4 frames, whose eager frames are
deterministic: every plane bit-equal.  The rebuilt LBVH's smooth normals
are sums by float atomics (ops/reduce.py::segment_sum: index_add_ on the
card adds in another order each run), so two eager frames of the wave
part where those sums round apart, and so do a replay and an eager frame:
there the G-buffer's depth, material and motion stay exact on >= 99.9% of
pixels, and the image is held to a mean absolute difference of 0.05 u8
levels with >= 99% of its values equal (`_close`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings)

PLANES = ("color", "color2", "depth", "mat_id", "count")
# (bvh, animation, interlace): the two framebench cells' frames, and the
# interlaced frame, whose field is the graph key's parity
CASES = {"sah4": ("sah4", "none", False), "lbvh_wave": ("lbvh", "wave",
                                                        False),
         "sah4_interlace": ("sah4", "none", True)}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the graph replays only "
                    "on the card")
    return torch.device("cuda")


def _pair(case, width=480, height=270, dynamic=False):
    """(graph engine, eager twin) of a case, built alike."""
    bvh, animation, interlace = CASES[case]
    settings = GlobalSettings(
        scene="terrain", render_width=width, render_height=height,
        texture_size=256, interlace=interlace,
        dynamic_resolution=DynamicResolution(enabled=dynamic))
    engines = [Engine(settings, FeatureFlags(), bvh=bvh, animation=animation)
               for _ in range(2)]
    engines[1]._eager_reason = lambda: "eager_twin"
    return engines


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else \
        x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _outputs(eng, image):
    """Clones of what the frame left: the image, G-buffer, history planes
    and exposure."""
    g = eng.last_gbuffer
    out = {"image": image.clone(), "exposure": eng.state.exposure.clone()}
    out.update({f"gbuf.{f.name}": getattr(g, f.name).clone()
                for f in dataclasses.fields(g)})
    out.update({f"hist.{p}": getattr(eng.state.history, p).clone()
                for p in PLANES})
    return out


def _equal(a, b):
    """The names of the planes that are not bit-equal."""
    return [k for k in a if not torch.equal(_bits(a[k]), _bits(b[k]))]


def _close(a, b):
    """The rebuilt LBVH's bound (module docstring): the names of the planes
    outside it."""
    bad = []
    for k in ("gbuf.depth", "gbuf.mat_id", "gbuf.motion"):
        same = (_bits(a[k]) == _bits(b[k])).float().mean()
        if same < 0.999:
            bad.append(k)
    ia, ib = a["image"].int(), b["image"].int()
    if (ia - ib).abs().float().mean() > 0.05 or \
            (ia == ib).float().mean() < 0.99:
        bad.append("image")
    return bad


def _step(engines, k, dt=1 / 60):
    """One frame of the pan on both Engines; their outputs."""
    outs = []
    for eng in engines:
        eng.cursor_event(200.0 + 2.0 * k, 100.0)
        outs.append(_outputs(eng, eng.render_frame_device(dt)))
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_replay_matches_eager(cuda_device, case):
    engines = _pair(case)
    exact = case != "lbvh_wave"
    for k in range(8):
        a, b = _step(engines, k)
        bad = _equal(a, b) if exact else _close(a, b)
        assert not bad, (case, k, bad)
    graph, twin = engines
    assert graph.graph_failures == {}
    # frame 0 is eager (its history is not valid yet); frames 1 and 2
    # capture the two parities' graphs and replay them, and every frame
    # after replays
    assert graph.graph_counts == dict(replayed=7, captured=2,
                                      eager={"first_frame": 1})
    assert twin.graph_counts["replayed"] == 0
    assert int(graph.overflow) == int(twin.overflow) == 0


@pytest.mark.gpu
def test_recapture_and_refill(cuda_device, tmp_path):
    """A load_state refills the graphs' inputs; a parameter change
    recaptures; a bucket switch renders the new bucket's first frame
    eagerly, captures its graphs, and the old bucket's graphs replay again
    on the way back; a camera set from outside (device tensors, no host
    copy) reaches the uniforms on the device; every frame still bit-equal
    to the eager twin's."""
    engines = _pair("sah4", 640, 360, dynamic=True)
    graph, twin = engines
    k = 0

    def frames(n, dt=1 / 60):
        nonlocal k
        for _ in range(n):
            a, b = _step(engines, k, dt)
            k += 1
            assert not _equal(a, b), (k, _equal(a, b))

    frames(4)
    assert graph.graph_counts["captured"] == 2
    # load_state: the twin's saved state into both
    path = str(tmp_path / "state.npz")
    twin.save_state(path)
    for eng in engines:
        eng.load_state(path)
    frames(3)
    assert graph.graph_counts["captured"] == 2  # refilled, not recaptured
    # a parameter change: both parities recaptured
    for eng in engines:
        eng.params.post.bloom_strength *= 2.0
    frames(3)
    assert graph.graph_failures == {}
    assert graph.graph_counts["captured"] == 4
    # a slow frame drops a bucket (360 -> 270): its first frame eager, then
    # its two graphs; a fast one climbs back to 360, whose graphs replay
    frames(1, dt=1 / 20)
    assert (graph.render_w, graph.render_h) == (480, 270)
    frames(4)
    assert graph.graph_counts["captured"] == 6
    frames(1, dt=1 / 200)
    assert (graph.render_w, graph.render_h) == (640, 360)
    frames(4)
    for j in range(3):  # no cursor event: it would read the camera back
        outs = []
        for eng in engines:
            eng.camera = dataclasses.replace(
                eng.camera, yaw=eng.camera.yaw + 0.01 * (j + 1))
            outs.append(_outputs(eng, eng.render_frame_device(1 / 60)))
        assert not _equal(*outs), (j, _equal(*outs))
    # the last frames read both cameras from the device
    assert graph._cam_host is None and graph._prev_cam_host is None
    assert graph.graph_counts["captured"] == 6
    assert graph.graph_counts["eager"] == {"first_frame": 3}
    assert graph.graph_failures == {}


@pytest.mark.gpu
def test_uniform_slots_guard_a_deep_queue(cuda_device):
    """More frames enqueued than the uniforms have pinned slots, with no
    wait between them: each frame still reads its own camera and index
    (the images match the eager twin's, compared after all are queued)."""
    engines = _pair("sah4")
    for k in range(3):  # past the captures
        _step(engines, k)
    images = [[], []]
    for k in range(3, 13):
        for eng, out in zip(engines, images):
            eng.cursor_event(200.0 + 9.0 * k, 100.0)
            out.append(eng.render_frame_device(1 / 60).clone())
    torch.cuda.synchronize()
    for a, b in zip(*images):
        assert torch.equal(a, b)
    assert np.unique([int(x.float().mean() * 1e3) for x in images[0]]).size \
        > 1  # the pan moved the view


@pytest.mark.gpu
def test_module_switches_recapture(cuda_device):
    """RTRT_SEGMENTS' and RTRT_HISTORY_FILTER's module values, read at each
    call, are baked into the graphs: setting them captures anew, and the
    frames still match the eager twin's.  launch_counts count the
    delivered frames' launches: the twin's eager ones and the replays, not
    the warm-ups before the captures."""
    from rtrt_tpu_torch.denoise import reproject
    from rtrt_tpu_torch.render import integrator
    from rtrt_tpu_torch.utils import cuda

    engines = _pair("sah4")
    for k in range(3):
        assert not _equal(*_step(engines, k))
    saved = integrator.SEGMENTS, reproject.HISTORY_FILTER
    try:
        integrator.SEGMENTS, reproject.HISTORY_FILTER = 3, "bilinear"
        cuda.reset_launch_counts()
        for k in range(3, 6):
            assert not _equal(*_step(engines, k))
        counts = dict(cuda.launch_counts)
    finally:
        integrator.SEGMENTS, reproject.HISTORY_FILTER = saved
    assert engines[0].graph_counts["captured"] == 4
    assert engines[0].graph_failures == {}
    assert counts["reproject_bilinear"] == 6 and counts["reproject"] == 0
    assert counts["megakernel_trace"] == counts["post_tail"] == 6
