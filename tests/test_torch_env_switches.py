"""The two JAX environment switches on the port's side: RTRT_SEGMENTS on the
megakernel route and RTRT_INTERLACE in the Engine.

RTRT_SEGMENTS is read once, when render/integrator.py is imported (in
both packages), so the 3-segment route runs in a subprocess of its own
(tests/torch_segments_case.py): there the port's plain K2 is held to
JAX's simulate_megakernel at 3 segments at tests/test_torch_megakernel.py's
bounds (>= 98% of each G-buffer plane's pixels within its tolerances, mean
relative error below 1%; blue noise, the bound that file measures 100%
against), while the same rays at 5 segments on the port's side are not
(so 3 is what both traced), and the port's megakernel frame within 1 LSB
of its wavefront frame on every pixel of two frames, as
tests/test_torch_frame.py holds them at 5.  Counts beyond K2's 1..5 raise
ValueError on the megakernel route: from megakernel_trace and its plain
version, and from FrameStatic (so at Engine init).

RTRT_INTERLACE=1 / 0 takes precedence over GlobalSettings.interlace, and a
bucket interlaces only at an even height, as the JAX Engine decides
(rtrt_tpu/engine/engine.py:353-359): both directions on the Engine, the
odd height on engine.interlace_for (every bucket height is even).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from rtrt_tpu_torch.engine import engine as TE
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.render import integrator as TI
from rtrt_tpu_torch.render import megakernel as TM
from rtrt_tpu_torch.utils import config as TC

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def three_segments():
    env = dict(os.environ, RTRT_SEGMENTS="3", JAX_PLATFORMS="cpu")
    case = os.path.join(REPO, "tests", "torch_segments_case.py")
    p = subprocess.run([sys.executable, case], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    assert p.returncode == 0 and lines, p.stdout[-2000:] + p.stderr[-4000:]
    return json.loads(lines[-1][7:])


def test_both_packages_read_three(three_segments):
    assert set(three_segments["segments"].values()) == {3}


def test_plain_megakernel_matches_simulator_at_three(three_segments):
    res = three_segments
    assert res["overflow_3"] == 0
    for plane, (share, rel) in res["plain_vs_jax_3"].items():
        assert share >= 0.98, (plane, share)
        assert rel < 0.01, (plane, rel)
    # the same rays traced 5 segments deep on the port's side leave the
    # 3-segment reference: the colour's share or its error says so
    share5, rel5 = res["plain_vs_jax_5"]["color"]
    assert share5 < 0.98 or rel5 >= 0.01, (share5, rel5)


def test_megakernel_frame_matches_wavefront_at_three(three_segments):
    res = three_segments
    assert res["frame_overflow_megakernel"] == 0
    assert res["frame_overflow_packets"] == 0
    assert res["frame_lsb_max"] and max(res["frame_lsb_max"]) <= 1


def test_step_planes_follow_the_count(three_segments):
    res = three_segments
    assert res["steps_rows"] == 4 and res["steps_sum_ok"]
    assert res["steps_live"][0] > 0.3  # primaries traverse


@pytest.mark.parametrize("segments", [0, 6])
def test_megakernel_route_refuses_segment_counts(segments, monkeypatch):
    for fn in (TM.megakernel_trace, TM.megakernel_trace_plain):
        with pytest.raises(ValueError, match="segments"):
            fn(*[None] * 9, n_lights=0, segments=segments)
    monkeypatch.setattr(TI, "SEGMENTS", segments)
    flags = TC.FeatureFlags()
    with pytest.raises(ValueError, match="RTRT_SEGMENTS"):
        TF.FrameStatic(render_w=32, render_h=16, screen_w=32, screen_h=16,
                       flags=flags)
    # the wavefront route takes any count, as JAX's integrator does
    TF.FrameStatic(render_w=32, render_h=16, screen_w=32, screen_h=16,
                   flags=flags, use_megakernel=False)


@pytest.mark.parametrize("env,setting,want", [
    (None, False, False), (None, True, True), ("1", False, True),
    ("0", True, False), ("yes", True, False)])
def test_interlace_precedence(env, setting, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("RTRT_INTERLACE", raising=False)
    else:
        monkeypatch.setenv("RTRT_INTERLACE", env)
    assert TE.interlace_for(setting, 270) is want
    assert TE.interlace_for(setting, 271) is False  # odd: never


@pytest.fixture(scope="module")
def demo_settings():
    return TC.GlobalSettings(scene="demo", render_width=32, render_height=16,
                             dynamic_resolution=TC.DynamicResolution(
                                 enabled=False))


@pytest.mark.parametrize("env,setting", [("1", False), ("0", True)])
def test_engine_takes_the_variable(env, setting, demo_settings,
                                   monkeypatch):
    monkeypatch.setenv("RTRT_INTERLACE", env)
    eng = TE.Engine(dataclasses.replace(demo_settings, interlace=setting),
                    device="cpu")
    assert eng.render_h % 2 == 0
    assert eng.static.interlace is (env == "1")
    assert TF.interlaced(eng.static) is (env == "1")
