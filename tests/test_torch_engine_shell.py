"""The Engine's shell — resolution buckets and the dynamic-resolution
controller, camera input, the camera JSON and load_camera_at_init, state
save / load, the TOML config, get_param / set_param, the PNG and PPM files
and the headless CLI — the port against the JAX package on the CPU.

The JAX Engine's constructor builds a scene and compiles its frame, so
its host methods are reached on a stand-in object, as
tests/test_engine_utils.py reaches `_dynamic_resolution_step`; the port's
run on real Engines of the demo scene.  Tolerances: the controller's
buckets equal; cameras moved by the same key and cursor events within
1e-6 (both round to float32 at the same steps; JAX keeps a pitch set by
the cursor as a Python float); camera files, configs, parameters and
images equal; a state saved and loaded replays the same image.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.core.camera import make_camera as jcamera
from rtrt_tpu.engine import engine as JE
from rtrt_tpu.utils import config as JC
from rtrt_tpu.utils import image as JI
from rtrt_tpu_torch.app import headless
from rtrt_tpu_torch.engine import engine as TE
from rtrt_tpu_torch.utils import config as TC
from rtrt_tpu_torch.utils import image as TI

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DR_OFF = TC.DynamicResolution(enabled=False)
CAM0 = dict(pos=(0.0, 8.0, -18.0), yaw=0.0, pitch=-0.25, fov_y=1.1,
            aperture=0.0, focal_dist=5.0)


class _JaxShell:
    """The JAX Engine's host methods on a stand-in with the attributes
    they read."""

    MOVE_SPEED = JE.Engine.MOVE_SPEED
    LOOK_SPEED = JE.Engine.LOOK_SPEED
    _dynamic_resolution_step = JE.Engine._dynamic_resolution_step
    key_event = JE.Engine.key_event
    cursor_event = JE.Engine.cursor_event
    _update_camera_from_input = JE.Engine._update_camera_from_input
    save_camera = JE.Engine.save_camera
    load_camera = JE.Engine.load_camera

    def __init__(self, settings=None, bucket=1080):
        self.settings = settings or JC.GlobalSettings()
        self._cur_bucket = bucket
        self.camera = jcamera(**CAM0)
        self._input = dict(keys=set(), last_cursor=None)

    def _set_bucket(self, bucket_h):
        self._cur_bucket = bucket_h

    def _precompile_neighbors(self):
        pass


def _jax_cam(c):
    return np.array([*np.asarray(c.pos, np.float64), float(c.yaw),
                     float(c.pitch), float(c.fov_y), float(c.aperture),
                     float(c.focal_dist)])


def _port_cam(eng):
    c = eng.camera
    dev = np.array([*c.pos.tolist(), float(c.yaw), float(c.pitch),
                    float(c.fov_y), float(c.aperture), float(c.focal_dist)])
    np.testing.assert_array_equal(dev, eng._camera_host())  # host copy
    return dev


@pytest.fixture(scope="module")
def port():
    """The default settings (1920x1080, dynamic resolution on) on the demo
    scene; never rendered."""
    return TE.Engine(TC.GlobalSettings(scene="demo"), device="cpu")


def test_bucket_tables_match():
    assert TE._BUCKET_HEIGHTS == JE._BUCKET_HEIGHTS
    for h in list(range(1, 2400, 7)) + list(JE._BUCKET_HEIGHTS):
        assert TE._bucket_for(h) == JE._bucket_for(h), h
        assert TE._res_for_height(h) == JE._res_for_height(h), h


DTS = [1 / 20, 1 / 20, 1 / 200, 1 / 61, 1 / 30, 1 / 500, 1 / 500, 1 / 500,
       1 / 57, 1 / 59, 1 / 69, 1 / 67, 0.0, 1 / 20, 1 / 20, 1 / 20, 1 / 20,
       1 / 20, 1 / 100, 1 / 70, 1 / 68.5, 1 / 500, 1 / 500, 1 / 500]


def test_controller_matches_jax(port):
    js = _JaxShell(bucket=port._cur_bucket)
    expo = port.state.exposure
    seen = [port._cur_bucket]
    for dt in DTS:
        # a history that has been used, to see the switch reset it
        port.state = dataclasses.replace(port.state, history=(
            port.state.history._replace(valid=True)))
        before = port._cur_bucket
        js._dynamic_resolution_step(dt)
        port._dynamic_resolution_step(dt)
        assert port._cur_bucket == js._cur_bucket, (dt, seen)
        seen.append(port._cur_bucket)
        assert (port.render_w, port.render_h) == JE._res_for_height(
            js._cur_bucket)
        assert (port.static.render_w, port.static.render_h) == (
            port.render_w, port.render_h)
        assert port.consts.pixel_ids.shape == (port.render_h, port.render_w)
        hist = port.state.history
        for f in ("color", "color2", "depth", "mat_id", "count"):
            assert getattr(hist, f).shape[:2] == (port.render_h,
                                                  port.render_w), f
        assert hist.valid == (port._cur_bucket == before)
        if port._cur_bucket != before:
            assert not hist.count.float().any()
        assert port.state.exposure is expo
    assert set(seen) == {270, 360, 540, 720, 1080}, seen


def test_camera_input_matches_jax(port):
    port._set_camera(**CAM0)
    port._input = dict(keys=set(), last_cursor=None)
    js = _JaxShell()
    script = [("cursor", 100.0, 100.0), ("key", "W", True), ("step", 1 / 60),
              ("step", 1 / 60), ("cursor", 130.0, 90.0), ("key", "d", True),
              ("step", 0.05), ("key", "w", False), ("cursor", 120.0, 140.0),
              ("cursor", 121.5, 139.0), ("key", "c", True), ("step", 0.02),
              ("key", "d", False), ("key", "c", False), ("key", "x", True),
              ("key", "a", True), ("key", "s", True), ("step", 0.5),
              ("cursor", -400.0, 900.0), ("step", 1 / 30)]
    for ev in script:
        for eng in (js, port):
            if ev[0] == "cursor":
                eng.cursor_event(ev[1], ev[2])
            elif ev[0] == "key":
                eng.key_event(ev[1], ev[2])
            else:
                eng._update_camera_from_input(ev[1])
        np.testing.assert_allclose(_port_cam(port), _jax_cam(js.camera),
                                   rtol=0, atol=1e-6, err_msg=str(ev))
    assert abs(float(port.camera.pitch)) <= 1.5
    for k in "wsadcx":
        port.key_event(k, False)
    cam = port.camera
    port._update_camera_from_input(0.1)  # no keys: no camera work
    assert port.camera is cam


def test_camera_json_crosses(port, tmp_path):
    js = _JaxShell()
    js.camera = jcamera(pos=(1.5, 2.25, -3.1), yaw=0.4, pitch=-0.3,
                        fov_y=1.2, aperture=0.05, focal_dist=7.5)
    path = str(tmp_path / "jax.json")
    js.save_camera(path)
    port.load_camera(path)
    np.testing.assert_array_equal(_port_cam(port), _jax_cam(js.camera))
    port._set_camera(pos=(-2.0, 5.5, 11.0), yaw=-1.25, pitch=0.2, fov_y=0.9,
                     aperture=0.01, focal_dist=3.0)
    path = str(tmp_path / "port.json")
    port.save_camera(path)
    js.load_camera(path)
    np.testing.assert_array_equal(_jax_cam(js.camera), _port_cam(port))
    with open(path) as f:
        keys = set(json.load(f))
    assert keys == {"pos", "yaw", "pitch", "fov_y", "aperture", "focal_dist"}


def test_load_camera_at_init(tmp_path):
    js = _JaxShell()
    js.camera = jcamera(pos=(3.0, 4.0, -12.0), yaw=0.3, pitch=-0.1,
                        fov_y=1.0, aperture=0.0, focal_dist=9.0)
    path = str(tmp_path / "camera.json")
    js.save_camera(path)
    s = TC.GlobalSettings(scene="demo", render_width=32, render_height=16,
                          load_camera_at_init=True, camera_path=path,
                          dynamic_resolution=DR_OFF)
    eng = TE.Engine(s, device="cpu")
    np.testing.assert_array_equal(_port_cam(eng), _jax_cam(js.camera))
    eng = TE.Engine(dataclasses.replace(
        s, camera_path=str(tmp_path / "absent.json")), device="cpu")
    np.testing.assert_allclose(_port_cam(eng), _jax_cam(jcamera(**CAM0)))


@pytest.fixture(scope="module")
def shell_frames():
    """Three frames (dt 1/60 s) of the Engine that the headless test's
    command line builds: demo, out at 32x16 from the 480x270 bucket."""
    eng = TE.Engine(TC.GlobalSettings(scene="demo", render_width=32,
                                      render_height=16,
                                      dynamic_resolution=DR_OFF),
                    device="cpu")
    return eng, [eng.render_frame(dt=1 / 60) for _ in range(3)]


def test_state_save_load_replays(shell_frames, tmp_path):
    eng, _ = shell_frames
    path = str(tmp_path / "state.npz")
    eng.save_state(path)
    saved = np.load(path)
    assert set(saved.files) == {
        "bucket", "exposure", "frame_idx", "time", "camera",
        "history_color", "history_color2", "history_depth",
        "history_mat_id", "history_valid", "history_count"}
    assert int(saved["frame_idx"]) == eng.state.frame_idx == 3
    a = eng.render_frame(dt=1 / 60)
    eng.load_state(path)
    assert eng.state.frame_idx == 3 and eng.state.history.valid
    assert eng.state.history.color.dtype == torch.bfloat16
    b = eng.render_frame(dt=1 / 60)
    np.testing.assert_array_equal(a, b)


def test_headless_cli_writes_the_engine_image(shell_frames, tmp_path):
    out = str(tmp_path / "frame.png")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "rtrt_tpu_torch.app.headless",
                        "--device", "cpu", "--scene", "demo", "--width",
                        "32", "--height", "16", "--frames", "2", "--out",
                        out], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "2 frames @ 480x270" in r.stdout, r.stdout
    img = TI.read_png(out)
    assert img.shape == (16, 32, 3)
    np.testing.assert_array_equal(img, shell_frames[1][2])


@pytest.mark.parametrize("flag", ["--ocean", "--stars"])
def test_headless_unported_flags_reach_the_engine(flag, monkeypatch):
    """--ocean / --stars reach the Engine's FeatureFlags (both are ported
    now; tests/test_torch_environment.py renders them).  The name dates
    from when the Engine refused both flags and is kept, so the test
    keeps its identity."""
    seen = {}

    class Stop(Exception):
        pass

    def engine(settings, flags, trace, device):
        seen.update(flags=flags, trace=trace, device=device)
        raise Stop

    monkeypatch.setattr(TE, "Engine", engine)
    with pytest.raises(Stop):
        headless.main(["--device", "cpu", "--scene", "demo", flag])
    name = flag[2:]
    assert getattr(seen["flags"], name) and seen["device"] == "cpu"
    assert seen["trace"] == "megakernel"  # the default route
    other = {"ocean": "stars", "stars": "ocean"}[name]
    assert not getattr(seen["flags"], other)


@pytest.mark.parametrize("which", ["resources", "custom", "none"])
def test_load_config_matches(which, tmp_path):
    path = None
    if which == "resources":
        path = os.path.join(REPO, "resources", "config.toml")
    elif which == "custom":
        path = str(tmp_path / "c.toml")
        with open(path, "w") as f:
            f.write('render_width = 640\nrender_height = 360\n'
                    'scene = "demo"\ninterlace = true\n'
                    'terrain_style = "roundcube"\nunknown_key = 3\n'
                    '[dynamic_resolution]\nenabled = false\n'
                    'target_fps = 30.0\n')
    got, ref = TC.load_config(path), JC.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert type(got.dynamic_resolution) is TC.DynamicResolution


@pytest.mark.parametrize("entry", JC.PARAM_REGISTRY, ids=lambda e: e[0])
def test_get_set_param_match(entry):
    path, _label, _widget, lo, hi, _log = entry
    jp, tp = JC.default_params(), TC.default_params()
    f32 = np.float32
    assert f32(JC.get_param(jp, path)) == f32(TC.get_param(tp, path))
    value = lo + 0.37 * (hi - lo)
    jp2, tp2 = JC.set_param(jp, path, value), TC.set_param(tp, path, value)
    assert f32(JC.get_param(jp2, path)) == f32(TC.get_param(tp2, path))
    assert f32(TC.get_param(tp2, path)) == f32(value)
    assert tp == TC.default_params()  # the original is not changed
    for other, *_ in JC.PARAM_REGISTRY:
        if other != path:
            assert TC.get_param(tp2, other) == TC.get_param(tp, other)
            assert f32(JC.get_param(jp2, other)) == f32(
                TC.get_param(tp2, other))


@pytest.mark.parametrize("fmt", ["png", "ppm"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_image_files_cross(fmt, writer, tmp_path):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    w_pkg, r_pkg = (TI, JI) if writer == "port" else (JI, TI)
    path = str(tmp_path / f"a.{fmt}")
    getattr(w_pkg, f"write_{fmt}")(path, img)
    np.testing.assert_array_equal(getattr(r_pkg, f"read_{fmt}")(path), img)
    other = str(tmp_path / f"b.{fmt}")
    getattr(r_pkg, f"write_{fmt}")(other, img)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_png_float_and_gray_inputs(tmp_path):
    rng = np.random.default_rng(12)
    for img in (rng.uniform(-0.1, 1.1, (9, 14, 3)).astype(np.float32),
                rng.integers(0, 256, (6, 5)).astype(np.uint8)):
        a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        TI.write_png(a, img)
        JI.write_png(b, jnp.asarray(img))
        np.testing.assert_array_equal(JI.read_png(a), TI.read_png(b))
