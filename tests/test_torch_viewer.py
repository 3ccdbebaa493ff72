"""The port's HTTP viewer (rtrt_tpu_torch/app/viewer.py) on a CPU Engine of
the demo scene (480x270 traced, out at 32x16): the JAX viewer's page and
routes, input that moves the camera and sets a parameter, one decoded
frame of the multipart stream, a clean stop; a render-thread exception
answered by /stats with 500 and re-raised by stop(); `main` passes
--device to the Engine."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rtrt_tpu.app import viewer as JV
from rtrt_tpu.utils.config import PARAM_REGISTRY as JREG
from rtrt_tpu_torch.app import viewer as TV
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.utils.config import DynamicResolution, GlobalSettings
from rtrt_tpu_torch.utils.image import decode_png

torch.set_num_threads(2)
W, H = 32, 16
TIMEOUT = 120.0  # seconds: a CPU frame takes a few


@pytest.fixture(scope="module")
def engine():
    return Engine(GlobalSettings(scene="demo", render_width=W,
                                 render_height=H,
                                 dynamic_resolution=DynamicResolution(
                                     enabled=False)), device="cpu")


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=TIMEOUT) as r:
        return r.status, r.read()


def _post(base, obj):
    req = urllib.request.Request(base + "/input",
                                 data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status


def _stream_frame(base):
    """The first multipart part of /stream, decoded."""
    with urllib.request.urlopen(base + "/stream", timeout=TIMEOUT) as r:
        assert r.readline() == b"--f\r\n"
        assert r.readline() == b"Content-Type: image/png\r\n"
        n = int(r.readline().split(b":")[1])
        assert r.readline() == b"\r\n"
        return decode_png(r.read(n))


def _wait(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < TIMEOUT, f"timed out: {what}"
        time.sleep(0.05)


def test_viewer_serves_the_routes_and_stops(engine):
    v = TV.ViewerServer(engine, host="127.0.0.1", port=0).start()
    try:
        assert v.port != 0
        base = f"http://127.0.0.1:{v.port}"
        status, page = _get(base, "/")
        assert status == 200 and page.decode() == JV._PAGE
        _, body = _get(base, "/params")
        ps = json.loads(body)
        assert [(p["path"], p["label"], p["min"], p["max"]) for p in ps] == \
            [(r[0], r[1], r[3], r[4]) for r in JREG]
        for p in ps:
            assert p["min"] <= p["value"] <= p["max"], p
        img = _stream_frame(base)
        assert img.shape == (H, W, 3) and img.dtype == np.uint8

        pos0 = engine._camera_host()[:3].copy()
        assert _post(base, {"key": "w", "down": True}) == 204
        _wait(lambda: not np.array_equal(engine._camera_host()[:3], pos0),
              "the camera moves with 'w' held")
        assert _post(base, {"key": "w", "down": False}) == 204
        assert "w" not in engine._input["keys"]
        assert _post(base, {"param": "post.bloom_strength",
                            "value": 0.2}) == 204
        assert engine.params.post.bloom_strength == 0.2
        _, body = _get(base, "/stats")
        stats = json.loads(body)
        assert set(stats) == {"fps", "w", "h"}
        assert (stats["w"], stats["h"]) == (engine.render_w, engine.render_h)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(base, "/nothing")
    finally:
        v.stop()
    assert v.error is None and not v._threads


def test_render_thread_exception_is_kept_and_reraised(engine, monkeypatch):
    def broken(dt=None):
        raise RuntimeError("frame failed")

    monkeypatch.setattr(engine, "render_frame", broken)
    v = TV.ViewerServer(engine, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{v.port}"
    try:
        _wait(lambda: v.error is not None, "the render thread fails")
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/stats")
        assert e.value.code == 500
        assert "frame failed" in json.loads(e.value.read())["error"]
    finally:
        with pytest.raises(RuntimeError, match="frame failed"):
            v.stop()
    assert not v._threads


def test_main_passes_the_device(monkeypatch):
    """main builds the Engine from its flags (a stand-in records them) and
    serves it on --port."""
    from rtrt_tpu_torch.engine import engine as E

    class Recorder:
        def __init__(self, settings, device):
            self.settings, self.device = settings, device

    seen = {}
    monkeypatch.setattr(E, "Engine", Recorder)
    monkeypatch.setattr(TV.ViewerServer, "serve",
                        lambda self: seen.update(engine=self.engine,
                                                 port=self.port))
    TV.main(["--device", "cpu", "--scene", "terrain", "--width", str(W),
             "--height", str(H), "--port", "0"])
    eng = seen["engine"]
    assert eng.device == "cpu" and seen["port"] == 0
    s = eng.settings
    assert (s.scene, s.render_width, s.render_height) == ("terrain", W, H)
