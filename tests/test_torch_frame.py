"""The whole slice: the port's render_frame vs the JAX render_frame (static
branch, prebuilt SAH leaf-8 tables) at 32x16 on the demo scene, with the
first slice's flags (denoiser, bloom and lens flare off) and with the
default FeatureFlags() (the denoised product frame, three frames of a slow
pan so that the history is reprojected), plus the rule that the port never
imports JAX nor the JAX package.

The JAX frame on the CPU runs the wavefront integrator, not the megakernel
program; the two agree on ~98% of G-buffer pixels (tests/test_megakernel.py)
and a 1-spp path that diverges changes its pixel completely.  So the bound
is image-level: mean |delta| <= 2 LSB and >= 95% of pixels within 4 LSB on
every channel, for every frame (the second with adapted exposure).  The
denoised frames are held to the same bound: the denoiser averages the 1-spp
noise, so a diverged path moves its pixel less than without it."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.core.camera import make_camera
from rtrt_tpu.denoise.pipeline import init_history
from rtrt_tpu.engine import frame as JF
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.post.exposure import init_exposure_state
from rtrt_tpu.render.sky import bake_sky_maps, finalize_sky_maps, \
    make_sky_params
from rtrt_tpu.render.texture import make_soil_textures
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.bvh.packet import overflow_counter, pack_tables
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.denoise.pipeline import init_history as tinit_history
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.engine.scene import build_demo_scene as tdemo
from rtrt_tpu_torch.engine.scene import padded_arrays as tpadded
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import DynamicResolution, GlobalSettings
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

torch.set_num_threads(1)
W, H = 32, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _render_both(jflags, tflags, cams):
    """Render len(cams) - 1 frames of the demo scene in both packages, frame
    k from camera cams[k + 1] with cams[k] as the previous camera.
    Returns (JAX images, port images, the port's last G-buffer)."""
    host = build_demo_scene()
    pad = padded_arrays(host)
    prebuilt = jbuild(host.num_batches, pad["indices"], pad["tri_mat"],
                      pad["valid"], host.vertices, host.normals, leaf_max=8)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    static = JF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                            num_batches=host.num_batches, flags=jflags,
                            use_packets=False, use_megakernel=False,
                            sah_leaf=8)
    state = JF.FrameState(
        vertices=jnp.asarray(host.vertices), normals=jnp.asarray(host.normals),
        history=init_history(H, W, half=jflags.half_history),
        exposure=init_exposure_state(), frame_idx=jnp.uint32(0),
        time=jnp.float32(0.0))
    fn = JF.make_frame_fn(static)
    ref = []
    for prev, cam in zip(cams, cams[1:]):
        img, state = fn(jnp.asarray(pad["indices"]),
                        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
                        host.materials, make_soil_textures(16), sky,
                        host.lights, state, cam, prev, jparams(),
                        jnp.float32(1 / 60), prebuilt)
        ref.append(np.asarray(img))

    th = tdemo()
    tpad = tpadded(th)
    bvh, nrm, mat = build_scene_tables_sah(
        th.num_batches, tpad["indices"], tpad["tri_mat"], tpad["valid"],
        th.vertices, th.normals, leaf_max=8)
    scene = SceneData(tables=pack_tables(bvh, nrm, mat, bvh4_nodes(bvh)),
                      materials=th.materials, sky=interop.sky_from_jax(sky),
                      lights=th.lights)
    tstatic = TF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                             flags=tflags)
    history = (tinit_history(H, W, half=tflags.half_history, device="cpu")
               if tflags.denoise else None)
    tstate = TF.FrameState(exposure=interop.exposure_from_jax(
        init_exposure_state()), history=history)
    tcams = [interop.camera_from_jax(c) for c in cams]
    ovf = overflow_counter("cpu")
    got = []
    for prev, cam in zip(tcams, tcams[1:]):
        img, tstate, gbuf = TF.render_frame(tstatic, scene, tstate, cam,
                                            prev, tparams(), 1 / 60,
                                            overflow=ovf)
        got.append(img.numpy())
    assert int(ovf) == 0
    return ref, got, gbuf


@pytest.fixture(scope="module")
def frames():
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15, fov_y=1.1)
    return _render_both(JFlags(denoise=False, bloom=False, lens_flare=False),
                        TFlags(denoise=False, bloom=False, lens_flare=False),
                        [cam] * 3)


@pytest.fixture(scope="module")
def frames_default():
    """Default FeatureFlags(): denoised (with the history carried over three
    frames of a slow pan), bloomed, lens-flared, tone-mapped."""
    cams = [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(4)]
    return _render_both(JFlags(), TFlags(), cams)


def test_frame_matches_jax(frames):
    ref, got, _ = frames
    for r, g in zip(ref, got):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()


def test_default_frame_matches_jax(frames_default):
    ref, got, _ = frames_default
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()


def test_gbuffer_sane(frames):
    _, _, gbuf = frames
    for f in ("color", "albedo", "normal", "motion"):
        assert torch.isfinite(getattr(gbuf, f)).all(), f
    assert (gbuf.mat_id[: H // 4] == -1).float().mean() > 0.9   # sky rows
    assert (gbuf.mat_id[H // 2:] >= 0).all()                   # ground


def test_engine_refuses_unported_settings():
    flags = TFlags(denoise=False, bloom=False, lens_flare=False)
    dr = DynamicResolution(enabled=False)
    for kw in (dict(flags=TFlags(stars=True)),
               dict(flags=TFlags(fourier_textures=True)),
               dict(flags=TFlags(denoise=False, bloom=False,
                                 lens_flare=False, ocean=True)),
               dict(settings=GlobalSettings(scene="demo", interlace=True,
                                            dynamic_resolution=dr)),
               dict(settings=GlobalSettings(scene="demo")),
               dict(settings=GlobalSettings(scene="demo", sky_model="preetham",
                                            dynamic_resolution=dr)),
               dict(settings=GlobalSettings(scene="demo",
                                            load_camera_at_init=True,
                                            dynamic_resolution=dr)),
               dict(animation="wave")):
        kw.setdefault("flags", flags)
        kw.setdefault("settings", GlobalSettings(scene="demo",
                                                 dynamic_resolution=dr))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(device="cpu", **kw)


_NO_JAX = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import rtrt_tpu_torch
for m in pkgutil.walk_packages(rtrt_tpu_torch.__path__, "rtrt_tpu_torch."):
    importlib.import_module(m.name)
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings)
eng = Engine(GlobalSettings(scene="demo", render_width=32, render_height=16,
                            dynamic_resolution=DynamicResolution(
                                enabled=False)),
             flags=FeatureFlags(), device="cpu")
for _ in range(2):
    img = eng.render_frame(dt=1 / 60)
assert img.shape == (16, 32, 3) and img.dtype.name == "uint8", img.shape
assert eng.state.history.valid
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
jax_pkg = sorted(m for m in sys.modules
                 if m == "rtrt_tpu" or m.startswith("rtrt_tpu."))
assert not jax_pkg, jax_pkg
print("NO_JAX_OK")
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
