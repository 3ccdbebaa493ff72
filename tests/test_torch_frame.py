"""The whole slice: the port's render_frame vs the JAX render_frame (static
branch, prebuilt SAH leaf-8 tables) at 32x16 on the demo scene, with the
first slice's flags (denoiser, bloom and lens flare off) and with the
default FeatureFlags() (the denoised product frame, three frames of a slow
pan so that the history is reprojected), plus the rule that the port never
imports JAX nor the JAX package.  The JAX frame's prebuilt tables are the
flat binary SAH tree (nodes4=None; its CPU frame traces that tree), so the
port's frame over its BVH4 collapse and over the same flat tree
(bvh="sah2", bvh/packet.py::pack_tables_sah2) are both held to it.

The JAX frame on the CPU runs the wavefront integrator, not the megakernel
program; the two agree on ~98% of G-buffer pixels (tests/test_megakernel.py)
and a 1-spp path that diverges changes its pixel completely.  So the bound
is image-level: mean |delta| <= 2 LSB and >= 95% of pixels within 4 LSB on
every channel, for every frame (the second with adapted exposure).  The
denoised frames are held to the same bound: the denoiser averages the 1-spp
noise, so a diverged path moves its pixel less than without it.

The port's wavefront frames (engine/engine.py's trace="packets" and
"loop", JAX's own route) render beside the megakernel frame from the same
tables and are held tighter: within 1 LSB of JAX's on every pixel where
JAX's compiled program follows its own op-by-op values, and within 1 LSB
of the port's megakernel frame on every pixel of every frame (the
wavefront tests below say where and why JAX's compiled frame leaves
them).

The row-sharded frame (rtrt_tpu_torch/parallel/frame_spmd.py) renders
the two denoised fixtures' frames over 2 and over 4 gloo ranks on the CPU
(and the loop route's first frame over 2), each rank carrying its band of
the history: within 1 u8 of the port's single-process frames on every
pixel with < 5% differing (measured: bit-equal), and held to JAX's images
at this file's bound; and the default frame shown at a larger screen
(the band's upscale rows), with and without the post chain, and
interlaced, against the port's single-process frame.  No new JAX compile: the fixtures hold JAX's
images."""

import dataclasses
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
from rtrt_tpu_torch.bvh.packet import (overflow_counter, pack_tables,
                                       pack_tables_sah2)
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.denoise.pipeline import init_history as tinit_history
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.engine.scene import build_demo_scene as tdemo
from rtrt_tpu_torch.engine.scene import padded_arrays as tpadded
from rtrt_tpu_torch.parallel.frame_spmd import spawn
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import DynamicResolution, GlobalSettings
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

import torch_spmd_cases as spmd_cases

torch.set_num_threads(1)
W, H = 32, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _render_both(jflags, tflags, cams, screen=(W, H), sah2=False):
    """Render len(cams) - 1 frames of the demo scene in both packages, frame
    k from camera cams[k + 1] with cams[k] as the previous camera, at
    W x H, out at `screen` (width, height).
    Returns (JAX images, the port's megakernel images, the port's last
    megakernel G-buffer, more): `more` maps "packets" and "loop" to the
    port's wavefront images (trace routes of engine/engine.py, over the
    BVH4 tables and over the flat SAH tree they collapse), with sah2,
    "sah2" to its megakernel images over the flat binary tables, and
    "inputs" to the port's frame inputs (the megakernel and loop
    FrameStatic, the scene, the first FrameState, cameras and params)."""
    sw, sh = screen
    host = build_demo_scene()
    pad = padded_arrays(host)
    prebuilt = jbuild(host.num_batches, pad["indices"], pad["tri_mat"],
                      pad["valid"], host.vertices, host.normals, leaf_max=8)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    static = JF.FrameStatic(render_w=W, render_h=H, screen_w=sw, screen_h=sh,
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
    tstatic = TF.FrameStatic(render_w=W, render_h=H, screen_w=sw,
                             screen_h=sh, flags=tflags)
    tcams = [interop.camera_from_jax(c, "cpu") for c in cams]
    bvh4 = pack_tables(bvh, nrm, mat, bvh4_nodes(bvh))
    runs = [("megakernel", bvh4, tstatic),
            ("packets", bvh4, dataclasses.replace(tstatic,
                                                  use_megakernel=False)),
            ("loop", bvh4, dataclasses.replace(
                tstatic, use_megakernel=False, use_packets=False))]
    if sah2:
        runs.append(("sah2", pack_tables_sah2(bvh, nrm, mat), tstatic))
    imgs, gbufs, scenes = {}, {}, {}
    for name, tables, static in runs:
        scene = scenes[name] = SceneData(
            tables=tables, materials=th.materials,
            sky=interop.sky_from_jax(sky, "cpu"), lights=th.lights, bvh=bvh,
            tri_nrm_t=nrm, tri_mat=mat)
        history = (tinit_history(H, W, half=tflags.half_history,
                                 device="cpu") if tflags.denoise else None)
        tstate = first = TF.FrameState(exposure=interop.exposure_from_jax(
            init_exposure_state(), "cpu"), history=history)
        ovf = overflow_counter("cpu")
        got = []
        for prev, cam in zip(tcams, tcams[1:]):
            img, tstate, gbufs[name] = TF.render_frame(
                static, scene, tstate, cam, prev, tparams(), 1 / 60,
                overflow=ovf)
            got.append(img.numpy())
        assert int(ovf) == 0
        imgs[name] = got
    more = {k: v for k, v in imgs.items() if k != "megakernel"}
    more["inputs"] = dict(static=tstatic, loop_static=runs[2][2],
                          scene=scenes["megakernel"], state=first,
                          cams=tcams, params=tparams())
    return ref, imgs["megakernel"], gbufs["megakernel"], more


@pytest.fixture(scope="module")
def frames():
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15, fov_y=1.1)
    return _render_both(JFlags(denoise=False, bloom=False, lens_flare=False),
                        TFlags(denoise=False, bloom=False, lens_flare=False),
                        [cam] * 3, sah2=True)


@pytest.fixture(scope="module")
def frames_default():
    """Default FeatureFlags(): denoised (with the history carried over three
    frames of a slow pan), bloomed, lens-flared, tone-mapped."""
    cams = [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(4)]
    return _render_both(JFlags(), TFlags(), cams)


@pytest.fixture(scope="module")
def frames_no_temporal():
    """FeatureFlags(temporal_filter=False) with the default second temporal
    pass, which fetches its history through the ±1 px shift stencil:
    three frames of the slow pan of frames_default, the second and third
    on valid history.  The port's megakernel frame is held over the first
    two: on frame index 2 of this scene the JAX CPU frame's wavefront
    integrator and the port's megakernel diverge on ~1.2% of the raw
    pixels (up to 206 LSB without the denoiser, within the bound), and the
    spatial filters alone, with no first temporal pass to average them,
    spread those pixels' differences to ~5.5% of the image beyond 4 LSB
    (up to 30 LSB), with either camera.  The port's wavefront frames, JAX's
    own route, are held over all three.  The chain itself is held on
    identical inputs over three frames by
    tests/test_torch_denoise_fetch.py."""
    cams = [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(4)]
    return _render_both(JFlags(temporal_filter=False),
                        TFlags(temporal_filter=False), cams)


def _assert_images_close(ref, got):
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()


def test_frame_matches_jax(frames):
    _assert_images_close(frames[0], frames[1])


def test_sah2_frame_matches_jax(frames):
    """The port's frame over the flat binary tree that the JAX frame
    traces (bvh="sah2")."""
    _assert_images_close(frames[0], frames[3]["sah2"])


def test_default_frame_matches_jax(frames_default):
    ref, got, _, _ = frames_default
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()


def test_no_temporal_filter_frame_matches_jax(frames_no_temporal):
    """The flags that raised before the stencil fetch was ported render,
    each frame held to JAX's at the image bound."""
    ref, got, _, _ = frames_no_temporal
    assert len(got) == 3
    _assert_images_close(ref[:2], got[:2])


def _lsb(a, b):
    """Per-pixel largest channel difference of two u8 images, in LSB."""
    return np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)


def _assert_wavefront(fx, route, jitted_ok):
    """The port's wavefront frames (trace route `route`) of a fixture: each
    within 1 LSB of the port's megakernel frame on every pixel, and of
    JAX's frame on every pixel for the frames in `jitted_ok`; the others
    at the file's mean bound (see the tests below)."""
    ref, mega, _, more = fx
    got = more[route]
    assert len(got) == len(ref) == len(mega)
    for k, (r, m, g) in enumerate(zip(ref, mega, got)):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        assert (_lsb(m, g) <= 1).all(), (route, k)
        d = _lsb(r, g)
        if k in jitted_ok:
            assert d.max() <= 1, (route, k, d.max())
        else:
            assert d.mean() <= 2.0, (route, k, d.mean())


@pytest.mark.parametrize("route", ["packets", "loop"])
def test_wavefront_frame_matches_jax(frames, route):
    """The port's wavefront frame, JAX's own route (trace="packets": K1's
    plain version over the BVH4; trace="loop": the loop traverser over
    the flat SAH tree), held to the JAX frame within 1 LSB on every pixel
    of both frames: tighter than the file's image bound (mean <= 2 LSB,
    >= 95% within 4).  Measured: max 1 LSB, mean 0.043 (tone-mapping
    rounding of radiance that agrees to ~1e-5)."""
    _assert_wavefront(frames, route, jitted_ok=(0, 1))


@pytest.mark.parametrize("route", ["packets", "loop"])
def test_wavefront_default_frame_matches_jax(frames_default, route):
    """The denoised frames: frame indices 0 and 1 within 1 LSB of JAX's on
    every pixel (measured max 1); frame index 2 at the file's bound
    (measured mean 0.46 LSB, 98.2% within 4 LSB, max 19).  At frame index
    2, JAX's frame program, compiled whole by XLA, diverges from the same
    path tracer run op by op, which the port matches to 1.1e-5 on every
    raw pixel: XLA's CPU backend contracts the shading's products into
    FMAs, and 1.2% of the 1-spp paths sit at the shadow-or-scatter
    decision boundary (tests/test_torch_wavefront.py).  The port's
    megakernel frames equal the wavefront's within 1 LSB, so the spread
    is JAX's compile, not the route."""
    ref, _, _, more = frames_default
    _assert_wavefront(frames_default, route, jitted_ok=(0, 1))
    _assert_images_close(ref[2:], more[route][2:])


@pytest.mark.parametrize("route", ["packets", "loop"])
def test_wavefront_no_temporal_frame_matches_jax(frames_no_temporal, route):
    """temporal_filter=False over all three frames: frame indices 0 and 1
    within 1 LSB of JAX's on every pixel (measured max 1); frame index 2
    within the file's mean bound, <= 2 LSB (measured 0.97).  Its share
    within 4 LSB is 94.5%, below the file's 95%, on either route and on
    the megakernel alike: the 1.2% of raw pixels where XLA's compiled JAX
    program leaves its own op-by-op values (test above) are spread by the
    spatial filters, with no first temporal pass to average them, to
    ~5.5% of the image.  So frame index 2 is held like for like to the
    port's megakernel frame (within 1 LSB on every pixel) and to JAX's at
    the mean bound."""
    _assert_wavefront(frames_no_temporal, route, jitted_ok=(0, 1))


@pytest.fixture(scope="module")
def sharded(frames_default, frames_no_temporal, tmp_path_factory):
    """The two denoised fixtures' frames through the row-sharded frame
    (parallel/frame_spmd.py) over 2 and over 4 gloo ranks on the CPU
    (tests/torch_spmd_cases.py::sharded_frames), with the history carried
    band-sharded, with 2 ranks the first loop-route frame of
    frames_default, and frames_default's frames at a larger screen and
    interlaced (_variants).  {ranks: [each rank's results]}."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = {}
    for world in (2, 4):
        runs = {}
        for name, fx in (("default", frames_default),
                         ("no_temporal", frames_no_temporal)):
            inp = fx[3]["inputs"]
            runs[name] = dict(inp, frames=3)
        if world == 2:
            inp = frames_default[3]["inputs"]
            runs["loop"] = dict(inp, static=inp["loop_static"], frames=1)
        for name, static in _variants(frames_default).items():
            runs[name] = dict(frames_default[3]["inputs"], static=static,
                              frames=VARIANT_FRAMES[name])
        torch.save(runs, tmp / f"in{world}.pt")
        spawn(spmd_cases.sharded_frames, world,
              (str(tmp / f"in{world}.pt"), str(tmp / f"out{world}_")),
              device="cpu")
        out[world] = [torch.load(tmp / f"out{world}_{r}", weights_only=False)
                      for r in range(world)]
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fixture,name", [("frames_default", "default"),
                                          ("frames_no_temporal",
                                           "no_temporal")])
def test_sharded_frame_matches_single(sharded, request, fixture, name,
                                      world):
    """The row-sharded frame: rank 0's gathered images within 1 u8 of the
    port's single-process frames on every pixel and differing on < 5%
    (measured: bit-equal), over the three frames of the slow pan; each
    rank's history (H / ranks, W) rows, 0 dropped pushes; and held to
    JAX's images at this file's bound over the frames that the fixture's
    own test holds (all three; the first two without the first temporal
    pass, as test_no_temporal_filter_frame_matches_jax says why)."""
    ref, mega, _, _ = request.getfixturevalue(fixture)
    recs = sharded[world]
    got = [g.numpy() for g in recs[0][name]["images"]]
    assert len(got) == len(mega) == 3
    for k, (m, g) in enumerate(zip(mega, got)):
        d = _lsb(m, g)
        assert d.max() <= 1 and (d > 0).mean() < 0.05, (k, d.max())
    for rec in recs:
        assert rec[name]["history"] == (H // world, W, 3)
        assert rec[name]["overflow"] == 0
    _assert_images_close(ref if name == "default" else ref[:2],
                         got if name == "default" else got[:2])


VARIANT_FRAMES = {"upscale": 2, "upscale_nopost": 1, "interlace": 2}


def _variants(frames_default):
    """frames_default's megakernel frame shown at a 48x24 screen (the
    Catmull-Rom upscale from 32x16), with and without the post chain, and
    interlaced (half the rows traced a frame)."""
    st = frames_default[3]["inputs"]["static"]
    up = dataclasses.replace(st, screen_w=48, screen_h=24)
    return {"upscale": up,
            "upscale_nopost": dataclasses.replace(
                up, flags=dataclasses.replace(up.flags, postprocess=False)),
            "interlace": dataclasses.replace(st, interlace=True)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(VARIANT_FRAMES))
def test_sharded_frame_variants_match_single(sharded, frames_default, world,
                                             name):
    """What a band reads beyond its rows in the other shapes of the frame:
    below the screen size the upscale's rows (3 render rows a side at 16
    -> 24 rows; over 4 ranks the bands are 4 render and 6 screen rows),
    and interlaced the traced rows of the whole field that the fill
    reads.  Rank 0's gathered images within 1 u8 of the port's
    single-process frames of the same static on every pixel, < 5%
    differing (bit-equality expected), over the fixture's slow pan."""
    inp = frames_default[3]["inputs"]
    static = _variants(frames_default)[name]
    cams = inp["cams"][:VARIANT_FRAMES[name] + 1]
    state, want = inp["state"], []
    for prev, cam in zip(cams, cams[1:]):
        img, state, _ = TF.render_frame(static, inp["scene"], state, cam,
                                        prev, inp["params"], 1 / 60)
        want.append(img.numpy())
    got = [g.numpy() for g in sharded[world][0][name]["images"]]
    assert len(got) == len(want)
    for k, (w, g) in enumerate(zip(want, got)):
        assert g.shape == (static.screen_h, static.screen_w, 3), g.shape
        d = _lsb(w, g)
        assert d.max() <= 1 and (d > 0).mean() < 0.05, (k, d.max())


def test_sharded_loop_frame_matches_single(sharded, frames_default):
    """The wavefront's loop route row-sharded over 2 ranks: the first
    frame within 1 u8 of the port's single-process loop frame on every
    pixel (measured: bit-equal) and of JAX's (test_wavefront_default_
    frame_matches_jax holds frame index 0 so)."""
    ref, _, _, more = frames_default
    got = sharded[2][0]["loop"]["images"]
    assert len(got) == 1
    assert _lsb(more["loop"][0], got[0].numpy()).max() <= 1
    assert _lsb(ref[0], got[0].numpy()).max() <= 1


def test_gbuffer_sane(frames):
    gbuf = frames[2]
    for f in ("color", "albedo", "normal", "motion"):
        assert torch.isfinite(getattr(gbuf, f)).all(), f
    assert (gbuf.mat_id[: H // 4] == -1).float().mean() > 0.9   # sky rows
    assert (gbuf.mat_id[H // 2:] >= 0).all()                   # ground


def test_engine_refuses_unported_settings():
    """Interlace, dynamic resolution, load_camera_at_init, animation="wave",
    the ocean and star flags, fourier_textures and sky_model="preetham" are
    ported (tests/test_torch_interlace.py, test_torch_engine_shell.py,
    test_engine_dynamic_resolution_renders below, test_torch_frame_wave.py,
    test_torch_environment.py, test_torch_engine_optin.py); another
    animation is not."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(GlobalSettings(scene="demo", dynamic_resolution=
                              DynamicResolution(enabled=False)),
               TFlags(denoise=False, bloom=False, lens_flare=False),
               animation="spin", device="cpu")


def test_engine_dynamic_resolution_renders():
    """The default settings' dynamic resolution on the demo scene: a slow
    frame (dt 1/20 s, below target_fps - deadband) drops the bucket from
    360 to 270 rows, a fast one (1/200 s) climbs back; every image comes
    out at the settings' 640x360, the history follows the bucket."""
    eng = Engine(GlobalSettings(scene="demo", render_width=640,
                                render_height=360),
                 flags=TFlags(), device="cpu")
    assert eng.settings.dynamic_resolution.enabled
    seen = [(eng.render_w, eng.render_h)]
    for dt in (1 / 20, 1 / 200):
        img = eng.render_frame(dt=dt)
        assert img.shape == (360, 640, 3) and img.dtype == np.uint8
        seen.append((eng.render_w, eng.render_h))
        hist = eng.state.history
        assert hist.color.shape == (eng.render_h, eng.render_w, 3)
        assert not hist.valid  # a switch starts an empty history
    assert seen == [(640, 360), (480, 270), (640, 360)]
    assert int(eng.overflow) == 0


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
