"""The opt-in settings through the port's entry point, Engine, on the CPU
(plain versions).  One Engine takes all three, as a user may:
GlobalSettings(sky_model="preetham"), FeatureFlags(fourier_textures=True)
and bvh="sah2", on the demo scene with its floor (material 1) marked
textured (the scene's own materials are untextured).  Its init builds the
flat SAH tables, fits the soil set and bakes the sky (with the env fit,
a 131,072-row float64 least-squares solve, the Engine's costliest part on
a CPU: hence one Engine); its scene then renders 32x16 frames through
engine/frame.py::render_frame with its flags, fit and state, denoiser,
bloom and flare off (its own frames start at the 480x270 bucket, minutes
of plain traversal here).

  * the sky map is the Preetham bake of the Engine's own parameters; the
    frame is finite uint8;
  * the soil set of texture_size is fitted at init
    (init_seconds["textures"]), equal to the fit of render/texture.py's
    set, K2's table of it made there on the Engine's device, and the pair
    rides FrameStatic.ftex; the frame's traced albedo on the textured
    floor differs from the same frame's without the fit;
  * an unknown sky_model raises ValueError at init, naming the setting;
  * the flat binary SAH tables: no dropped push, the deepest stack within
    their levels; with animation="wave" bvh="sah2" raises, naming
    bvh='lbvh', the JAX Engine's per-frame rebuild for RTRT_SAH=2.
The frame of sah2 against JAX's is in tests/test_torch_frame.py; the
Fourier branch of the plain K2 against JAX's simulator in
tests/test_torch_ftex_megakernel.py; the Preetham bake in
tests/test_torch_preetham.py.
"""

import dataclasses

import pytest
import torch

from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.engine.scene import build_demo_scene
from rtrt_tpu_torch.render.ftex import fit_soil_fourier, pack_ftex
from rtrt_tpu_torch.render.sky import bake_sky_maps
from rtrt_tpu_torch.render.texture import make_soil_textures
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings)

torch.set_num_threads(1)
FLAGS = dict(denoise=False, bloom=False, lens_flare=False)


def _engine(flags=FeatureFlags(**FLAGS), **kw):
    settings = GlobalSettings(
        scene="demo", texture_size=32, sky_model="preetham",
        dynamic_resolution=DynamicResolution(enabled=False))
    return Engine(settings, flags, device="cpu", **kw)


@pytest.fixture(scope="module")
def eng():
    host = build_demo_scene()
    tex = host.materials.textured.clone()
    tex[1] = 1
    host = dataclasses.replace(host, materials=dataclasses.replace(
        host.materials, textured=tex))
    return _engine(FeatureFlags(fourier_textures=True, **FLAGS),
                   scene=host, bvh="sah2")


def _frame(eng, ftex=None):
    """A 32x16 frame of the Engine's scene from its camera: (image,
    G-buffer)."""
    static = TF.FrameStatic(render_w=32, render_h=16, screen_w=32,
                            screen_h=16, flags=eng.flags, ftex=ftex)
    img, _, gbuf = TF.render_frame(
        static, eng.scene_data, TF.FrameState(exposure=eng.state.exposure),
        eng.camera, eng.prev_camera, eng.params, 1 / 60,
        overflow=eng.overflow, stack_depth=eng.stack_depth)
    assert img.shape == (16, 32, 3) and img.dtype == torch.uint8
    assert int(eng.overflow) == 0
    return img, gbuf


def test_preetham_engine(eng):
    sky = eng.scene_data.sky
    assert torch.equal(sky.sky_map, bake_sky_maps(sky.params,
                                                  model="preetham").sky_map)
    _, gbuf = _frame(eng, eng.ftex)
    assert torch.isfinite(gbuf.color).all()


def test_fourier_textures_engine(eng):
    assert eng.init_seconds["textures"] > 0
    assert eng.ftex.fit == fit_soil_fourier(make_soil_textures(32,
                                                               device="cpu"))
    assert eng.ftex.table.device == eng.device
    assert torch.equal(eng.ftex.table, torch.from_numpy(pack_ftex(
        eng.ftex.fit)))
    assert eng.static.ftex is eng.ftex
    _, fitted = _frame(eng, eng.ftex)
    _, soil = _frame(eng)
    floor = (fitted.mat_id == 1) & (soil.mat_id == 1)
    assert floor.float().mean() > 0.2
    diff = (fitted.albedo - soil.albedo).abs().amax(-1) > 1e-3
    assert diff[floor].float().mean() > 0.5


def test_sah2_engine(eng):
    tables = eng.scene_data.tables
    assert (tables.kind, tables.leaf_width, tables.stack) == ("sah2", 8, 32)
    assert eng.init_seconds["sah2"] > 0
    eng.stack_depth.zero_()
    _frame(eng, eng.ftex)
    assert 0 < int(eng.stack_depth) <= tables.levels


def test_sah2_refuses_animation():
    with pytest.raises(ValueError, match="bvh='lbvh'"):
        _engine(bvh="sah2", animation="wave")


def test_engine_refuses_an_unknown_sky_model():
    with pytest.raises(ValueError, match="sky_model='preethem'"):
        Engine(GlobalSettings(scene="demo", sky_model="preethem"),
               device="cpu")
