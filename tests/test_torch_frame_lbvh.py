"""The LBVH slice as a whole: the port's frame over the two-level LBVH that
it builds on the device, static and animated, against the JAX frame on the
same numpy inputs, at small sizes on the demo scene.

  * displace_wave (the vertex form) and compute_smooth_normals against the
    JAX functions run op by op (eager): within 1e-6 (segment sums may add
    in another order; under jit XLA may contract the wave's products into
    FMAs, so the jitted function is not the oracle here);
  * the static LBVH frame: three frames of a slow pan with the default
    FeatureFlags() against JAX's render_frame with the build_scene_tables
    tables prebuilt (its RTRT_SAH=0 path), at 32x16;
  * three animated frames (animation="wave", the rebuild every frame:
    displace, smooth normals, LBVH, tables) against JAX's render_frame with
    prebuilt=None and animation="wave" (its RTRT_REFIT=0 path, the only
    one it takes off a TPU), at 32x16, the clocks equal bit for bit;
  * Engine(bvh="lbvh") on the CPU at one bucket and interlaced, static and
    animated; an unknown bvh value raises.
The plain K2 on binary tables is held to JAX's simulator in
tests/test_torch_lbvh.py.
Frames are held to tests/test_torch_frame.py's image-level bound: mean
|delta| <= 2 LSB and >= 95% of pixels within 4 LSB on every channel,
every frame (the JAX frame on the CPU runs the wavefront integrator, not
the megakernel program, and a diverged 1-spp path changes its pixel)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from rtrt_tpu_torch.bvh import packet as P
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
DT = 1 / 60


def _t(a):
    """A CPU tensor of its own copy of numpy / JAX array a."""
    return torch.from_numpy(np.array(a))


def _sky():
    return finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))


def _port_mesh():
    """The demo scene's rest mesh and binary tables in the port (CPU)."""
    th = tdemo()
    pad = tpadded(th)
    mesh = TF.MeshPose(vertices=_t(th.vertices),
                       indices=_t(pad["indices"]).long(),
                       tri_mat=_t(pad["tri_mat"]), valid=_t(pad["valid"]))
    tables = P.pack_tables_binary(*TF.build_scene_tables(
        th.num_batches, mesh.indices, mesh.tri_mat, mesh.valid,
        mesh.vertices, _t(th.normals)))
    return th, mesh, tables


def _assert_images_close(ref, got):
    for r, g in zip(ref, got):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()


# ---------------------------------------------------------------------------
# the rebuild stage's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("time", [0.0, 0.05, 3.7])
def test_displace_wave_matches_jax(time):
    host = build_demo_scene()
    clock = np.float32(time)
    with jax.disable_jit():
        ref = np.asarray(JF.displace_wave(jnp.asarray(host.vertices), clock))
    got = TF.displace_wave(_t(host.vertices), float(clock)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.array_equal(got[:, 0::2], host.vertices[:, 0::2])


def test_compute_smooth_normals_matches_jax():
    host = build_demo_scene()
    pad = padded_arrays(host)
    verts = np.asarray(JF.displace_wave(jnp.asarray(host.vertices),
                                        np.float32(1.3)))
    with jax.disable_jit():
        ref = np.asarray(JF.compute_smooth_normals(
            jnp.asarray(verts), jnp.asarray(pad["indices"])))
    got = TF.compute_smooth_normals(_t(verts), _t(pad["indices"]).long())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    used = np.unique(pad["indices"][:host.indices.shape[0]])
    np.testing.assert_allclose(np.linalg.norm(got.numpy()[used], axis=1),
                               1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# whole frames: static and animated LBVH against the JAX frame
# ---------------------------------------------------------------------------


def _render_both(animated):
    """Three frames of a slow pan of the demo scene in both packages over
    the LBVH: static (prebuilt tables) or animated (rebuilt every frame).
    Returns (JAX images, port images, JAX clocks, port clocks, port
    tables, dropped pushes)."""
    cams = [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(4)]
    host = build_demo_scene()
    pad = padded_arrays(host)
    sky = _sky()
    static = JF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                            num_batches=host.num_batches, flags=JFlags(),
                            use_packets=False, use_megakernel=False,
                            sah_leaf=1,
                            animation="wave" if animated else "none")
    prebuilt = None if animated else jax.jit(
        JF.build_scene_tables, static_argnums=0)(
        host.num_batches, jnp.asarray(pad["indices"]),
        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
        jnp.asarray(host.vertices), jnp.asarray(host.normals))
    state = JF.FrameState(
        vertices=jnp.asarray(host.vertices), normals=jnp.asarray(host.normals),
        history=init_history(H, W), exposure=init_exposure_state(),
        frame_idx=jnp.uint32(0), time=jnp.float32(0.0))
    fn = JF.make_frame_fn(static)
    ref, jclock = [], []
    for prev, cam in zip(cams, cams[1:]):
        jclock.append(np.float32(state.time))
        img, state = fn(jnp.asarray(pad["indices"]),
                        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
                        host.materials, make_soil_textures(16), sky,
                        host.lights, state, cam, prev, jparams(),
                        jnp.float32(DT), prebuilt)
        ref.append(np.asarray(img))

    th, mesh, tables = _port_mesh()
    scene = SceneData(tables=tables, materials=th.materials,
                      sky=interop.sky_from_jax(sky, "cpu"), lights=th.lights)
    tstatic = TF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                             flags=TFlags())
    tstate = TF.FrameState(
        exposure=interop.exposure_from_jax(init_exposure_state(), "cpu"),
        history=tinit_history(H, W, device="cpu"))
    tcams = [interop.camera_from_jax(c, "cpu") for c in cams]
    ovf = P.overflow_counter("cpu")
    got, tclock = [], []
    for prev, cam in zip(tcams, tcams[1:]):
        tclock.append(tstate.time)
        img, tstate, _ = TF.render_frame(
            tstatic, scene, tstate, cam, prev, tparams(), DT, overflow=ovf,
            rest=mesh if animated else None)
        got.append(img.numpy())
    return dict(ref=ref, got=got, jclock=jclock, tclock=tclock,
                tables=tables, mesh=mesh, ovf=int(ovf))


def test_static_lbvh_frame_matches_jax():
    out = _render_both(animated=False)
    assert len(out["got"]) == 3 and out["ovf"] == 0
    _assert_images_close(out["ref"], out["got"])


def test_animated_lbvh_frames_match_jax_rebuild():
    """The JAX frame rebuilds its LBVH from the displaced vertices and their
    recomputed normals inside the frame (prebuilt=None): a direct oracle of
    the animated frame.  The port's tables hold the last frame's rebuild,
    written in place (the tensors keep their storage)."""
    out = _render_both(animated=True)
    assert len(out["got"]) == 3 and out["ovf"] == 0
    for j, t in zip(out["jclock"], out["tclock"]):
        assert np.float32(t).tobytes() == j.tobytes()
    _assert_images_close(out["ref"], out["got"])
    # the tables equal a fresh build at the last frame's clock
    tables, mesh = out["tables"], out["mesh"]
    last = out["tclock"][-1]
    verts = TF.displace_wave(mesh.vertices, last)
    fresh = P.pack_tables_binary(*TF.build_scene_tables(
        mesh.valid.shape[0], mesh.indices, mesh.tri_mat, mesh.valid, verts,
        TF.compute_smooth_normals(verts, mesh.indices)))
    for f in ("nodes", "tris", "nrm", "ng", "mat"):
        assert torch.equal(getattr(tables, f), getattr(fresh, f)), f
    assert (tables.levels, tables.stack) == (fresh.levels, fresh.stack)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------


def test_engine_refuses_an_unknown_bvh():
    with pytest.raises(ValueError, match="bvh='bvh8'"):
        Engine(GlobalSettings(scene="demo"), bvh="bvh8", device="cpu")


@pytest.mark.parametrize("animation", ["none", "wave"])
def test_lbvh_engine_at_one_bucket_and_interlaced(animation):
    """Engine(bvh="lbvh") at the 270 bucket with interlace: a static frame,
    or two animated ones, with no dropped push and the clock in float32;
    the animated Engine keeps its rest mesh and rebuilds into the same
    tensors, and a field's traced rows equal the full-rate frame's rows
    rendered from the same state (the rebuild writes the same tables for
    the same clock)."""
    eng = Engine(GlobalSettings(scene="demo", render_width=480,
                                render_height=270, interlace=True,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 flags=TFlags(), animation=animation, bvh="lbvh",
                 device="cpu")
    tables = eng.scene_data.tables
    assert tables.arity == 2 and tables.stack == 256
    assert (eng.rest is None) == (animation == "none")
    ptrs = {f: getattr(tables, f).data_ptr()
            for f in ("nodes", "tris", "nrm", "ng", "mat")}
    nodes0 = tables.nodes.clone()
    t = 0.0
    for _ in range(2 if eng.rest is not None else 1):
        img = eng.render_frame(dt=DT)
        t = TF.advance_clock(t, DT)
        assert img.shape == (270, 480, 3) and img.dtype == np.uint8
    assert eng.state.time == t and int(eng.overflow) == 0
    assert all(getattr(tables, f).data_ptr() == p for f, p in ptrs.items())
    assert torch.equal(tables.nodes, nodes0) == (eng.rest is None)
    if eng.rest is None:
        return

    full = dataclasses.replace(eng.static, interlace=False)
    out = {}
    for static in (full, eng.static):
        _, _, out[static.interlace] = TF.render_frame(
            static, eng.scene_data, eng.state, eng.camera, eng.prev_camera,
            eng.params, DT, TF.make_frame_consts(static, "cpu"),
            rest=eng.rest)
    p = eng.state.frame_idx & 1
    for f in ("color", "albedo", "normal", "depth", "motion", "mat_id"):
        a, b = getattr(out[True], f), getattr(out[False], f)[p::2]
        assert torch.equal(a, b), f
