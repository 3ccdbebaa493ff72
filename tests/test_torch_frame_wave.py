"""The animated slice as a whole: the port's render_frame with
FrameStatic(animation="wave") — per frame the wave displacement of the
sorted rest-pose rows, the normal transform, the BVH4 refit and the
in-place table refresh, then the product frame — against a JAX static
frame of the same displaced geometry, at 32x16 on the demo scene, three
frames of a slow pan with the default FeatureFlags().

JAX's own refit branch cannot be the oracle on the CPU: there its frame
runs the wavefront integrator over the binary boxes of `prebuilt`, and the
refit branch replaces only the triangle rows, so that traversal would read
stale boxes.  So the JAX frame gets, per frame, fresh SAH leaf-8 tables
(`build_scene_tables_sah`) of the vertices displaced by its displace_wave
at the same float32 clock, with the vertex normals transformed by its
wave_normal_rows; its trees differ from the port's refitted one (refit vs
a fresh SAH build), the triangles and normals do not, so only ties move.
The bound is tests/test_torch_frame.py's image-level one: mean |delta| <=
2 LSB and >= 95% of pixels within 4 LSB on every channel, every frame.
The clocks of the two frames must agree bit for bit."""

import dataclasses
import types

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
from rtrt_tpu_torch.bvh.refit import DeviceRefit, plan_refit4
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.denoise.pipeline import init_history as tinit_history
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.scene import build_demo_scene as tdemo
from rtrt_tpu_torch.engine.scene import padded_arrays as tpadded
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

torch.set_num_threads(1)
W, H = 32, 16
DT = 1 / 60


def _jax_prebuilt(host, pad, t):
    """JAX SAH tables of the demo scene displaced at clock t."""
    verts = JF.displace_wave(jnp.asarray(host.vertices), jnp.float32(t))
    p = jnp.asarray(host.vertices).T
    n = jnp.asarray(host.normals).T
    nrm = JF.wave_normal_rows(jnp.concatenate([n, n, n]),
                              jnp.concatenate([p, p, p]),
                              jnp.float32(t))[0:3].T
    return jbuild(host.num_batches, pad["indices"], pad["tri_mat"],
                  pad["valid"], np.asarray(verts), np.asarray(nrm),
                  leaf_max=8)


def _pad_nodes(prebuilt, m):
    """Pad the binary tree to m nodes (unreferenced rows) so that every
    frame's tables have one shape and the frame compiles once."""
    bvh, nrm, mat = prebuilt
    k = m - bvh.boxes_t.shape[1]
    bvh = bvh._replace(
        boxes_t=jnp.pad(bvh.boxes_t, ((0, 0), (0, k))),
        children_t=jnp.pad(bvh.children_t, ((0, 0), (0, k)),
                           constant_values=-1))
    return bvh, nrm, mat


@pytest.fixture(scope="module")
def frames():
    cams = [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(4)]
    n = len(cams) - 1
    clock = [0.0]
    for _ in range(n):
        clock.append(TF.advance_clock(clock[-1], DT))

    host = build_demo_scene()
    pad = padded_arrays(host)
    pre = [_jax_prebuilt(host, pad, clock[k]) for k in range(n)]
    m = max(p[0].boxes_t.shape[1] for p in pre)
    pre = [_pad_nodes(p, m) for p in pre]
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    jflags = JFlags()
    static = JF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                            num_batches=host.num_batches, flags=jflags,
                            use_packets=False, use_megakernel=False,
                            sah_leaf=8)
    state = JF.FrameState(
        vertices=jnp.asarray(host.vertices), normals=jnp.asarray(host.normals),
        history=init_history(H, W), exposure=init_exposure_state(),
        frame_idx=jnp.uint32(0), time=jnp.float32(0.0))
    fn = JF.make_frame_fn(static)
    ref, jclock = [], []
    for k, (prev, cam) in enumerate(zip(cams, cams[1:])):
        jclock.append(np.float32(state.time))
        img, state = fn(jnp.asarray(pad["indices"]),
                        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
                        host.materials, make_soil_textures(16), sky,
                        host.lights, state, cam, prev, jparams(),
                        jnp.float32(DT), pre[k])
        ref.append(np.asarray(img))
    jclock.append(np.float32(state.time))

    th = tdemo()
    tpad = tpadded(th)
    bvh, nrm, mat = build_scene_tables_sah(
        th.num_batches, tpad["indices"], tpad["tri_mat"], tpad["valid"],
        th.vertices, th.normals, leaf_max=8)
    raw = bvh4_nodes(bvh)
    tables = pack_tables(bvh, nrm, mat, raw)
    rest = TF.RestPose(tris_t=bvh.tris_t.contiguous(),
                       nrm_t=nrm.contiguous(),
                       refit=DeviceRefit(plan_refit4(raw), "cpu"))
    scene = SceneData(tables=tables, materials=th.materials,
                      sky=interop.sky_from_jax(sky, "cpu"), lights=th.lights)
    tstatic = TF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                             flags=TFlags())
    tstate = TF.FrameState(
        exposure=interop.exposure_from_jax(init_exposure_state(), "cpu"),
        history=tinit_history(H, W, device="cpu"))
    tcams = [interop.camera_from_jax(c, "cpu") for c in cams]
    ovf = overflow_counter("cpu")
    got, tclock = [], []
    for prev, cam in zip(tcams, tcams[1:]):
        tclock.append(tstate.time)
        img, tstate, _ = TF.render_frame(tstatic, scene, tstate, cam, prev,
                                         tparams(), DT, overflow=ovf,
                                         rest=rest)
        got.append(img.numpy())
    tclock.append(tstate.time)
    return dict(ref=ref, got=got, jclock=jclock, tclock=tclock, ovf=ovf,
                tables=tables, levels=(tables.levels, tables.stack),
                raw=raw, rest=rest)


def test_animated_frame_matches_jax_static_frame_of_displaced_geometry(
        frames):
    assert len(frames["got"]) == 3
    for r, g in zip(frames["ref"], frames["got"]):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()
    assert int(frames["ovf"]) == 0


def test_animated_frame_clock_and_tables(frames):
    """The clocks agree bit for bit; the tables hold the last frame's
    refit (time 2 dt), in place, with the frozen topology."""
    for j, t in zip(frames["jclock"], frames["tclock"]):
        assert np.float32(t).tobytes() == j.tobytes()
    tables, rest = frames["tables"], frames["rest"]
    assert (tables.levels, tables.stack) == frames["levels"]
    last = frames["tclock"][-2]
    tt = TF.displace_wave_rows(rest.tris_t, last)
    nodes = torch.from_numpy(frames["raw"].copy())
    DeviceRefit(plan_refit4(frames["raw"]), "cpu").refit(nodes, tt)
    assert torch.equal(tables.nodes, nodes)
    ref = pack_tables(types.SimpleNamespace(tris_t=tt),
                      TF.wave_normal_rows(rest.nrm_t, rest.tris_t, last),
                      tables.mat, frames["raw"])
    for f in ("tris", "nrm", "ng"):
        assert torch.equal(getattr(tables, f), getattr(ref, f)), f
    # the rest pose itself is not written
    assert not torch.equal(tt, rest.tris_t)



def test_animated_engine_at_every_bucket_and_interlaced():
    """Engine(animation="wave") with dynamic resolution and interlace: the
    refit runs at each bucket the controller picks (360 -> 270 -> 360),
    the clock advances in float32, no push is dropped; and a field's
    traced rows equal the full-rate frame's rows rendered from the same
    state (the refit writes the same tables for the same clock)."""
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.utils.config import GlobalSettings

    eng = Engine(GlobalSettings(scene="demo", render_width=640,
                                render_height=360, interlace=True),
                 flags=TFlags(), animation="wave", device="cpu")
    nodes0 = eng.scene_data.tables.nodes.clone()
    frozen = (eng.scene_data.tables.levels, eng.scene_data.tables.stack)
    seen, t = [eng.render_h], 0.0
    for dt in (1 / 20, 1 / 200):
        img = eng.render_frame(dt=dt)
        t = TF.advance_clock(t, dt)
        assert img.shape == (360, 640, 3) and img.dtype == np.uint8
        seen.append(eng.render_h)
    assert seen == [360, 270, 360]
    assert eng.state.time == t
    assert int(eng.overflow) == 0
    tables = eng.scene_data.tables
    assert (tables.levels, tables.stack) == frozen
    assert not torch.equal(tables.nodes, nodes0)

    full = dataclasses.replace(eng.static, interlace=False)
    out = {}
    for static in (full, eng.static):
        _, _, out[static.interlace] = TF.render_frame(
            static, eng.scene_data, eng.state, eng.camera, eng.prev_camera,
            eng.params, 1 / 60, TF.make_frame_consts(static, "cpu"),
            rest=eng.rest)
    p = eng.state.frame_idx & 1
    for f in ("color", "albedo", "normal", "depth", "motion", "mat_id"):
        a, b = getattr(out[True], f), getattr(out[False], f)[p::2]
        assert torch.equal(a, b), f
