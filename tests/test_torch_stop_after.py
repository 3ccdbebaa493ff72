"""The frame's cut points (FrameStatic.stop_after) and K2's traversal-step
planes, at 32x16 on the demo scene with the default FeatureFlags().

  * each cut of the port's frame against the port's full frame of the same
    state and cameras: the "trace" cut equals the full frame's G-buffer
    (interlaced: its fill of the traced field), the "denoise" cut equals
    the denoiser run on the "trace" cut's planes and its history the full
    frame's new history, bit for bit; the "full" cut is the frame; every
    cut returns the state it was given;
  * the "bvh" cut: the tables; with a static MeshPose (the rest pose,
    unmoved, its normals kept) the in-frame rebuild writes the tables that
    rebuild_tables writes for that pose, which are the packed LBVH of the
    init-time build, bit for bit;
  * the "steps" cut: (SEGMENTS + 1, h, w) int32 planes, the plain K2's
    steps= planes of the frame's rays; JAX's own invariants of its
    debug_steps planes (tests/test_megakernel.py::
    test_debug_steps_telemetry: segments sum to the total, the primary
    segment > 0 where the root box is hit, a bound on the total; the port
    has no step cap, so the bound is SEGMENTS times the tree's node + leaf
    rows, each visited at most once a traversal) but not its
    tile-uniformity (one thread a path on a card); the planes' sum over
    pixels equals the plain version's `visits` count; interlaced frames
    give half-height planes;
  * the port's refusals where JAX renders the full frame: a "steps" cut on
    the wavefront route and any cut with a band (ValueError);
  * one JAX comparison: JAX's frame cut after the denoiser
    (make_frame_fn(static._replace(stop_after="denoise")), prebuilt flat
    SAH tables, its CPU route) against the port's "denoise" cut at frame
    0, both mapped to u8 as the frame without post-processing maps them
    (clamp to [0, 1], gamma 1/2.2), at tests/test_torch_frame.py's bound
    for the denoised frame: mean |delta| <= 2 LSB and >= 95% of pixels
    within 4 LSB on every channel (a diverged 1-spp path changes its
    pixel; the denoiser averages it)."""

import dataclasses

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
from rtrt_tpu_torch.bvh import packet as P
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.core.camera import camera_basis
from rtrt_tpu_torch.denoise.pipeline import denoise
from rtrt_tpu_torch.denoise.pipeline import init_history as tinit_history
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.scene import build_demo_scene as tdemo
from rtrt_tpu_torch.engine.scene import padded_arrays as tpadded
from rtrt_tpu_torch.render import integrator as I
from rtrt_tpu_torch.render import megakernel as M
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.render.kshade import pack_materials_rows
from rtrt_tpu_torch.render.raygen import generate_rays_padded
from rtrt_tpu_torch.render.sampling import rand2_bn
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

torch.set_num_threads(1)
W, H = 32, 16
DT = 1 / 60
CUTS = ("bvh", "trace", "steps", "denoise", "full")


def _cams():
    return [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(2)]


@pytest.fixture(scope="module")
def sky():
    return finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))


@pytest.fixture(scope="module")
def port(sky):
    """The port's demo scene over BVH4 tables, the first state and the
    cameras of frame 0."""
    th = tdemo()
    pad = tpadded(th)
    bvh, nrm, mat = build_scene_tables_sah(
        th.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        th.vertices, th.normals, leaf_max=8)
    scene = SceneData(tables=P.pack_tables(bvh, nrm, mat, bvh4_nodes(bvh)),
                      materials=th.materials,
                      sky=interop.sky_from_jax(sky, "cpu"),
                      lights=th.lights)
    state = TF.FrameState(
        exposure=interop.exposure_from_jax(init_exposure_state(), "cpu"),
        history=tinit_history(H, W, device="cpu"))
    prev, cam = (interop.camera_from_jax(c, "cpu") for c in _cams())
    return dict(host=th, pad=pad, scene=scene, state=state, cam=cam,
                prev=prev)


def _static(interlace=False, **kw):
    return TF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                          flags=TFlags(), interlace=interlace, **kw)


def _render(port, static, **kw):
    return TF.render_frame(static, port["scene"], port["state"],
                           port["cam"], port["prev"], tparams(), DT, **kw)


@pytest.fixture(scope="module")
def cuts(port):
    """The full frame and every cut of it, of the same state and cameras."""
    base = _static()
    out = {"frame": _render(port, base)}
    for stop in CUTS:
        out[stop] = _render(port, dataclasses.replace(base, stop_after=stop))
    return out


@pytest.fixture(scope="module")
def interlaced(port):
    """The interlaced frame and the cuts whose planes interlace changes:
    "trace" (the fill of the traced field) and "steps" (half height)."""
    base = _static(interlace=True)
    out = {"frame": _render(port, base)}
    for stop in ("trace", "steps"):
        out[stop] = _render(port, dataclasses.replace(base, stop_after=stop))
    return out


@pytest.mark.parametrize("stop", CUTS[:-1])
def test_cut_returns_the_state_it_was_given(port, cuts, stop):
    outputs, state = cuts[stop]
    assert isinstance(outputs, tuple)
    assert state is port["state"]


def test_full_cut_is_the_frame(cuts):
    img, state, gbuf = cuts["frame"]
    img2, state2, _ = cuts["full"]
    assert torch.equal(img, img2)
    assert torch.equal(state.history.color2, state2.history.color2)
    assert state2.frame_idx == state.frame_idx == 1


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["full-rate", "interlaced"])
def test_trace_cut_equals_the_frame_gbuffer(request, interlace):
    """(color, albedo, normal, depth, mat_id, motion) after the interlace
    fill: the full frame's traced G-buffer (its fill under interlace)."""
    run = request.getfixturevalue("interlaced" if interlace else "cuts")
    _, _, g = run["frame"]
    planes, _ = run["trace"]
    if interlace:  # frame 0: parity 0
        want = (TF.fill_linear(g.color, 0), TF.fill_linear(g.albedo, 0),
                *(TF.fill_nearest(x) for x in (g.normal, g.depth, g.mat_id,
                                               g.motion)))
    else:
        want = (g.color, g.albedo, g.normal, g.depth, g.mat_id, g.motion)
    assert planes[0].shape == (H, W, 3)
    for got, ref in zip(planes, want, strict=True):
        assert torch.equal(got, ref)


def test_denoise_cut_equals_the_frame_intermediates(port, cuts):
    """final is the denoiser on the trace cut's planes; new_history the
    full frame's new history, plane by plane."""
    (final, hist), _ = cuts["denoise"]
    planes, _ = cuts["trace"]
    ref_final, ref_hist = denoise(*planes, port["state"].history,
                                  tparams().denoise, TFlags(),
                                  frame_parity=0)
    assert torch.equal(final, ref_final)
    full_hist = cuts["frame"][1].history
    for f in hist._fields:
        a, b, c = (getattr(x, f) for x in (hist, ref_hist, full_hist))
        if torch.is_tensor(a):
            assert torch.equal(a, b) and torch.equal(a, c), f
        else:
            assert a == b == c, f


def test_bvh_cut_is_the_tables(port, cuts):
    (tables,), _ = cuts["bvh"]
    assert tables is port["scene"].tables


def test_static_rebuild_bvh_cut(port):
    """A static MeshPose (the rest pose with its normals): the in-frame LBVH
    rebuild writes what rebuild_tables writes for the pose, which is the
    init-time build's binary tables."""
    th, pad = port["host"], port["pad"]
    t = lambda a, dt=None: torch.from_numpy(np.asarray(a)).to(dtype=dt)
    pose = TF.MeshPose(vertices=t(th.vertices),
                       indices=t(pad["indices"], torch.int64),
                       tri_mat=t(pad["tri_mat"], torch.int32),
                       valid=t(pad["valid"]), normals=t(th.normals))
    want = P.pack_tables_binary(*TF.build_scene_tables(
        th.num_batches, pose.indices, pose.tri_mat, pose.valid,
        pose.vertices, pose.normals))
    ref = dataclasses.replace(want, **{f: getattr(want, f).clone() for f in
                                       ("nodes", "tris", "nrm", "ng", "mat")})
    TF.rebuild_tables(ref, pose, 1.0)
    cut = dataclasses.replace(want, **{f: torch.zeros_like(getattr(want, f))
                                       for f in ("nodes", "tris", "nrm",
                                                 "ng", "mat")})
    scene = dataclasses.replace(port["scene"], tables=cut)
    state = dataclasses.replace(port["state"], time=1.0)
    (tables,), _ = TF.render_frame(
        _static(stop_after="bvh"), scene, state, port["cam"], port["prev"],
        tparams(), DT, rest=pose)
    for f in ("nodes", "tris", "nrm", "ng", "mat"):
        assert torch.equal(getattr(tables, f), getattr(ref, f)), f
        assert torch.equal(getattr(tables, f), getattr(want, f)), f


def _frame_rays(port, static):
    consts = TF.make_frame_consts(static, "cpu")
    cam = dataclasses.replace(
        port["cam"], aperture=torch.tensor(tparams().sample.aperture),
        focal_dist=torch.tensor(tparams().sample.focal_dist))
    rays = generate_rays_padded(camera_basis(cam), W, H, consts.pixel_ids,
                                rand2_bn(consts.bn, 0, 0),
                                rand2_bn(consts.bn, 0, 256))
    return rays, consts


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["full-rate", "interlaced"])
def test_steps_cut(port, request, interlace):
    """The steps planes: JAX's invariants, the plain K2's planes and its
    visit count, half height under interlace."""
    run = request.getfixturevalue("interlaced" if interlace else "cuts")
    (steps,), _ = run["steps"]
    rows = H // 2 if interlace else H
    assert steps.shape == (I.SEGMENTS + 1, rows, W)
    assert steps.dtype == torch.int32
    total, segs = steps[0], steps[1:]
    assert torch.equal(segs.sum(0), total)
    assert (segs >= 0).all()
    tables = port["scene"].tables
    n_rows = tables.nodes.shape[0] + tables.tris.shape[0] // 8
    assert int(total.max()) < I.SEGMENTS * n_rows
    if interlace:
        return
    rays, consts = _frame_rays(port, _static())
    sc = port["scene"]
    visits = [0, 0]
    plain = torch.zeros((I.SEGMENTS + 1, H * W), dtype=torch.int32)
    M.megakernel_trace_plain(
        sc.tables, pack_materials_rows(sc.materials),
        M.pack_light_rows(sc.lights, "cpu"), M.pack_sun_params(sc.sky), 0,
        rays.org, rays.dir, rays.cone_width, consts.pixel_ids,
        n_lights=sc.lights.center.shape[0], bn=consts.bn, visits=visits,
        steps=plain)
    assert torch.equal(steps.reshape(I.SEGMENTS + 1, -1), plain)
    assert int(total.sum()) == visits[0] + visits[1]
    # the primary segment traverses wherever the ray meets the root box
    kids = tables.nodes[0, :24].reshape(4, 6)
    lo, hi = kids[:, :3].min(0).values, kids[:, 3:].max(0).values
    o, d = rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3)
    inv = 1.0 / d
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    hit_root = (tn <= tf) & (tf > 0)
    assert hit_root.any()
    assert (segs[0].reshape(-1)[hit_root] > 0).all()


def test_cuts_refused(port):
    with pytest.raises(ValueError, match="use_megakernel"):
        _static(stop_after="steps", use_megakernel=False)
    with pytest.raises(ValueError, match="stop_after"):
        _static(stop_after="post")
    with pytest.raises(ValueError, match="band"):
        _render(port, _static(stop_after="trace"), band=object())


def test_denoise_cut_matches_jax(port, sky):
    """JAX's frame cut after the denoiser against the port's at frame 0,
    both mapped to u8 without post-processing."""
    host = build_demo_scene()
    pad = padded_arrays(host)
    prebuilt = jbuild(host.num_batches, pad["indices"], pad["tri_mat"],
                      pad["valid"], host.vertices, host.normals, leaf_max=8)
    static = JF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                            num_batches=host.num_batches, flags=JFlags(),
                            use_packets=False, use_megakernel=False,
                            sah_leaf=8, stop_after="denoise")
    state = JF.FrameState(
        vertices=jnp.asarray(host.vertices),
        normals=jnp.asarray(host.normals), history=init_history(H, W),
        exposure=init_exposure_state(), frame_idx=jnp.uint32(0),
        time=jnp.float32(0.0))
    prev, cam = _cams()
    (jfinal, _), _ = JF.make_frame_fn(static)(
        jnp.asarray(pad["indices"]), jnp.asarray(pad["tri_mat"]),
        jnp.asarray(pad["valid"]), host.materials, make_soil_textures(16),
        sky, host.lights, state, cam, prev, jparams(), jnp.float32(DT),
        prebuilt)
    (final, _), _ = _render(port, _static(stop_after="denoise"))
    u8 = lambda x: (np.clip(np.asarray(x, np.float64), 0.0, 1.0)
                    ** (1 / 2.2) * 255.0 + 0.5).astype(np.int32)
    d = np.abs(u8(jfinal) - u8(final.numpy()))
    assert d.mean() <= 2.0, d.mean()
    assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()
