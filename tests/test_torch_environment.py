"""The environment of escaped rays with the ocean and the star field
(render/stars.py, render/water.py, render/environment.py and the env hook
of render/megakernel.py::finish_gbuffer): the port against the JAX
package's modules on numpy inputs, and a 32x16 frame with
FeatureFlags(ocean=True, stars=True) against JAX's render_frame.

Tolerances (the JAX functions run op by op, as the JAX package's own
tests run them on the CPU; the frame runs jitted):
  * the star cells' uint32 hashes bit-equal; the star radiance within
    1e-6 + 1e-5 relative (measured 4.8e-7: exp and float32 rounding);
  * wave_height within 1e-5 absolute at |x|, |z| <= 150 and clocks up to
    the 1,000th frame's (measured 1.2e-6; under jit, where XLA contracts
    the phase into FMAs, 4.8e-6); the march's hit flags equal on >= 99.9%
    of rays and, where both hit, t within 1e-5 relative on >= 99.9%
    (measured: all equal);
  * ocean_shade under one analytic sky function within 1e-5 + 1e-4
    relative (measured 3.1e-6; under jit 1.1e-4: the central-difference
    normal divides the heights' ulps by 2 eps = 0.1);
  * env_radiance_scene with both flags, the sun below the horizon, within
    1e-5 + 1e-3 relative on >= 99.9% of rays (the port's sky fit sums its
    Chebyshev series in another order, render/sky.py);
  * the frame: tests/test_torch_frame.py's image-level bound, mean |delta|
    <= 2 LSB and >= 95% of pixels within 4 LSB, every frame; and the same
    frame without the flags differs from it by more than 8 LSB on > 10%
    of pixels (the ocean and the stars are in the picture)."""

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
from rtrt_tpu.render import environment as JE
from rtrt_tpu.render import stars as JS
from rtrt_tpu.render import water as JW
from rtrt_tpu.render.sky import bake_sky_maps, finalize_sky_maps, \
    make_sky_params
from rtrt_tpu.render.texture import make_soil_textures
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.bvh.packet import overflow_counter, pack_tables
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.denoise.pipeline import init_history as tinit_history
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.scene import build_demo_scene as tdemo
from rtrt_tpu_torch.engine.scene import padded_arrays as tpadded
from rtrt_tpu_torch.render import environment as TE
from rtrt_tpu_torch.render import stars as TS
from rtrt_tpu_torch.render import water as TW
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

torch.set_num_threads(1)
N = 20000
TIMES = (0.0, 3.3, 16.666584)  # the last: the float32 clock at frame 1000
W, H = 32, 16
NIGHT = -0.05  # sun elevation (rad): dusk, stars at 58% of full visibility


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.concatenate([rng.uniform(-20, 20, (N, 1)),
                          rng.uniform(1, 8, (N, 1)),
                          rng.uniform(-20, 20, (N, 1))], 1).astype(np.float32)
    return org, d


def _sky(elev):
    return finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params(
            sun_elevation=elev)))


def test_star_hashes_bit_equal_jax():
    rng = np.random.default_rng(8)
    ix = rng.integers(-2 ** 31, 2 ** 31, N, dtype=np.int64).astype(np.int32)
    iy = rng.integers(0, 97, N).astype(np.int32)
    face = rng.integers(0, 6, N).astype(np.int32)
    for seed in (17, 0xFFFFFFF0):
        ref = np.asarray(JS._cell_hash(jnp.asarray(ix), jnp.asarray(iy),
                                       jnp.asarray(face), seed))
        got = TS._cell_hash(torch.from_numpy(ix), torch.from_numpy(iy),
                            torch.from_numpy(face), seed)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_star_field_matches_jax(rays):
    d = rays[1]
    ref = np.asarray(JS.star_field(jnp.asarray(d)))
    got = TS.star_field(torch.from_numpy(d)).numpy()
    assert (ref > 1e-3).any(axis=-1).mean() > 0.002  # some rays see a star
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t", TIMES)
def test_wave_height_and_march_match_jax(rays, t):
    org, d = rays
    rng = np.random.default_rng(9)
    x = rng.uniform(-150, 150, N).astype(np.float32)
    z = rng.uniform(-150, 150, N).astype(np.float32)
    ref = np.asarray(JW.wave_height(jnp.asarray(x), jnp.asarray(z),
                                    jnp.float32(t)))
    got = TW.wave_height(torch.from_numpy(x), torch.from_numpy(z), t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)

    jhit, jt = JW.intersect_ocean(jnp.asarray(org), jnp.asarray(d),
                                  jnp.float32(t))
    hit, tt = TW.intersect_ocean(torch.from_numpy(org), torch.from_numpy(d),
                                 t)
    jhit, jt, hit, tt = (np.asarray(a) for a in (jhit, jt, hit, tt))
    assert 0.3 < jhit.mean() < 0.7
    assert (hit == jhit).mean() >= 0.999
    both = hit & jhit
    assert (np.abs(tt[both] - jt[both]) <= 1e-5 * jt[both]).mean() >= 0.999
    assert np.isinf(tt[~hit]).all()


@pytest.mark.parametrize("t", TIMES[1:])
def test_ocean_shade_matches_jax(rays, t):
    org, d = rays
    jhit, jt = JW.intersect_ocean(jnp.asarray(org), jnp.asarray(d),
                                  jnp.float32(t))
    tt = np.where(np.asarray(jhit), np.asarray(jt), 0.0).astype(np.float32)

    def sky(dd, xp):
        return xp.stack([0.5 + 0.5 * dd[..., 1], 0.3 + 0.2 * dd[..., 0],
                         0.8 - 0.1 * dd[..., 2]], -1)

    ref = np.asarray(JW.ocean_shade(jnp.asarray(org), jnp.asarray(d),
                                    jnp.asarray(tt), jnp.float32(t),
                                    lambda v: sky(v, jnp)))
    got = TW.ocean_shade(torch.from_numpy(org), torch.from_numpy(d),
                         torch.from_numpy(tt), t,
                         lambda v: sky(v, torch)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", (0.0, 16.666584))
def test_env_radiance_scene_matches_jax_at_night(rays, t):
    org, d = rays
    sky = _sky(NIGHT)
    tsky = interop.sky_from_jax(sky, "cpu")
    assert float(TE.night_visibility(tsky)) == pytest.approx(
        float(JE.night_visibility(sky)), rel=1e-6)
    assert float(TE.night_visibility(tsky)) > 0.5
    ref = np.asarray(JE.env_radiance_scene(
        sky, jnp.asarray(org), jnp.asarray(d), jnp.float32(t), ocean=True,
        stars=True))
    got = TE.env_radiance_scene(tsky, torch.from_numpy(org),
                                torch.from_numpy(d), t, ocean=True,
                                stars=True).numpy()
    ok = (np.abs(got - ref) <= 1e-5 + 1e-3 * np.abs(ref)).all(-1)
    assert ok.mean() >= 0.999, ok.mean()
    # both terms are live: stars above the horizon, the ocean below it
    plain = TE.env_radiance_scene(tsky, torch.from_numpy(org),
                                  torch.from_numpy(d), t).numpy()
    up = d[:, 1] > 0
    assert (np.abs(got - plain).max(-1)[up] > 1e-3).mean() > 0.002
    assert (np.abs(got - plain).max(-1)[~up] > 1e-3).mean() > 0.5


def _render_both(cams, elev):
    """len(cams) - 1 frames of the demo scene with ocean and stars, in both
    packages, at W x H."""
    host = build_demo_scene()
    pad = padded_arrays(host)
    prebuilt = jbuild(host.num_batches, pad["indices"], pad["tri_mat"],
                      pad["valid"], host.vertices, host.normals, leaf_max=8)
    sky = _sky(elev)
    jflags = JFlags(ocean=True, stars=True)
    static = JF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                            num_batches=host.num_batches, flags=jflags,
                            use_packets=False, use_megakernel=False,
                            sah_leaf=8)
    state = JF.FrameState(
        vertices=jnp.asarray(host.vertices), normals=jnp.asarray(host.normals),
        history=init_history(H, W), exposure=init_exposure_state(),
        frame_idx=jnp.uint32(0), time=jnp.float32(0.0))
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
                      materials=th.materials,
                      sky=interop.sky_from_jax(sky, "cpu"), lights=th.lights)
    tstate = TF.FrameState(
        exposure=interop.exposure_from_jax(init_exposure_state(), "cpu"),
        history=tinit_history(H, W, device="cpu"))
    tcams = [interop.camera_from_jax(c, "cpu") for c in cams]
    ovf = overflow_counter("cpu")
    got = {}
    for flags in (TFlags(ocean=True, stars=True), TFlags()):
        st, got[flags.ocean] = tstate, []
        tstatic = TF.FrameStatic(render_w=W, render_h=H, screen_w=W,
                                 screen_h=H, flags=flags)
        for prev, cam in zip(tcams, tcams[1:]):
            img, st, gbuf = TF.render_frame(tstatic, scene, st, cam, prev,
                                            tparams(), 1 / 60, overflow=ovf)
            got[flags.ocean].append(img.numpy())
    assert int(ovf) == 0
    return ref, got


@pytest.fixture(scope="module")
def frames():
    # outside the ground quad (|x|, |z| <= 30) looking at it: the lowest
    # rows see the ocean in front of the quad
    cams = [make_camera(pos=(0.05 * k, 4.0, -40.0), yaw=0.01 * k,
                        pitch=-0.1, fov_y=1.1) for k in range(4)]
    return _render_both(cams, NIGHT)


def test_ocean_stars_frame_matches_jax(frames):
    ref, got = frames
    assert len(got[True]) == 3
    for r, g in zip(ref, got[True]):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()
    # the environment is in the picture: the frame without it differs
    off = np.abs(got[False][-1].astype(np.int32)
                 - got[True][-1].astype(np.int32)).max(-1)
    assert (off > 8).mean() > 0.1, (off > 8).mean()
