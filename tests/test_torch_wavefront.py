"""The wavefront path tracer (render/integrator.py::path_trace) against the
JAX package's on the demo scene (its sphere light; the floor marked
textured, so that the procedural soil and the mip / triplanar gather both
shade hits), 32x16 primary rays of one camera at frame index 3 with blue
noise, plus the lights that the path tracer samples, on one sky: the
port's bake, given to JAX as its SkyMaps (tests/test_torch_sky.py holds
the bakes and their sampling tables to each other).

JAX runs `path_trace(use_packets=False)` (the loop traverser) op by op,
its traversal jitted (bvh/traverse.py::intersect_scene under jax.jit: an
eager while_loop dispatches every iteration).  Not the whole program under
jax.jit: XLA's CPU backend then contracts products into FMAs across the
shading, and a 1-spp path whose shadow-or-scatter choice sits at its
decision boundary takes the other branch (on 1.2% of the raw pixels of
tests/test_torch_frame.py's frame index 2, where this op-by-op run and
the port agree to 1.1e-5 on every pixel).  The whole jitted frame is held
to the port's by tests/test_torch_frame.py.  Both texturing paths run
the full 5-segment program.  The port runs both of its routes on the same
tree: the loop route on the carried SceneBvh (flat SAH, leaf 8), the
packet route on the BVH4 that collapses it (K1's plain version,
Moller-Trumbore leaf tests).

Bounds, on every pixel and either route: material id equal, depth rtol
1e-5, normal, albedo atol 1e-5, motion atol 1e-6, the demodulated colour
rtol 1e-4 + atol 1e-5 (measured: colour within 3.4e-5, normal 1.4e-6,
albedo 5e-7, depth 5.7e-6: the same ops in the same order; torch and XLA
round a transcendental a last bit apart, and Moller-Trumbore's t of a hit
differs from the watertight test's in its last bits).

The lights at rtol 1e-4 (sample_env_light's directions go through the
equal-area map's sin / cos) and the sun's limb-darkened radiance and the
sphere-light cone pdf at rtol 1e-3 (see tests/test_torch_kshade.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.core.camera import camera_basis, make_camera
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.render import integrator as JI
from rtrt_tpu.render import light as JL
from rtrt_tpu.render import sky as JS
from rtrt_tpu.render.raygen import generate_rays_padded
from rtrt_tpu.render.sampling import blue_offsets_flat, rand2_bn
from rtrt_tpu.render.texture import make_soil_textures as jsoil
from rtrt_tpu_torch.bvh.packet import overflow_counter, pack_tables
from rtrt_tpu_torch.bvh.sah import bvh4_nodes
from rtrt_tpu_torch.core.camera import camera_basis as tbasis
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.render import integrator as TI
from rtrt_tpu_torch.render import light as TL
from rtrt_tpu_torch.render import sky as TS
from rtrt_tpu_torch.render.raygen import Rays
from rtrt_tpu_torch.render.texture import make_soil_textures as tsoil
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings)

torch.set_num_threads(1)
W, H = 32, 16
FRAME = 3


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def t(a):
    return torch.from_numpy(np.array(a))


def _jax_sky(m):
    """The port's baked SkyMaps as the JAX package's (the same arrays; JAX
    bakes its own sky in tests/test_torch_sky.py)."""
    j = lambda x: jnp.asarray(x.numpy())
    params = JS.SkyParams(*(j(getattr(m.params, f))
                            for f in JS.SkyParams._fields))
    return JS.SkyMaps(**{f: params if f == "params" else j(getattr(m, f))
                         for f in JS.SkyMaps._fields})


@pytest.fixture(scope="module")
def setup():
    host = build_demo_scene()
    pad = padded_arrays(host)
    jbvh, jnrm, jmat = jbuild(host.num_batches, pad["indices"],
                              pad["tri_mat"], pad["valid"], host.vertices,
                              host.normals, leaf_max=8)
    tsky = TS.finalize_sky_maps(TS.bake_sky_maps(
        TS.make_sky_params(device="cpu"), sky_res=(16, 32), sun_res=(4, 4)))
    sky = _jax_sky(tsky)
    mats = host.materials._replace(
        textured=host.materials.textured.at[1].set(1))  # the floor
    jscene = JI.SceneData(bvh=jbvh, tri_nrm_t=jnrm, tri_mat=jmat,
                          materials=mats, sky=sky, textures=jsoil(16),
                          lights=host.lights)
    basis = camera_basis(make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15,
                                     fov_y=1.1))
    n = W * H
    pix = jnp.arange(n, dtype=jnp.int32)
    bn = jnp.asarray(blue_offsets_flat(W, H, n))
    frame = jnp.uint32(FRAME)
    rays = generate_rays_padded(basis, W, H, pix,
                                rand2_bn(bn, frame, jnp.uint32(0)),
                                rand2_bn(bn, frame, jnp.uint32(256)))

    # JAX's path_trace op by op, its traversal jitted (never eager)
    jit_trace = jax.jit(JI.intersect_scene,
                        static_argnames=("any_hit", "leaf_width",
                                         "max_steps"))
    loop = JI.intersect_scene
    JI.intersect_scene = jit_trace
    try:
        ref = [JI.path_trace(jscene, rays, pix, frame, basis, W / H,
                             use_packets=False, use_proctex=proc, bn=bn,
                             leaf_width=8) for proc in (True, False)]
    finally:
        JI.intersect_scene = loop

    bvh = interop.bvh_from_jax(jbvh, "cpu")
    nrm, mat = t(jnrm), t(jmat).to(torch.int32)
    tscene = TI.SceneData(
        tables=pack_tables(bvh, nrm, mat, bvh4_nodes(bvh)),
        materials=interop.materials_from_jax(mats, "cpu"),
        sky=tsky,
        lights=interop.lights_from_jax(host.lights, "cpu"), bvh=bvh,
        tri_nrm_t=nrm, tri_mat=mat, textures=tsoil(16, device="cpu"))
    trays = Rays(*(t(getattr(rays, f)) for f in ("org", "dir", "uv",
                                                 "cone_width")))
    return dict(ref=ref, scene=tscene, rays=trays, sky=sky,
                basis=tbasis(interop.camera_from_jax(make_camera(
                    pos=(0.0, 3.0, -9.0), pitch=-0.15, fov_y=1.1), "cpu")),
                pix=t(pix), bn=t(bn), lights=host.lights)


def _port(setup, proc, packets):
    ovf = overflow_counter("cpu")
    g = TI.path_trace(setup["scene"], setup["rays"], setup["pix"], FRAME,
                      setup["basis"], W / H, use_packets=packets,
                      use_proctex=proc, bn=setup["bn"], leaf_width=8,
                      overflow=ovf)
    assert int(ovf) == 0
    return g


@pytest.mark.parametrize("packets", [False, True], ids=["loop", "packets"])
@pytest.mark.parametrize("proc", [True, False], ids=["soil", "gather"])
def test_path_trace_matches_jax(setup, proc, packets):
    ref = setup["ref"][0 if proc else 1]
    got = _port(setup, proc, packets)
    mid = np.asarray(ref.mat_id)
    np.testing.assert_array_equal(mid, got.mat_id.numpy())
    # the floor (textured), a sphere and the sky are all on screen
    assert (mid == 1).mean() > 0.2 and (mid == -1).mean() > 0.1 \
        and (mid > 1).any()
    close(ref.depth, got.depth, rtol=1e-5)
    for f in ("normal", "albedo"):
        close(getattr(ref, f), getattr(got, f), rtol=0, atol=1e-5)
    close(ref.motion, got.motion, rtol=0, atol=1e-6)
    close(ref.color, got.color, rtol=1e-4, atol=1e-5)


def test_fetch_surface_fallback(setup):
    """The loop route's attribute gather equals K1's plain version's hit
    attributes (the packet route's) on the same slots."""
    from rtrt_tpu_torch.bvh.packet import packet_intersect_plain
    sc, r = setup["scene"], setup["rays"]
    ph = packet_intersect_plain(sc.tables, r.org, r.dir)
    hit = ph.tri >= 0
    ns, ng, mat = TI._fetch_surface_fallback(sc, ph.tri, ph.u, ph.v)
    close(ns[hit], ph.ns[hit], atol=1e-6)
    close(torch.nn.functional.normalize(ng[hit], dim=-1), ph.ng[hit],
          atol=1e-5)
    np.testing.assert_array_equal(mat[hit].numpy(), ph.mat[hit].numpy())


# ---------------------------------------------------------------------------
# the lights
# ---------------------------------------------------------------------------


def test_lights(setup):
    jm, tm = setup["sky"], setup["scene"].sky
    rng = np.random.default_rng(7)
    n = 1024
    unit = lambda: (lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True))(
        rng.normal(size=(n, 3)).astype(np.float32))
    u3 = rng.random((n, 3), dtype=np.float32)
    u3[: n // 2, 0] = 0.0  # the sun branch on half the lanes
    js, ts = JL.sample_env_light(jm, jnp.asarray(u3)), \
        TL.sample_env_light(tm, t(u3))
    for f in ("wi", "radiance", "pdf", "dist"):
        close(getattr(js, f), getattr(ts, f), rtol=1e-4)
    d = unit()
    d[:32] = np.asarray(js.wi)[:32]  # sun directions
    close(JL.env_light_pdf(jm, jnp.asarray(d)), TL.env_light_pdf(tm, t(d)),
          rtol=1e-4)
    close(JL.env_radiance(jm, jnp.asarray(d)), TL.env_radiance(tm, t(d)),
          rtol=1e-4, atol=1e-5)
    u2 = rng.random((n, 2), dtype=np.float32)
    js, ts = JL.sample_sun(jm, jnp.asarray(u2)), TL.sample_sun(tm, t(u2))
    for f in ("wi", "pdf", "dist"):
        close(getattr(js, f), getattr(ts, f))
    close(js.radiance, ts.radiance, rtol=1e-3)
    jlights, tlights = setup["lights"], setup["scene"].lights
    nl = int(jlights.center.shape[0])
    li = rng.integers(0, nl, n)
    p = (rng.normal(size=(n, 3)) * 4.0).astype(np.float32)
    js = JL.sample_sphere_light(jlights, jnp.asarray(li.astype(np.int32)),
                                jnp.asarray(p), jnp.asarray(u2))
    ts = TL.sample_sphere_light(tlights, t(li), t(p), t(u2))
    for f in ("wi", "radiance", "dist"):
        close(getattr(js, f), getattr(ts, f), atol=1e-5)
    close(js.pdf, ts.pdf, rtol=1e-3)
    close(JI._sphere_lights_pdf(jlights, jnp.asarray(p), jnp.asarray(d),
                                None),
          TI._sphere_lights_pdf(tlights, t(p), t(d)), rtol=1e-3)


# ---------------------------------------------------------------------------
# the Engine's trace routes
# ---------------------------------------------------------------------------


def test_engine_trace_routes():
    """Engine(trace="packets") and Engine(trace="loop") on the demo scene:
    their frame configuration and scene tables, then one 32x16 frame of
    each Engine's scene through engine/frame.py::render_frame (the
    Engine's own buckets start at 480x270, too slow for the plain
    traversal here; chip_smoke renders the Engines on the card): the
    wavefront routes' images equal the megakernel's within 4 LSB on >= 99%
    of pixels (the same primary rays), and each other's on every pixel
    within 1 LSB; an unknown route and the loop route with an animation
    raise ValueError."""
    import dataclasses

    from rtrt_tpu_torch.engine.frame import FrameState, render_frame
    from rtrt_tpu_torch.post.exposure import init_exposure_state

    s = GlobalSettings(scene="demo", render_width=480, render_height=270,
                       dynamic_resolution=DynamicResolution(enabled=False))
    flags = FeatureFlags(denoise=False, bloom=False, lens_flare=False)
    imgs = {}
    for trace in ("packets", "loop"):
        eng = Engine(s, flags=flags, trace=trace, device="cpu")
        assert not eng.static.use_megakernel
        assert eng.static.use_packets == (trace == "packets")
        assert (eng.scene_data.bvh is not None) == (trace == "loop")
        small = dataclasses.replace(eng.static, render_w=W, render_h=H,
                                    screen_w=W, screen_h=H)
        routes = [(trace, small)]
        if trace == "loop":  # the megakernel on the same tables
            routes.append(("megakernel", dataclasses.replace(
                small, use_megakernel=True)))
        for name, static in routes:
            state = FrameState(exposure=init_exposure_state("cpu"))
            img, _, gbuf = render_frame(static, eng.scene_data, state,
                                        eng.camera, eng.camera, eng.params,
                                        1 / 60, overflow=eng.overflow)
            assert gbuf.depth.shape == (H, W)
            imgs[name] = img.numpy().astype(np.int32)
        assert int(eng.overflow) == 0
    for a, b, lsb, frac in (("megakernel", "packets", 4, 0.99),
                            ("packets", "loop", 1, 1.0)):
        d = np.abs(imgs[a] - imgs[b]).max(-1)
        assert (d <= lsb).mean() >= frac, (a, b, (d <= lsb).mean())
    with pytest.raises(ValueError, match="trace="):
        Engine(s, flags=flags, trace="wavefront", device="cpu")
    with pytest.raises(ValueError, match="loop"):
        Engine(s, flags=flags, trace="loop", animation="wave",
               device="cpu")
