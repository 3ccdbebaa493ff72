"""Component-form shading (render/kshade.py): port == JAX kshade, function
by function, on the same random inputs made with numpy.

Tolerance rtol 1e-5 (atol 1e-6 near zero): both sides evaluate the same
float32 expressions in the same order; XLA and torch may still round
transcendental functions (sin/cos/sqrt/rsqrt) a last bit apart.  Two
documented exceptions keep the JAX test suite's own bounds for the same
comparisons (tests/test_kshade.py): the GGX pdf, whose D denominator
(1 + (a^2 - 1) cos^2)^2 amplifies single-ulp differences ~100x on spiky
lanes, the limb-darkened sun-disk radiance at the disk rim, and the sphere-light
cone pdf (1 - cos_max cancels for distant lights).  Integer
and RNG outputs are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.render import kshade as JK
from rtrt_tpu.render.megakernel import _unpack_sun
from rtrt_tpu.render.megakernel import pack_light_rows as jpack_lights
from rtrt_tpu.render.megakernel import pack_sun_params as jpack_sun
from rtrt_tpu.render.sky import bake_sky_maps, make_sky_params
from rtrt_tpu_torch.render import kshade as TK
from rtrt_tpu_torch.render.bsdf import Materials
from rtrt_tpu_torch.render.megakernel import pack_light_rows as tpack_lights
from rtrt_tpu_torch.render.megakernel import pack_sun_params as tpack_sun
from rtrt_tpu_torch.utils.interop import lights_from_jax, sky_from_jax

torch.set_num_threads(1)
N = 1024
RT, AT = 1e-5, 1e-6


def jv(a):
    return JK.V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                 jnp.asarray(a[:, 2]))


def tv(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return TK.V3(t[:, 0], t[:, 1], t[:, 2])


def st(v):
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)], -1)


def close(a, b, rtol=RT, atol=AT):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def unit(rng, n=N):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n = unit(rng)
    wo = unit(rng)
    wo = np.where(np.sum(wo * n, -1, keepdims=True) < 0, -wo, wo)
    return dict(rng=rng, n=n, wo=wo,
                u=rng.uniform(0, 1, (N, 2)).astype(np.float32))


def test_rand2_bit_exact(data):
    pix = np.arange(N, dtype=np.int32) * 3
    for frame, dim in ((0, 2), (9, 64), (77, 130)):
        jx, jy = JK.rand2_c(jnp.asarray(pix), jnp.uint32(frame),
                            jnp.uint32(dim))
        tx, ty = TK.rand2_c(torch.from_numpy(pix), frame, dim)
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        bn = data["u"]
        jx, jy = JK.rand2_bn_c(jnp.asarray(bn[:, 0]), jnp.asarray(bn[:, 1]),
                               jnp.uint32(frame), jnp.uint32(dim))
        t = torch.from_numpy(bn)
        tx, ty = TK.rand2_bn_c(t[:, 0], t[:, 1], frame, dim)
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())


def test_warps(data):
    u = data["u"]
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    for jf, tf in ((JK.concentric_disk_c(ju[:, 0], ju[:, 1]),
                    TK.concentric_disk_c(tu[:, 0], tu[:, 1])),):
        close(jf[0], tf[0])
        close(jf[1], tf[1])
    close(st(JK.cosine_hemisphere_c(ju[:, 0], ju[:, 1])),
          st(TK.cosine_hemisphere_c(tu[:, 0], tu[:, 1])))
    close(st(JK.uniform_cone_c(ju[:, 0], ju[:, 1], 0.9)),
          st(TK.uniform_cone_c(tu[:, 0], tu[:, 1], 0.9)))
    f, g = data["rng"].uniform(0, 3, (2, N)).astype(np.float32)
    close(JK.power_heuristic_c(jnp.asarray(f), jnp.asarray(g)),
          TK.power_heuristic_c(torch.from_numpy(f), torch.from_numpy(g)))


def test_vector_helpers(data):
    n, wo = data["n"], data["wo"]
    close(st(JK.reflect_c(jv(-wo), jv(n))), st(TK.reflect_c(tv(-wo), tv(n))))
    eta = np.full(N, 1.0 / 1.5, np.float32)
    jr, jt = JK.refract_c(jv(-wo), jv(n), jnp.asarray(eta))
    tr, tt = TK.refract_c(tv(-wo), tv(n), torch.from_numpy(eta))
    close(st(jr), st(tr))
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    for jf, tf in zip(JK.orthonormal_basis_c(jv(n)),
                      TK.orthonormal_basis_c(tv(n))):
        close(st(jf), st(tf))
    close(st(JK.vnormalize(jv(wo * 3.0))), st(TK.vnormalize(tv(wo * 3.0))))


def test_orient_normals(data):
    rng = data["rng"]
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ng = rng.normal(size=(N, 3)).astype(np.float32)
    for a, b in zip(JK.orient_normals_c(jv(ns), jv(ng), jv(data["wo"])),
                    TK.orient_normals_c(tv(ns), tv(ng), tv(data["wo"]))):
        close(st(a), st(b))


def test_bsdf_sample_eval(data):
    rng = data["rng"]
    n, wo, u = data["n"], data["wo"], data["u"]
    mtype = rng.integers(0, 4, N).astype(np.int32)
    albedo = rng.uniform(0.1, 1.0, (N, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, N).astype(np.float32)
    ior = np.full(N, 1.5, np.float32)
    f0 = rng.uniform(0.02, 0.9, (N, 3)).astype(np.float32)
    inside = rng.integers(0, 2, N).astype(bool)
    ref = JK.sample_bsdf_c(jnp.asarray(mtype), jv(albedo), jnp.asarray(rough),
                           jnp.asarray(ior), jv(f0), jv(n), jv(wo),
                           jnp.asarray(inside), jnp.asarray(u[:, 0]),
                           jnp.asarray(u[:, 1]))
    t = lambda x: torch.from_numpy(x)
    wi, weight, pdf, delta = TK.sample_bsdf_c(
        t(mtype), tv(albedo), t(rough), t(ior), tv(f0), tv(n), tv(wo),
        t(inside), t(u[:, 0]), t(u[:, 1]))
    close(st(ref.wi), st(wi), atol=1e-5)
    close(st(ref.weight), st(weight), rtol=1e-5, atol=1e-5)
    close(ref.pdf, pdf, rtol=5e-3, atol=1e-5)  # GGX D amplification
    np.testing.assert_array_equal(np.asarray(ref.is_delta), delta.numpy())

    wi_np = st(ref.wi)
    jf, jp = JK.eval_bsdf_c(jnp.asarray(mtype), jv(albedo),
                            jnp.asarray(rough), jv(f0), jv(n), jv(wo),
                            jv(wi_np))
    tf, tp = TK.eval_bsdf_c(t(mtype), tv(albedo), t(rough), tv(f0), tv(n),
                            tv(wo), tv(wi_np))
    close(st(jf), st(tf), rtol=5e-3, atol=1e-5)   # GGX D amplification
    close(jp, tp, rtol=5e-3, atol=1e-5)


@pytest.fixture(scope="module")
def sky():
    return bake_sky_maps(make_sky_params(), sky_res=(16, 32), sun_res=(4, 4))


def test_sun_nee(data, sky):
    u = data["u"]
    jsun = _unpack_sun(lambda i: jpack_sun(sky)[i])
    tsun = TK.SunParamsC(tpack_sun(sky_from_jax(sky, "cpu")))
    jw, jr, jp = JK.sample_sun_c(jsun, jnp.asarray(u[:, 0]),
                                 jnp.asarray(u[:, 1]))
    tw, tr, tp = TK.sample_sun_c(tsun, torch.from_numpy(u[:, 0]),
                                 torch.from_numpy(u[:, 1]))
    close(st(jw), st(tw))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    # disk interior: tight; rim lanes (mu^2 < 0.05) carry the ~2000x
    # limb-darkening amplification of 1-ulp cosine differences
    sd = np.asarray(sky.sun_dir, np.float64)
    mu2 = 1.0 - (1.0 - (st(jw).astype(np.float64) @ sd) ** 2) \
        / (1.0 - TK.SUN_COS_THETA_MAX ** 2)
    inner = mu2 > 0.05
    assert inner.mean() > 0.9
    close(st(jr)[inner], st(tr)[inner], rtol=1e-4, atol=1e-6)
    d = unit(data["rng"], 64)
    d[:16] = np.asarray(sky.sun_dir)
    close(st(JK.sun_disk_radiance_c(jsun, jv(d))),
          st(TK.sun_disk_radiance_c(tsun, tv(d))), rtol=1e-4)


def test_soil_shading(data):
    rng = data["rng"]
    pos = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    cone = rng.uniform(0, 0.1, N).astype(np.float32)
    ja, jr, jn = JK.soil_shading_c(jv(pos), jv(data["n"]), jnp.asarray(cone))
    ta, tr, tn = TK.soil_shading_c(tv(pos), tv(data["n"]),
                                   torch.from_numpy(cone))
    close(st(ja), st(ta), atol=1e-5)
    close(jr, tr, atol=1e-5)
    close(st(jn), st(tn), atol=1e-5)
    # the hashed lattice values themselves are bit-exact
    ix = rng.integers(-1000, 1000, (3, N)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(JK._hash3_c(*(jnp.asarray(a) for a in ix), 303)),
        TK._hash3_c(*(torch.from_numpy(a).long() for a in ix), 303).numpy())


@pytest.fixture(scope="module")
def lights():
    from rtrt_tpu.render.light import SphereLights
    return SphereLights(
        center=jnp.asarray([[3.0, 4.0, 1.0], [-2.0, 5.0, -3.0]], jnp.float32),
        radius=jnp.asarray([0.5, 1.0], jnp.float32),
        emission=jnp.asarray([[8.0, 6.0, 4.0], [2.0, 3.0, 9.0]], jnp.float32))


def test_sphere_lights(data, lights):
    rng = data["rng"]
    u = data["u"]
    p = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    li = rng.integers(0, 2, N).astype(np.int32)
    jrows = jpack_lights(lights)
    trows = tpack_lights(lights_from_jax(lights, "cpu"), "cpu")
    np.testing.assert_array_equal(np.asarray(jrows), trows.numpy())
    jres = JK.sample_sphere_light_c(lambda i: jrows[i], 2, jnp.asarray(li),
                                    jv(p), jnp.asarray(u[:, 0]),
                                    jnp.asarray(u[:, 1]))
    tres = TK.sample_sphere_light_c(trows, 2, torch.from_numpy(li), tv(p),
                                    torch.from_numpy(u[:, 0]),
                                    torch.from_numpy(u[:, 1]))
    close(st(jres[0]), st(tres[0]), atol=1e-5)
    close(st(jres[1]), st(tres[1]))
    # cone pdf 1 / (2 pi (1 - cos_max)): for a distant light 1 - cos_max
    # cancels (~6e-4 here), so a 1-ulp cos difference is ~1e-4 relative
    # (the JAX suite's own bound for this comparison)
    close(jres[2], tres[2], rtol=1e-4)
    close(jres[3], tres[3], atol=1e-5)
    d = unit(rng)
    close(JK.sphere_lights_pdf_c(lambda i: jrows[i], 2, jv(p), jv(d)),
          TK.sphere_lights_pdf_c(trows, 2, tv(p), tv(d)), rtol=1e-4)
    c = np.asarray(lights.center)[0]
    jh, jt = JK.ray_sphere_c(jv(p), jv(d), JK.V3(*c), 0.5)
    th, tt = TK.ray_sphere_c(tv(p), tv(d), TK.V3(*(torch.tensor(x) for x in c)),
                             torch.tensor(0.5))
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    close(jt, tt)


def test_material_select():
    from rtrt_tpu.engine.scene import default_materials
    from rtrt_tpu_torch.utils.interop import materials_from_jax
    jm = default_materials()
    tm: Materials = materials_from_jax(jm, "cpu")
    jrows = JK.pack_materials_rows(jm)
    trows = TK.pack_materials_rows(tm)
    np.testing.assert_array_equal(np.asarray(jrows), trows.numpy())
    ids = np.random.default_rng(2).integers(-1, 8, N).astype(np.int32)
    jr = JK.material_select_c(lambda i: jrows[i], jrows.shape[0],
                              jnp.asarray(ids))
    tr = TK.material_select_c(trows, torch.from_numpy(ids))
    for a, b in zip(jr, tr):
        a = st(a) if isinstance(a, JK.V3) else np.asarray(a)
        b = st(b) if isinstance(b, TK.V3) else b.numpy()
        np.testing.assert_array_equal(a, b)
