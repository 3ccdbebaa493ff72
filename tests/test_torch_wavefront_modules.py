"""The wavefront integrator's modules: port == JAX, function by function, on
the same random inputs made with numpy from a seed.

  * core/vecmath (length, refract, local_to_world, spherical_to_dir,
    permute3), core/precision (err_gamma, next_float_up / down: bit-equal),
    core/geometry (make_ray_aux, the slab tests, the watertight and
    Moller-Trumbore triangle tests, ray_sphere, ray_plane);
  * render/sampling's new functions (wang_hash, rand1, white2: bit-equal;
    the hemisphere, sphere and cone warps), ops/scan (pdf_to_cdf, with an
    all-zero row);
  * (the sky's sampling tables and render/light are held in
    tests/test_torch_wavefront.py, beside the sky that file bakes);
  * render/bsdf (material_lookup, fresnel_schlick, ggx_sample_h, ggx_eval,
    sample_bsdf, eval_bsdf) on all five material types with lanes inside
    glass; render/proctex (value_noise3, fbm3_filtered, soil_shading);
    the integrator's helpers (_orient_normals, _material_at with the mip /
    triplanar gather);
  * bvh/traverse.py::intersect_scene against JAX's (jitted), closest hit
    and any-hit under t_max (finite on a third of the rays, 0 on a few;
    the port's t_max=None equal to inf), on the demo scene's flat SAH
    leaf-8 tree and on its two-level LBVH: the closest slot equal on every
    ray, t at rtol 1e-5 and the barycentrics u / v at atol 1e-5 (both run
    the same watertight test in the same order of operations, but XLA's
    CPU backend contracts products into FMAs, and u / v are differences of
    products that cancel: an ulp of their terms moves them by ~2e-6);
    any-hit on hit / no-hit only (its first accepted hit depends on the
    order); no ray reaches the step cap; occluded and intersect_brute.

Tolerance elsewhere rtol 1e-5 + atol 1e-6 (the same float32 expressions in
the same order; transcendental functions may round a last bit apart), with
the documented exceptions of tests/test_torch_kshade.py where the same
terms appear: the GGX lobe (its D denominator amplifies one ulp ~100x on
spiky lanes: rtol 5e-3, the JAX suite's own bound in tests/test_kshade.py),
the limb-darkened sun radiance at the disk's rim and the sphere-light cone
pdf (1 - cos_max cancels for distant lights), each at rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh import traverse as JTR
from rtrt_tpu.bvh import types as JT
from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.core import geometry as JG
from rtrt_tpu.core import precision as JP
from rtrt_tpu.core import vecmath as JV
from rtrt_tpu.core.camera import camera_basis, make_camera
from rtrt_tpu.engine.scene import build_demo_scene as jdemo
from rtrt_tpu.engine.scene import padded_arrays as jpadded
from rtrt_tpu.ops import scan as JSC
from rtrt_tpu.render import bsdf as JB
from rtrt_tpu.render import integrator as JI
from rtrt_tpu.render import proctex as JPT
from rtrt_tpu.render import sampling as JSA
from rtrt_tpu.render.raygen import generate_rays_padded
from rtrt_tpu.render.texture import make_soil_textures as jsoil
from rtrt_tpu_torch.bvh import traverse as TTR
from rtrt_tpu_torch.bvh.build import build_scene_bvh
from rtrt_tpu_torch.bvh.types import BATCH_SIZE
from rtrt_tpu_torch.core import geometry as TG
from rtrt_tpu_torch.core import precision as TP
from rtrt_tpu_torch.core import vecmath as TV
from rtrt_tpu_torch.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu_torch.ops import scan as TSC
from rtrt_tpu_torch.render import bsdf as TB
from rtrt_tpu_torch.render import integrator as TI
from rtrt_tpu_torch.render import proctex as TPT
from rtrt_tpu_torch.render import sampling as TSA
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.render.texture import make_soil_textures as tsoil
from rtrt_tpu_torch.utils import interop

torch.set_num_threads(1)
N = 1024
RT, AT = 1e-5, 1e-6


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(a, b, rtol=RT, atol=AT):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def unit(rng, n=N):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def uni(rng, *shape):
    return rng.random(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------


def test_vecmath():
    rng = np.random.default_rng(1)
    a, n = rng.normal(size=(N, 3)).astype(np.float32), unit(rng)
    d = -unit(rng)
    n = np.where((d * n).sum(-1, keepdims=True) > 0, -n, n)
    eta = (0.5 + uni(rng, N) * 1.5).astype(np.float32)
    close(JV.length(jnp.asarray(a)), TV.length(t(a)))
    close(JV.distance(jnp.asarray(a), jnp.asarray(n)),
          TV.distance(t(a), t(n)))
    jr, jtir = JV.refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(eta))
    tr, ttir = TV.refract(t(d), t(n), t(eta))
    np.testing.assert_array_equal(np.asarray(jtir), ttir.numpy())
    assert np.asarray(jtir).any() and not np.asarray(jtir).all()
    close(jr, tr)
    close(JV.local_to_world(jnp.asarray(a), jnp.asarray(n)),
          TV.local_to_world(t(a), t(n)))
    th, ph = uni(rng, N) * 3.0, uni(rng, N) * 6.0
    close(JV.spherical_to_dir(jnp.asarray(th), jnp.asarray(ph)),
          TV.spherical_to_dir(t(th), t(ph)))
    k = rng.integers(0, 3, (3, N)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(JV.permute3(jnp.asarray(a), *map(jnp.asarray, k))),
        TV.permute3(t(a), *map(t, k)).numpy())


def test_precision_bit_equal():
    for n in (1.0, 3.0, 5.0, 7.0, 12.0):
        assert TP.err_gamma(n) == JP.err_gamma(n)
    assert (TP.GAMMA3, TP.GAMMA5, TP.GAMMA7) == (JP.GAMMA3, JP.GAMMA5,
                                                 JP.GAMMA7)
    rng = np.random.default_rng(2)
    # normal floats only: XLA's CPU backend treats a subnormal input as 0
    x = np.concatenate([rng.normal(size=N) * 10.0 ** rng.integers(
        -30, 30, N), [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    for jf, tf in ((JP.next_float_up, TP.next_float_up),
                   (JP.next_float_down, TP.next_float_down)):
        np.testing.assert_array_equal(
            np.asarray(jf(jnp.asarray(x))).view(np.int32),
            tf(t(x)).numpy().view(np.int32))


def _rays(rng, n=N):
    org = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    d = unit(rng, n)
    d[:16, 1] = 0.0  # zero components take the safe inverse
    d[:16] /= np.linalg.norm(d[:16], axis=-1, keepdims=True)
    return org, d


def test_geometry():
    rng = np.random.default_rng(3)
    org, d = _rays(rng)
    ja, ta = JG.make_ray_aux(jnp.asarray(d)), TG.make_ray_aux(t(d))
    for f in ("kx", "ky", "kz"):
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      getattr(ta, f).numpy())
    for f in ("inv_dir", "sx", "sy", "sz"):
        close(getattr(ja, f), getattr(ta, f))
    lo = (rng.normal(size=(N, 3)) * 2.0).astype(np.float32)
    hi = lo + uni(rng, N, 3) * 3.0
    lo[:8], hi[:8] = np.inf, -np.inf  # empty boxes miss
    tmax = np.where(uni(rng, N) < 0.3, uni(rng, N) * 5.0, np.inf).astype(
        np.float32)
    jh, jt = JG.ray_aabb(jnp.asarray(org), ja.inv_dir, jnp.asarray(lo),
                         jnp.asarray(hi), t_max=jnp.asarray(tmax))
    th_, tt = TG.ray_aabb(t(org), ta.inv_dir, t(lo), t(hi), t_max=t(tmax))
    np.testing.assert_array_equal(np.asarray(jh), th_.numpy())
    assert not th_[:8].any() and th_.any()
    close(np.where(np.asarray(jh), jt, 0), np.where(th_, tt, 0))
    boxes = np.concatenate([lo, hi, hi - 1.0, hi], -1)
    for a, b in zip(JG.ray_aabb_pair(jnp.asarray(org), ja.inv_dir,
                                     jnp.asarray(boxes)),
                    TG.ray_aabb_pair(t(org), ta.inv_dir, t(boxes))):
        close(np.asarray(a, np.float32), b.float())
    # triangles around the rays' paths, so that a share is hit
    c = org + d * (uni(rng, N, 1) * 4.0 + 0.5)
    v0, v1, v2 = (c + rng.normal(size=(N, 3)).astype(np.float32)
                  for _ in range(3))
    v1[:4] = v0[:4]  # degenerate triangles never hit
    jw = JG.ray_triangle_watertight(jnp.asarray(org), ja, *map(
        jnp.asarray, (v0, v1, v2)), t_max=jnp.asarray(tmax))
    tw = TG.ray_triangle_watertight(t(org), ta, t(v0), t(v1), t(v2),
                                    t_max=t(tmax))
    np.testing.assert_array_equal(np.asarray(jw.hit), tw.hit.numpy())
    assert 0.1 < tw.hit.float().mean() < 0.9 and not tw.hit[:4].any()
    hit = tw.hit.numpy()
    for f in ("t", "u", "v"):
        close(np.asarray(getattr(jw, f))[hit], getattr(tw, f).numpy()[hit])
    jm = JG.ray_triangle_mt(*map(jnp.asarray, (org, d, v0, v1, v2)))
    tm = TG.ray_triangle_mt(*map(t, (org, d, v0, v1, v2)))
    hm = tm.hit.numpy()
    np.testing.assert_array_equal(np.asarray(jm.hit), hm)
    assert (hm == (tw.hit.numpy() | (tmax < np.inf) & hm)).mean() > 0.99
    for f in ("t", "u", "v"):
        close(np.asarray(getattr(jm, f))[hm], getattr(tm, f).numpy()[hm],
              rtol=1e-4, atol=1e-5)
    close(JG.triangle_normal(*map(jnp.asarray, (v0, v1, v2))),
          TG.triangle_normal(t(v0), t(v1), t(v2)), atol=1e-5)
    r = uni(rng, N) * 2.0
    js, jst = JG.ray_sphere(jnp.asarray(org), jnp.asarray(d),
                            jnp.asarray(c), jnp.asarray(r))
    ts_, tst = TG.ray_sphere(t(org), t(d), t(c), t(r))
    np.testing.assert_array_equal(np.asarray(js), ts_.numpy())
    close(np.where(js, jst, 0), np.where(ts_, tst, 0), atol=1e-5)
    nrm = unit(rng)
    off = rng.normal(size=N).astype(np.float32)
    jp, jpt = JG.ray_plane(jnp.asarray(org), jnp.asarray(d),
                           jnp.asarray(nrm), jnp.asarray(off))
    tp, tpt = TG.ray_plane(t(org), t(d), t(nrm), t(off))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    close(np.where(jp, jpt, 0), np.where(tp, tpt, 0), rtol=1e-4)


# ---------------------------------------------------------------------------
# sampling, scan
# ---------------------------------------------------------------------------


def test_sampling():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 2 ** 31, N, dtype=np.int64).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(JSA.wang_hash(jnp.asarray(ids))).astype(np.int64),
        TSA.wang_hash(t(ids.astype(np.int64))).numpy())
    pid = t(ids.astype(np.int64))
    for frame, dim in ((0, 2), (7, 130), (2 ** 31 + 5, 64)):
        np.testing.assert_array_equal(
            np.asarray(JSA.rand1(jnp.asarray(ids), jnp.uint32(frame),
                                 jnp.uint32(dim))),
            TSA.rand1(pid, frame, dim).numpy())
        np.testing.assert_array_equal(
            np.asarray(JSA.white2(jnp.asarray(ids), jnp.uint32(frame),
                                  jnp.uint32(dim))),
            TSA.white2(pid, frame, dim).numpy())
    u = uni(rng, N, 2)
    u[0] = 0.5  # the disk's centre
    for f in ("cosine_hemisphere", "uniform_hemisphere", "uniform_sphere"):
        close(getattr(JSA, f)(jnp.asarray(u)), getattr(TSA, f)(t(u)))
    cmax = uni(rng, N) * 0.999
    close(JSA.uniform_cone(jnp.asarray(u), jnp.asarray(cmax)),
          TSA.uniform_cone(t(u), t(cmax)))
    close(JSA.uniform_cone(jnp.asarray(u), jnp.float32(0.9)),
          TSA.uniform_cone(t(u), 0.9))
    close(JSA.uniform_cone_pdf(jnp.asarray(cmax)),
          TSA.uniform_cone_pdf(t(cmax)))


def test_scan_pdf_to_cdf():
    rng = np.random.default_rng(5)
    pdf = uni(rng, 4, 300) ** 3
    pdf[2] = 0.0  # an all-zero row becomes uniform
    jc, jt = JSC.pdf_to_cdf(jnp.asarray(pdf))
    tc, tt = TSC.pdf_to_cdf(t(pdf))
    close(jc, tc)
    close(jt, tt)
    assert (tc[:, -1] == 1.0).all()
    close(JSC.exclusive_scan(jnp.asarray(pdf)), TSC.exclusive_scan(t(pdf)),
          atol=1e-5)
    close(JSC.inclusive_scan(jnp.asarray(pdf)), TSC.inclusive_scan(t(pdf)))


# ---------------------------------------------------------------------------
# BSDF, procedural soil, the integrator's helpers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def surf():
    """Random surface lanes of all five material types: oriented normals,
    wo on the normal's side, inside-glass lanes, u pairs and the
    material parameters."""
    rng = np.random.default_rng(8)
    n = unit(rng)
    wo = unit(rng)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    mtype = np.arange(N, dtype=np.int32) % 5
    return dict(
        n=n, wo=wo, wi=unit(rng), mtype=mtype,
        albedo=uni(rng, N, 3), rough=(0.05 + uni(rng, N) * 0.95),
        ior=(1.2 + uni(rng, N) * 0.6), f0=uni(rng, N, 3) * 0.5,
        inside=(rng.random(N) < 0.5), u2=uni(rng, N, 2))


def test_material_lookup_and_fresnel():
    host = jdemo()
    jmats = host.materials
    tmats = interop.materials_from_jax(jmats, "cpu")
    mat = np.arange(-1, int(jmats.mtype.shape[0]) + 1).astype(np.int32)
    for a, b in zip(JB.material_lookup(jmats, jnp.asarray(mat)),
                    TB.material_lookup(tmats, t(mat))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rng = np.random.default_rng(9)
    c, f0 = uni(rng, N), uni(rng, N, 3)
    close(JB.fresnel_schlick(jnp.asarray(c), jnp.asarray(f0)),
          TB.fresnel_schlick(t(c), t(f0)))
    close(JB.fresnel_schlick(jnp.asarray(c), jnp.asarray(f0[:, 0])),
          TB.fresnel_schlick(t(c), t(f0[:, 0])))


def test_ggx(surf):
    s = surf
    alpha = np.maximum(s["rough"] ** 2, 1e-4).astype(np.float32)
    jh = JB.ggx_sample_h(jnp.asarray(s["n"]), jnp.asarray(s["wo"]),
                         jnp.asarray(s["u2"]), jnp.asarray(alpha))
    th = TB.ggx_sample_h(t(s["n"]), t(s["wo"]), t(s["u2"]), t(alpha))
    close(jh, th, atol=1e-5)
    jf, jp = JB.ggx_eval(*map(jnp.asarray, (s["n"], s["wo"], s["wi"],
                                            s["albedo"], s["f0"], alpha)))
    tf, tp = TB.ggx_eval(*map(t, (s["n"], s["wo"], s["wi"], s["albedo"],
                                  s["f0"], alpha)))
    close(jf, tf, rtol=5e-3, atol=1e-5)
    close(jp, tp, rtol=5e-3, atol=1e-5)


def test_sample_and_eval_bsdf(surf):
    s = surf
    ja = [jnp.asarray(s[k]) for k in ("mtype", "albedo", "rough", "ior",
                                      "f0", "n", "wo", "inside", "u2")]
    ta = [t(s[k]) for k in ("mtype", "albedo", "rough", "ior", "f0", "n",
                            "wo", "inside", "u2")]
    jb, tb = JB.sample_bsdf(*ja), TB.sample_bsdf(*ta)
    np.testing.assert_array_equal(np.asarray(jb.is_delta),
                                  tb.is_delta.numpy())
    # glass lanes refract (inside and out) and reflect
    glass = s["mtype"] == JB.MAT_GLASS
    refr = ((np.asarray(jb.wi) * s["n"]).sum(-1) < 0) & glass
    assert refr.any() and (refr & s["inside"]).any() \
        and (glass & ~refr).any()
    close(jb.wi, tb.wi, atol=1e-5)
    ggx = s["mtype"] == JB.MAT_GGX
    for f in ("weight", "pdf"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        close(a[~ggx], b[~ggx])
        close(a[ggx], b[ggx], rtol=5e-3, atol=1e-5)
    je = JB.eval_bsdf(ja[0], ja[1], ja[2], ja[4], ja[5], ja[6],
                      jnp.asarray(s["wi"]))
    te = TB.eval_bsdf(ta[0], ta[1], ta[2], ta[4], ta[5], ta[6], t(s["wi"]))
    for a, b in zip(je, te):
        close(a, b, rtol=5e-3, atol=1e-5)


def test_proctex():
    rng = np.random.default_rng(10)
    pos = (rng.normal(size=(N, 3)) * 30.0).astype(np.float32)
    pos[:8] = -pos[:8] - 0.5  # negative lattice cells
    cone = (uni(rng, N) ** 3 * 2.0).astype(np.float32)
    n = unit(rng)
    np.testing.assert_array_equal(
        np.asarray(JPT.value_noise3(jnp.asarray(pos), 7)),
        TPT.value_noise3(t(pos), 7).numpy())
    close(JPT.fbm3_filtered(jnp.asarray(pos), jnp.asarray(cone), 4, 1.0, 101),
          TPT.fbm3_filtered(t(pos), t(cone), 4, 1.0, 101))
    for a, b in zip(JPT.soil_shading(jnp.asarray(pos), jnp.asarray(n),
                                     jnp.asarray(cone)),
                    TPT.soil_shading(t(pos), t(n), t(cone))):
        close(a, b)


def test_integrator_helpers(surf):
    s = surf
    rng = np.random.default_rng(11)
    ns_raw = (rng.normal(size=(N, 3))).astype(np.float32)
    ng_raw = (rng.normal(size=(N, 3))).astype(np.float32)
    ns_raw[:4] = 0.0  # a zero shading normal
    for a, b in zip(JI._orient_normals(*map(jnp.asarray, (ns_raw, ng_raw,
                                                          s["wo"]))),
                    TI._orient_normals(t(ns_raw), t(ng_raw), t(s["wo"]))):
        close(a, b)
    # _material_at, both texturing paths, on the demo's materials with the
    # floor textured
    host = jdemo()
    jmats = host.materials._replace(
        textured=host.materials.textured.at[1].set(1))
    tmats = interop.materials_from_jax(jmats, "cpu")
    jscene = JI.SceneData(bvh=None, tri_nrm_t=None, tri_mat=None,
                          materials=jmats, sky=None, textures=jsoil(16))
    tscene = SceneData(tables=None, materials=tmats, sky=None,
                       textures=tsoil(16, device="cpu"))
    mat = (np.arange(N) % int(jmats.mtype.shape[0])).astype(np.int32)
    pos = (rng.normal(size=(N, 3)) * 20.0).astype(np.float32)
    cone = (uni(rng, N) ** 3).astype(np.float32)
    for proc in (True, False):
        ja = JI._material_at(jscene, jnp.asarray(mat), jnp.asarray(pos),
                             jnp.asarray(s["n"]), jnp.asarray(cone), proc)
        ta = TI._material_at(tscene, t(mat), t(pos), t(s["n"]), t(cone),
                             proc)
        for a, b in zip(ja, ta):
            close(np.asarray(a, np.float32), b.float(), atol=1e-5)


# ---------------------------------------------------------------------------
# the loop traverser
# ---------------------------------------------------------------------------


def _jax_trace(leaf_width):
    """JAX intersect_scene's closest-hit and any-hit variants in one jitted
    program, under the rays' t_max (inf on two thirds of them)."""
    def run(bvh, org, dirs, tmax):
        return [JTR.intersect_scene(bvh, org, dirs, tmax, any_hit=any_hit,
                                    leaf_width=leaf_width)
                for any_hit in (False, True)]
    return jax.jit(run)


@pytest.fixture(scope="module")
def trees():
    """The demo scene's flat SAH leaf-8 tree (JAX's build, carried over)
    and its two-level LBVH (the port's build, bit-equal to JAX's, carried
    into JAX), with rays: the 32x16 camera's primaries, random rays from
    inside the scene and rays toward the sphere light's neighbourhood,
    t_max finite on a third of them (0 on a few)."""
    host = jdemo()
    pad = jpadded(host)
    jsah = jbuild(host.num_batches, pad["indices"], pad["tri_mat"],
                  pad["valid"], host.vertices, host.normals, leaf_max=8)[0]
    th = build_demo_scene()
    tpad = padded_arrays(th)
    b = th.num_batches
    tv = [torch.from_numpy(th.vertices)[torch.from_numpy(
        tpad["indices"][:, k]).long()].reshape(b, BATCH_SIZE, 3)
        for k in range(3)]
    tl = build_scene_bvh(*tv, torch.from_numpy(tpad["valid"]))
    jl = JT.SceneBvh(*(jnp.asarray(getattr(tl, f).numpy()) for f in (
        "boxes_t", "children_t", "tris_t", "sorted_tri_index", "root_lo",
        "root_hi")))
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15, fov_y=1.1)
    w, h = 32, 16
    pix = jnp.arange(w * h, dtype=jnp.int32)
    rays = generate_rays_padded(camera_basis(cam), w, h, pix,
                                jnp.full((w * h, 2), 0.5),
                                jnp.full((w * h, 2), 0.5))
    rng = np.random.default_rng(12)
    org2 = (rng.random((512, 3)) * [16.0, 4.0, 16.0] - [8.0, 0.0, 8.0])
    org = np.concatenate([np.asarray(rays.org), org2]).astype(np.float32)
    dirs = np.concatenate([np.asarray(rays.dir), unit(rng, 512)])
    tmax = np.where(rng.random(len(org)) < 0.33, rng.random(len(org)) * 6.0,
                    np.inf).astype(np.float32)
    tmax[::97] = 0.0
    return dict(sah=(jsah, interop.bvh_from_jax(jsah, "cpu"), 8),
                lbvh=(jl, tl, 1)), org, dirs, tmax


@pytest.mark.parametrize("tree", ["sah", "lbvh"])
def test_intersect_scene_matches_jax(trees, tree):
    tr, org, dirs, tmax = trees
    jbvh, tbvh, lw = tr[tree]
    ref = _jax_trace(lw)(jbvh, jnp.asarray(org), jnp.asarray(dirs),
                         jnp.asarray(tmax))
    capped = np.isfinite(tmax)
    for any_hit, want in zip((False, True), ref):
        # t_max=None takes the unbounded path: the same hits as inf
        for tm in (None, tmax):
            steps = torch.zeros(len(org), dtype=torch.int64)
            ovf = torch.zeros(1, dtype=torch.int32)
            got = TTR.intersect_scene(
                tbvh, t(org), t(dirs), None if tm is None else t(tm),
                any_hit=any_hit, leaf_width=lw, overflow=ovf, steps=steps)
            assert int(ovf) == 0
            assert int(steps.max()) < TTR.MAX_TRAVERSAL_STEPS
            jt_ = np.asarray(want.tri)
            rows = ~capped if tm is None else np.ones(len(org), bool)
            hit = (jt_ >= 0) & rows
            assert 0.2 < hit.mean() < 0.95, (tree, any_hit, hit.mean())
            if any_hit:
                np.testing.assert_array_equal(
                    hit, (got.tri.numpy() >= 0) & rows)
                continue
            np.testing.assert_array_equal(jt_[rows], got.tri.numpy()[rows])
            close(np.asarray(want.t)[hit], got.t.numpy()[hit])
            for f in ("u", "v"):
                close(np.asarray(getattr(want, f))[hit],
                      getattr(got, f).numpy()[hit], rtol=0, atol=1e-5)
            assert np.isinf(got.t.numpy()[rows & ~hit]).all()
            if tm is not None:
                assert (got.tri.numpy()[tm == 0.0] == -1).all()
                assert (got.t.numpy()[hit] < tm[hit]).all()
                # capped rays: their hits are the closest under the cap
                assert (np.asarray(want.tri)[capped] >= 0).any()
    # occluded = any-hit's hit flag; brute force finds the closest slots
    occ = TTR.occluded(tbvh, t(org), t(dirs), t(tmax), leaf_width=lw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref[1].tri) >= 0)
    tt = tbvh.tris_t
    valid = torch.isfinite(tt).all(0) & ((tt[3:6] - tt[0:3]).abs().sum(0)
                                         + (tt[6:9] - tt[0:3]).abs().sum(0)
                                         > 0)
    bf = TTR.intersect_brute(t(org), t(dirs), tt[0:3].T, tt[3:6].T,
                             tt[6:9].T, valid=valid)
    jbf = JTR.intersect_brute(jnp.asarray(org), jnp.asarray(dirs),
                              *(jnp.asarray(tt[a:a + 3].T.numpy())
                                for a in (0, 3, 6)),
                              valid=jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(np.asarray(jbf.tri), bf.tri.numpy())
    closest = np.asarray(ref[0].t)[~capped]
    got_t = bf.t.numpy()[~capped]
    close(np.where(np.isfinite(closest), closest, 0),
          np.where(np.isfinite(got_t), got_t, 0))
