"""Megakernel program: the port's plain megakernel + finish_gbuffer vs the
JAX `simulate_megakernel` + `finish_gbuffer`, at 64x32 on the demo scene,
with and without blue noise, fed identical rays, sky and scene tables.

Bounds are those of tests/test_megakernel.py::_gbuffers_close, for the same
reasons: >= 98% of pixels within rtol/atol 5e-3 per G-buffer plane and a
mean relative error below 1% (the sun-disk limb term amplifies 1-ulp
cosine differences ~2000x, and a stochastic MIS branch that flips at a
float decision boundary diverges a whole path), depth rtol 1e-4 and equal
material ids on >= 98%.  Here the traversals also differ — the JAX
simulator runs the watertight wavefront traverser on a 1-triangle-leaf SAH
tree, the port Moller-Trumbore on the 8-slot BVH4 tree — which moves hits
on shared edges only.

One bound differs: the demodulated radiance ("color") is compared at rtol
2e-2 instead of 5e-3 (still on >= 98% of pixels, and the 1% energy bound
is unchanged).  Measured without blue noise: 97.5% of colour pixels within
5e-3, 99.7% within 2e-2, 100% of the albedo, normal, motion, depth and
material planes (with blue noise: 100% within 5e-3).  The cause is the
sun-disk limb term of the sun NEE sample, fed by XLA's FMA contraction:
  * with the limb term set to 1 on both sides (sun_disk_radiance_c of both
    kshade modules patched), 99.95% of colour pixels are within 5e-3;
  * JAX's own kshade.sample_sun_c, jitted on the CPU, differs from the same
    function run op by op (jax.disable_jit) by > 5e-3 in radiance on 17% of
    65,536 uniform samples; the port's torch twin differs from the op-by-op
    JAX run on 0.02% of them (wi bit-equal on 99.9%);
  * the jitted sample's x86 object code holds 19 FMA instructions
    (vfmadd/vfmsub/vfnmadd), which the op-by-op run and torch's CPU ops do
    not fuse; near the cone's edge the limb term's slope turns the ulp
    moved in cos into percent-level radiance.
Rounding the port's 1 - cos^2 once, as an FMA would, does not change the
97.5%: the ulp that matters comes from the contracted dot products that
form the sampled direction and its cosine.

K2 is held to this plain version on the card in test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.core.camera import camera_basis, make_camera
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.render import megakernel as JM
from rtrt_tpu.render.integrator import SceneData as JSceneData
from rtrt_tpu.render.raygen import generate_rays_padded
from rtrt_tpu.render.sampling import blue_offsets_flat, rand2, rand2_bn
from rtrt_tpu.render.sky import bake_sky_maps, finalize_sky_maps, \
    make_sky_params
from rtrt_tpu_torch.bvh.packet import overflow_counter, pack_tables
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.core.camera import camera_basis as tbasis
from rtrt_tpu_torch.render import megakernel as TM
from rtrt_tpu_torch.render.kshade import pack_materials_rows
from rtrt_tpu_torch.render.raygen import Rays
from rtrt_tpu_torch.utils import interop

torch.set_num_threads(1)
W, H = 64, 32


def _gbuffers_close(ref, got, atol=5e-3, frac=0.98):
    for name in ("color", "albedo", "normal", "motion"):
        a = np.asarray(getattr(ref, name))
        g = getattr(got, name).cpu().numpy().reshape(a.shape)
        fin = np.isfinite(a)
        rtol = 2e-2 if name == "color" else 5e-3
        ok = np.isclose(a, g, rtol=rtol, atol=atol) | ~fin
        assert ok.mean() >= frac, f"{name}: only {ok.mean():.4f} match"
        err = np.abs(np.where(fin, a - g, 0.0))
        scale = max(np.abs(np.where(fin, a, 0.0)).mean(), 1e-3)
        assert err.mean() / scale < 0.01, \
            f"{name}: mean rel err {err.mean() / scale:.4f}"
    d_a = np.asarray(ref.depth)
    d_g = got.depth.cpu().numpy().reshape(d_a.shape)
    both_inf = ~np.isfinite(d_a) & ~np.isfinite(d_g)
    ok = both_inf | np.isclose(d_a, d_g, rtol=1e-4, atol=1e-4)
    assert ok.mean() >= frac, f"depth: only {ok.mean():.4f} match"
    m_ok = np.asarray(ref.mat_id) == got.mat_id.cpu().numpy().reshape(-1)
    assert m_ok.mean() >= frac


@pytest.fixture(scope="module")
def setup():
    host = build_demo_scene()
    pad = padded_arrays(host)
    jbvh, jnrm, jmat = jbuild(host.num_batches, pad["indices"],
                              pad["tri_mat"], pad["valid"], host.vertices,
                              host.normals, leaf_max=1)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    jscene = JSceneData(bvh=jbvh, tri_nrm_t=jnrm, tri_mat=jmat,
                        materials=host.materials, sky=sky, textures=None,
                        lights=host.lights)
    bvh, nrm, mat = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    tscene = dict(tables=pack_tables(bvh, nrm, mat, bvh4_nodes(bvh)),
                  materials=interop.materials_from_jax(host.materials, "cpu"),
                  lights=interop.lights_from_jax(host.lights, "cpu"),
                  sky=interop.sky_from_jax(sky, "cpu"))
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    return jscene, tscene, cam


def _run(setup, use_bn, frame=3):
    jscene, ts, cam = setup
    basis = camera_basis(cam)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    bn = jnp.asarray(blue_offsets_flat(W, H, W * H)) if use_bn else None
    if use_bn:
        jit_, lens = (rand2_bn(bn, jnp.uint32(frame), jnp.uint32(d))
                      for d in (0, 256))
    else:
        jit_, lens = (rand2(pix, jnp.uint32(frame), jnp.uint32(d))
                      for d in (0, 256))
    rays = generate_rays_padded(basis, W, H, pix, jit_, lens)
    out = jax.jit(lambda: JM.simulate_megakernel(
        jscene, rays, pix, jnp.uint32(frame), max_steps=4096, bn=bn))()
    ref = JM.finish_gbuffer(jscene, rays, out, basis, W / H)
    trays = Rays(*(torch.from_numpy(np.array(x)) for x in rays))
    return ref, trays, (None if bn is None
                        else torch.from_numpy(np.array(bn))), \
        tbasis(interop.camera_from_jax(cam, "cpu"))


def _plain(ts, trays, bn, frame, device="cpu"):
    from rtrt_tpu_torch.render.megakernel import pack_light_rows, \
        pack_sun_params
    return TM.megakernel_trace_plain(
        ts["tables"], pack_materials_rows(ts["materials"]),
        pack_light_rows(ts["lights"], device), pack_sun_params(ts["sky"]),
        frame, trays.org, trays.dir, trays.cone_width,
        torch.arange(W * H, dtype=torch.int32), n_lights=1, bn=bn)


@pytest.mark.parametrize("use_bn", [False, True])
def test_plain_megakernel_matches_simulator(setup, use_bn):
    ref, trays, bn, basis = _run(setup, use_bn)
    ts = setup[1]
    ovf = overflow_counter("cpu")
    from rtrt_tpu_torch.render.integrator import SceneData
    scene = SceneData(**ts)
    got = TM.path_trace_mega(scene, trays, torch.arange(W * H), 3, basis,
                             W / H, bn=bn, overflow=ovf)
    assert int(ovf) == 0
    _gbuffers_close(ref, got)
    # the wrapper's CPU route is the plain version, bit for bit
    plain = TM.finish_gbuffer(ts["sky"], trays, _plain(ts, trays, bn, 3),
                              basis, W / H)
    assert torch.equal(plain.color, got.color)
    assert torch.equal(plain.depth, got.depth)
