"""The plain K2 with a Fourier fit (megakernel_trace_plain(ftex=)) against
the JAX simulate_megakernel(ftex=) at 32x16 on the demo scene with its
floor marked textured (its own materials are untextured; > 20% of the
pixels are textured floor), at the bounds of
tests/test_torch_megakernel.py, which the fitted albedo would fail if the
fit were not shaded; and the fit outranks the procedural soil, as in the
JAX kernel.  The fit is a small one (8 atoms, frequencies up to 4): the
simulator's compile, not the fit, sets this file's time.  The series
themselves are held to JAX's in tests/test_torch_ftex.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.core.camera import camera_basis, make_camera
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.render import ftex as JX
from rtrt_tpu.render import megakernel as JM
from rtrt_tpu.render import texture as JT
from rtrt_tpu.render.integrator import SceneData as JSceneData
from rtrt_tpu.render.raygen import generate_rays_padded
from rtrt_tpu.render.sampling import rand2
from rtrt_tpu.render.sky import bake_sky_maps, finalize_sky_maps, \
    make_sky_params
from rtrt_tpu_torch.bvh.packet import pack_tables
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.core.camera import camera_basis as tbasis
from rtrt_tpu_torch.render import kshade as TK
from rtrt_tpu_torch.render import megakernel as TM
from rtrt_tpu_torch.render.raygen import Rays
from rtrt_tpu_torch.utils import interop
from test_torch_megakernel import _gbuffers_close

torch.set_num_threads(1)
W, H = 32, 16


def test_plain_megakernel_with_ftex_matches_simulator():
    jf = JX.fit_soil_fourier(JT.make_soil_textures(32), n_terms=8,
                             max_freq=4)
    tf = interop.ftex_from_jax(jf)
    host = build_demo_scene()
    pad = padded_arrays(host)
    mats = host.materials._replace(
        textured=host.materials.textured.at[1].set(1))
    jbvh, jnrm, jmat = jbuild(host.num_batches, pad["indices"],
                              pad["tri_mat"], pad["valid"], host.vertices,
                              host.normals, leaf_max=1)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    jscene = JSceneData(bvh=jbvh, tri_nrm_t=jnrm, tri_mat=jmat,
                        materials=mats, sky=sky, textures=None,
                        lights=host.lights)
    cam = make_camera(pos=(0.0, 3.0, -8.0), pitch=-0.2)
    basis = camera_basis(cam)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    jit_, lens = (rand2(pix, jnp.uint32(2), jnp.uint32(d)) for d in (0, 256))
    rays = generate_rays_padded(basis, W, H, pix, jit_, lens)
    out = jax.jit(lambda: JM.simulate_megakernel(
        jscene, rays, pix, jnp.uint32(2), max_steps=4096, ftex=jf))()
    ref = JM.finish_gbuffer(jscene, rays, out, basis, W / H)

    bvh, nrm, mat = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    tables = pack_tables(bvh, nrm, mat, bvh4_nodes(bvh))
    tsky = interop.sky_from_jax(sky, "cpu")
    trays = Rays(*(torch.from_numpy(np.array(x)) for x in rays))
    args = (tables, TK.pack_materials_rows(interop.materials_from_jax(
        mats, "cpu")), TM.pack_light_rows(interop.lights_from_jax(
            host.lights, "cpu"), "cpu"), TM.pack_sun_params(tsky), 2,
        trays.org, trays.dir, trays.cone_width,
        torch.arange(W * H, dtype=torch.int32))
    hits = [0, 0, 0]
    got = TM.megakernel_trace_plain(*args, n_lights=1, ftex=tf, hits=hits)
    assert hits[1] > 0.2 * W * H  # the floor's textured hits
    tb = tbasis(interop.camera_from_jax(cam, "cpu"))
    _gbuffers_close(ref, TM.finish_gbuffer(tsky, trays, got, tb, W / H))
    # the fit outranks the procedural soil: use_proctex does not matter
    alone = TM.megakernel_trace_plain(*args, n_lights=1, ftex=tf,
                                      use_proctex=False)
    for f in ("radiance", "albedo", "normal", "depth", "esc_beta"):
        assert torch.equal(getattr(alone, f), getattr(got, f)), f
