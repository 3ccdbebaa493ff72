"""The megakernel route at RTRT_SEGMENTS=3, in a process of its own (the
count is read when render/integrator.py is imported, in both packages):
run by tests/test_torch_env_switches.py, which sets the variable and
holds the numbers this prints to its bounds.

  (a) the port's plain K2 (megakernel_trace_plain + finish_gbuffer) against
      JAX's simulate_megakernel + finish_gbuffer at 3 segments (the
      port's default count, segments=None, as the frame passes it), fed the
      same rays, sky and scene as tests/test_torch_megakernel.py, with blue
      noise: the share of pixels of each G-buffer plane within that file's
      tolerances, each plane's mean relative error, and the same at 5
      segments (segments=5 on the port's side) to show that 3 is what both
      traced;
  (b) the port's megakernel frame against its wavefront frame
      (trace="packets": K1 a segment, render/integrator.py's loop) over two
      frames of the 32x16 demo scene: the largest per-pixel difference in
      LSB (tests/test_torch_frame.py holds it to 1 at 5 segments);
  (c) the shape of the plain K2's step planes at the default count.

Prints one line ``RESULT {json}``.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild  # noqa: E402
from rtrt_tpu.core.camera import camera_basis, make_camera  # noqa: E402
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays  # noqa
from rtrt_tpu.render import integrator as JI  # noqa: E402
from rtrt_tpu.render import megakernel as JM  # noqa: E402
from rtrt_tpu.render.raygen import generate_rays_padded  # noqa: E402
from rtrt_tpu.render.sampling import blue_offsets_flat, rand2_bn  # noqa
from rtrt_tpu.render.sky import (bake_sky_maps, finalize_sky_maps,  # noqa
                                 make_sky_params)
from rtrt_tpu_torch.bvh.packet import overflow_counter, pack_tables  # noqa
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes  # noqa
from rtrt_tpu_torch.core.camera import camera_basis as tbasis  # noqa: E402
from rtrt_tpu_torch.denoise.pipeline import init_history  # noqa: E402
from rtrt_tpu_torch.engine import frame as TF  # noqa: E402
from rtrt_tpu_torch.post.exposure import init_exposure_state  # noqa: E402
from rtrt_tpu_torch.render import integrator as TI  # noqa: E402
from rtrt_tpu_torch.render import megakernel as TM  # noqa: E402
from rtrt_tpu_torch.render.integrator import SceneData  # noqa: E402
from rtrt_tpu_torch.render.kshade import pack_materials_rows  # noqa: E402
from rtrt_tpu_torch.render.raygen import Rays  # noqa: E402
from rtrt_tpu_torch.utils import interop  # noqa: E402
from rtrt_tpu_torch.utils.config import FeatureFlags, default_params  # noqa

torch.set_num_threads(1)
W, H = 64, 32  # (a), as tests/test_torch_megakernel.py
FW, FH = 32, 16  # (b), as tests/test_torch_frame.py
FRAME = 3


def _close(ref, got):
    """{plane: (share within tolerance, mean relative error)} as
    tests/test_torch_megakernel.py::_gbuffers_close measures them."""
    out = {}
    for name in ("color", "albedo", "normal", "motion"):
        a = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy().reshape(a.shape)
        fin = np.isfinite(a)
        rtol = 2e-2 if name == "color" else 5e-3
        ok = np.isclose(a, g, rtol=rtol, atol=5e-3) | ~fin
        err = np.abs(np.where(fin, a - g, 0.0))
        scale = max(np.abs(np.where(fin, a, 0.0)).mean(), 1e-3)
        out[name] = (float(ok.mean()), float(err.mean() / scale))
    d_a = np.asarray(ref.depth)
    d_g = got.depth.numpy().reshape(d_a.shape)
    ok = (~np.isfinite(d_a) & ~np.isfinite(d_g)) | np.isclose(
        d_a, d_g, rtol=1e-4, atol=1e-4)
    out["depth"] = (float(ok.mean()), 0.0)
    m_ok = np.asarray(ref.mat_id) == got.mat_id.numpy().reshape(-1)
    out["mat_id"] = (float(m_ok.mean()), 0.0)
    return out


def main():
    res = dict(segments=dict(jax_megakernel=JM.SEGMENTS,
                             jax_integrator=JI.SEGMENTS,
                             port=TI.SEGMENTS))
    host = build_demo_scene()
    pad = padded_arrays(host)
    jbvh, jnrm, jmat = jbuild(host.num_batches, pad["indices"],
                              pad["tri_mat"], pad["valid"], host.vertices,
                              host.normals, leaf_max=1)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    jscene = JI.SceneData(bvh=jbvh, tri_nrm_t=jnrm, tri_mat=jmat,
                          materials=host.materials, sky=sky, textures=None,
                          lights=host.lights)
    bvh, nrm, mat = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    tables = pack_tables(bvh, nrm, mat, bvh4_nodes(bvh))
    tmats = interop.materials_from_jax(host.materials, "cpu")
    tlights = interop.lights_from_jax(host.lights, "cpu")
    tsky = interop.sky_from_jax(sky, "cpu")

    # (a) the plain K2 against the simulator
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    basis = camera_basis(cam)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    bn = jnp.asarray(blue_offsets_flat(W, H, W * H))
    jit_, lens = (rand2_bn(bn, jnp.uint32(FRAME), jnp.uint32(d))
                  for d in (0, 256))
    rays = generate_rays_padded(basis, W, H, pix, jit_, lens)
    out = jax.jit(lambda: JM.simulate_megakernel(
        jscene, rays, pix, jnp.uint32(FRAME), max_steps=4096, bn=bn))()
    ref = JM.finish_gbuffer(jscene, rays, out, basis, W / H)
    trays = Rays(*(torch.from_numpy(np.array(x)) for x in rays))
    tbn = torch.from_numpy(np.array(bn))
    targs = (tables, pack_materials_rows(tmats),
             TM.pack_light_rows(tlights, "cpu"), TM.pack_sun_params(tsky),
             FRAME, trays.org, trays.dir, trays.cone_width,
             torch.arange(W * H, dtype=torch.int32))
    tb = tbasis(interop.camera_from_jax(cam, "cpu"))
    for key, segs in ((TI.SEGMENTS, None), (5, 5)):  # None: the default
        ovf = overflow_counter("cpu")
        got = TM.finish_gbuffer(tsky, trays, TM.megakernel_trace_plain(
            *targs, n_lights=1, bn=tbn, overflow=ovf, segments=segs), tb,
            W / H)
        res[f"plain_vs_jax_{key}"] = _close(ref, got)
        res[f"overflow_{key}"] = int(ovf)

    # (b) the megakernel frame against the wavefront frame
    scene = SceneData(tables=tables, materials=tmats, sky=tsky,
                      lights=tlights, bvh=bvh, tri_nrm_t=nrm, tri_mat=mat)
    static = TF.FrameStatic(render_w=FW, render_h=FH, screen_w=FW,
                            screen_h=FH, flags=FeatureFlags())
    fcam = interop.camera_from_jax(make_camera(
        pos=(0.0, 3.0, -9.0), pitch=-0.15, fov_y=1.1), "cpu")
    imgs = {}
    for name, st in (("megakernel", static),
                     ("packets", TF.FrameStatic(
                         render_w=FW, render_h=FH, screen_w=FW, screen_h=FH,
                         flags=FeatureFlags(), use_megakernel=False))):
        state = TF.FrameState(exposure=init_exposure_state("cpu"),
                              history=init_history(FH, FW, device="cpu"))
        ovf = overflow_counter("cpu")
        imgs[name] = []
        for _ in range(2):
            img, state, _ = TF.render_frame(st, scene, state, fcam, fcam,
                                            default_params(), 1 / 60,
                                            overflow=ovf)
            imgs[name].append(img.numpy().astype(np.int32))
        res[f"frame_overflow_{name}"] = int(ovf)
    res["frame_lsb_max"] = [int(np.abs(a - b).max()) for a, b in
                            zip(imgs["megakernel"], imgs["packets"])]

    # (c) the step planes
    steps = torch.zeros((TI.SEGMENTS + 1, W * H), dtype=torch.int32)
    TM.megakernel_trace_plain(*targs, n_lights=1, bn=tbn, steps=steps)
    res["steps_rows"] = int(steps.shape[0])
    res["steps_sum_ok"] = bool(torch.equal(steps[1:].sum(0), steps[0]))
    res["steps_live"] = [float((s > 0).float().mean()) for s in steps[1:]]
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
