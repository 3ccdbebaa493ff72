"""The port's multi-device frame (rtrt_tpu_torch/parallel/) on the CPU:
gloo ranks spawned by frame_spmd.spawn (a file:// store in a temporary
directory, one thread a rank; the rank bodies are tests/torch_spmd_cases.py,
results come back through files in tmp_path), against the JAX package's
parallel/ on the virtual CPU devices of tests/conftest.py.

  * band_rows over 4 ranks at halos of 1 row, of a whole band and deeper
    than a band: the image's rows, clamped, bit for bit; _halo_exchange
    the same, and bit-equal to JAX's under shard_map (halo 2, the inputs
    of tests/test_engine_utils.py's tile test and a seeded image);
  * _global_histogram exactly equal to JAX's (psum) on the same inputs
    and a seeded luminance;
  * sharded_refit over 4 ranks bit-equal (atol 0, rtol 0) to JAX's
    replicated refit_nodes4 of the demo scene (tests/test_multichip.py's
    recipe: leaves padded to the rank count with edge rows);
  * make_tile_frame over 2 ranks against JAX's over 2 CPU devices at the
    demo scene's 32x16, two frames: within 1 u8 on every pixel (JAX's
    program is compiled whole: XLA contracts its shading into FMAs);
  * K5's band instantiation on the CPU: reproject_plain with row0 equal
    to the same rows of the full call, both filters;
  * what the mesh refuses (heights that do not divide over the ranks, the
    wavefront route with K1, a leaf count that does not divide).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from rtrt_tpu.bvh.refit import leaf_bounds as jleaf_bounds
from rtrt_tpu.bvh.refit import plan_refit4 as jplan
from rtrt_tpu.bvh.refit import refit_nodes4 as jrefit
from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.bvh.sah import bvh4_nodes as jbvh4
from rtrt_tpu.core.camera import camera_basis, make_camera, pixel_to_dir
from rtrt_tpu.engine import frame as JF
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.parallel import tile as JT
from rtrt_tpu.render import integrator as JI
from rtrt_tpu.render.integrator import SceneData as JScene
from rtrt_tpu.render.raygen import Rays as JRays
from rtrt_tpu.render.sampling import rand2
from rtrt_tpu.render import sky as JS
from rtrt_tpu.render.texture import make_soil_textures
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.bvh.refit import plan_refit4
from rtrt_tpu_torch.denoise.reproject import reproject_plain
from rtrt_tpu_torch.engine.frame import FrameStatic
from rtrt_tpu_torch.parallel.frame_spmd import spawn
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import FeatureFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

import torch_spmd_cases as cases

torch.set_num_threads(1)
W, H = 32, 16


def _jax_halo(x, halo, devices):
    mesh = Mesh(np.asarray(devices[:4]), (JT.AXIS,))
    return np.asarray(JT.shard_map(
        lambda b: JT._halo_exchange(b, halo, JT.AXIS), mesh=mesh,
        in_specs=P(JT.AXIS), out_specs=P(JT.AXIS),
        **JT.SM_NOCHECK)(jnp.asarray(x)))


def _jax_hist(lum, devices):
    mesh = Mesh(np.asarray(devices[:4]), (JT.AXIS,))
    return np.asarray(JT.shard_map(
        lambda b: JT._global_histogram(b, JT.AXIS), mesh=mesh,
        in_specs=P(JT.AXIS), out_specs=P(), **JT.SM_NOCHECK)(
        jnp.asarray(lum)))


@pytest.fixture(scope="module")
def refit_case():
    """The demo scene's SAH/BVH4 (JAX's host build), its refit plan and
    the (9, P) table padded to a leaf count that divides over 4 ranks."""
    scene = build_demo_scene()
    pad = padded_arrays(scene)
    bvh, _, _ = jbuild(scene.num_batches, jnp.asarray(pad["indices"]),
                       jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
                       jnp.asarray(scene.vertices),
                       jnp.asarray(scene.normals), leaf_max=8)
    raw4 = np.asarray(jbvh4(bvh))
    plan = jplan(raw4, leaf_width=8)
    n_pad = -(-plan.n_leaves // 4) * 4
    tt = np.pad(np.asarray(bvh.tris_t),
                ((0, 0), (0, (n_pad - plan.n_leaves) * 8)), mode="edge")
    lo, hi = jleaf_bounds(jnp.asarray(tt), n_pad, 8)
    want = np.asarray(jrefit(plan, lo[:plan.n_leaves], hi[:plan.n_leaves]))
    return raw4, tt, n_pad, want


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, refit_case):
    """One spawn of 4 gloo ranks running cases.collectives; the inputs and
    each rank's record."""
    rng = np.random.default_rng(21)
    raw4, tt, n_pad, _ = refit_case
    flags = FeatureFlags()
    d = dict(
        img=torch.from_numpy(rng.normal(size=(H, 5, 3)).astype(np.float32)),
        halo_img=torch.arange(4 * 8 * 2 * 3, dtype=torch.float32).reshape(
            32, 2, 3),
        lums=[torch.arange(4 * 8 * 2 * 3, dtype=torch.float32).reshape(
            32, 2, 3)[..., 0].abs(),
            torch.from_numpy(np.concatenate([
                rng.lognormal(0.0, 3.0, (28, 16)),
                np.zeros((4, 16))]).astype(np.float32))],
        plan=plan_refit4(raw4), tris_t=torch.from_numpy(tt),
        n_leaves=n_pad,
        static_h=FrameStatic(render_w=W, render_h=18, screen_w=W,
                             screen_h=18, flags=flags),
        static_packets=FrameStatic(render_w=W, render_h=H, screen_w=W,
                                   screen_h=H, flags=flags,
                                   use_megakernel=False, use_packets=True))
    tmp = tmp_path_factory.mktemp("collectives")
    torch.save(d, tmp / "in.pt")
    spawn(cases.collectives, 4, (str(tmp / "in.pt"), str(tmp / "rank")),
          device="cpu")
    return d, [torch.load(tmp / f"rank{r}", weights_only=False)
               for r in range(4)]


def test_band_rows_any_depth(four_ranks):
    """Global rows [r0 - k, r1 + k), clamped to the image, on every rank:
    k = 1, a whole band (4 rows) and 7 (deeper than a band)."""
    d, recs = four_ranks
    img = d["img"]
    for rec in recs:
        r0, r1 = rec["rows"]
        assert r1 - r0 == H // 4
        for k, got in rec["band_rows"].items():
            ys = np.clip(np.arange(r0 - k, r1 + k), 0, H - 1)
            assert torch.equal(got, img[ys]), (r0, k)
        for k, got in rec["halo"].items():
            ys = np.clip(np.arange(r0 - k, r1 + k), 0, H - 1)
            assert torch.equal(got, img[ys]), ("halo", r0, k)


def test_halo_exchange_matches_jax(four_ranks, cpu_mesh_devices):
    """_halo_exchange of each rank, stacked, bit-equal to JAX's ppermute
    halos under shard_map on 4 devices (halo 2)."""
    d, recs = four_ranks
    want = _jax_halo(d["halo_img"].numpy(), 2, cpu_mesh_devices)
    got = torch.cat([rec["jax_halo"] for rec in recs]).numpy()
    np.testing.assert_array_equal(got, want)
    hs = H // 4
    want = _jax_halo(d["img"].numpy(), 2, cpu_mesh_devices)
    got = torch.cat([rec["halo"][2] for rec in recs]).numpy()
    assert got.shape == (4 * (hs + 4), 5, 3)
    np.testing.assert_array_equal(got, want)


def test_global_histogram_matches_jax(four_ranks, cpu_mesh_devices):
    """The all-reduced histogram, the same on every rank, exactly equal
    to JAX's psum of the shards' histograms."""
    d, recs = four_ranks
    for k, lum in enumerate(d["lums"]):
        want = _jax_hist(lum.numpy(), cpu_mesh_devices)
        assert want.sum() == lum.numel()
        for rec in recs:
            np.testing.assert_array_equal(rec["hist"][k].numpy(), want)


def test_sharded_refit_matches_jax(four_ranks, refit_case):
    """Every rank's node table bit-equal to JAX's replicated refit."""
    _, recs = four_ranks
    want = refit_case[3]
    for rec in recs:
        np.testing.assert_allclose(rec["refit"].numpy(), want, rtol=0,
                                   atol=0)


def test_mesh_refuses(four_ranks):
    """What JAX's frame_spmd.py:110-113 refuses: heights that do not divide
    over the ranks (the mesh and the frame function), the wavefront route
    with K1; and a leaf count that does not divide (sharded_refit)."""
    _, recs = four_ranks
    for rec in recs:
        r = rec["refused"]
        assert set(r) == {"make_row_mesh", "screen_h", "spmd_height",
                          "spmd_packets", "refit_pad"}, r
        assert "render_h=18 must divide over 4" in r["make_row_mesh"]
        assert "screen_h=30" in r["screen_h"]
        assert "render_h=18" in r["spmd_height"]
        assert "megakernel" in r["spmd_packets"]


@pytest.mark.parametrize("history_filter", ["catmull_rom", "bilinear"])
def test_reproject_band_equals_full_rows(history_filter):
    """reproject_plain with row0 and the band's motion rows equal to the
    same rows of the whole image's call, bit for bit, for bands that tile
    the image (270-row bands' shape: not aligned to anything)."""
    rng = np.random.default_rng(9)
    h, w = 36, 20
    f = lambda *s: torch.from_numpy(rng.uniform(0, 3, s).astype(np.float32))
    hist = (f(h, w, 3), f(h, w, 3), f(h, w),
            torch.from_numpy(rng.integers(-1, 4, (h, w)).astype(np.int32)),
            f(h, w))
    mv = torch.from_numpy((rng.uniform(-9, 9, (h, w, 2)) / [w, h]).astype(
        np.float32))
    full = reproject_plain(*hist, mv, history_filter)
    for r0, r1 in ((0, 9), (9, 18), (18, 27), (27, 36), (5, 6)):
        got = reproject_plain(*hist, mv[r0:r1], history_filter, row0=r0)
        for fld in full._fields:
            assert torch.equal(getattr(got, fld),
                               getattr(full, fld)[r0:r1]), (r0, fld)


def _tile_gbuffers(jscene, cams):
    """JAX's path_trace (use_packets=False) of the whole image's rays of
    parallel/tile.py's raygen, for frame k from cams[k + 1] with cams[k]
    as the previous camera, op by op with its traversal jitted (as
    tests/test_torch_wavefront.py runs it): the G-buffers, each plane
    stacked over the frames, (frames, H * W, ...)."""
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    pix = (ys.astype(jnp.int32) * W + xs.astype(jnp.int32)).reshape(-1)
    uv0 = jnp.stack([jnp.broadcast_to(xs, (H, W)).reshape(-1),
                     jnp.broadcast_to(ys, (H, W)).reshape(-1)], axis=-1)
    loop = JI.intersect_scene
    JI.intersect_scene = jax.jit(loop, static_argnames=(
        "any_hit", "leaf_width", "max_steps"))
    try:
        out = []
        for k, (prev, cam) in enumerate(zip(cams, cams[1:])):
            basis = camera_basis(cam)
            uv = (uv0 + rand2(pix, jnp.uint32(k), jnp.uint32(0))) \
                / jnp.array([W, H], jnp.float32)
            d = pixel_to_dir(basis, uv, W / H)
            rays = JRays(jnp.broadcast_to(basis.pos, d.shape), d, uv,
                         jnp.full(d.shape[:-1],
                                  2.0 * basis.tan_half_fov_y / H))
            out.append(JI.path_trace(jscene, rays, pix, jnp.uint32(k),
                                     camera_basis(prev), W / H,
                                     use_packets=False))
    finally:
        JI.intersect_scene = loop
    return type(out[0])(*(jnp.stack(p) for p in zip(*out)))


def test_tile_frame_matches_jax(tmp_path, cpu_mesh_devices, monkeypatch):
    """make_tile_frame over 2 gloo ranks against JAX's over 2 CPU devices:
    the demo scene at 32x16 through the wavefront's loop route on the
    two-level LBVH (JAX's build and sky bake, handed to the port), two
    frames with the history carried: within 1 u8 on every pixel.  JAX's
    frame is compiled with its path tracer evaluated op by op
    (_tile_gbuffers, looked up by the shard's pixel ids and frame): XLA
    compiling the bounce program under shard_map takes ~150 s on a CPU
    host, and contracts its shading into FMAs, which flips the 1-spp
    paths at their decision boundaries (tests/test_torch_wavefront.py);
    the path tracer is held op by op there."""
    host = build_demo_scene()
    pad = padded_arrays(host)
    # JAX's own two-level LBVH build and sky bake; the port is handed the
    # same tables (tests/test_torch_lbvh.py and tests/test_torch_sky.py
    # hold the port's own build and bake to these)
    jbvh, jnrm, jmat = jax.jit(JF.build_scene_tables, static_argnums=0)(
        host.num_batches, jnp.asarray(pad["indices"]),
        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
        jnp.asarray(host.vertices), jnp.asarray(host.normals))
    sky = JS.finalize_sky_maps(jax.jit(lambda p: JS.bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(JS.make_sky_params()))
    jscene = JScene(bvh=jbvh, tri_nrm_t=jnrm, tri_mat=jmat,
                    materials=host.materials, sky=sky,
                    textures=make_soil_textures(16), lights=host.lights)
    cams = [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(3)]
    gb = _tile_gbuffers(jscene, cams)
    monkeypatch.setattr(JT, "path_trace", lambda scene, rays, pix_ids,
                        frame_idx, *a, **k: type(gb)(
                            *(p[frame_idx, pix_ids] for p in gb)))
    jmesh = Mesh(np.asarray(cpu_mesh_devices[:2]), (JT.AXIS,))
    jfn = JT.make_tile_frame(jmesh, lambda v: jscene, W, H,
                             jparams().denoise)
    # the history row-sharded, as the frame returns it: one compile
    hist = jax.device_put(jnp.zeros((H, W, 3), jnp.float32),
                          NamedSharding(jmesh, P(JT.AXIS)))
    want = []
    for k, (prev, cam) in enumerate(zip(cams, cams[1:])):
        img, hist = jfn(jnp.asarray(host.vertices), cam, prev, hist,
                        jnp.uint32(k))
        want.append(np.asarray(img))

    t = lambda x: torch.from_numpy(np.array(x))
    scene = SceneData(tables=None,
                      materials=interop.materials_from_jax(host.materials,
                                                           "cpu"),
                      sky=interop.sky_from_jax(sky, "cpu"),
                      lights=interop.lights_from_jax(host.lights, "cpu"),
                      bvh=interop.bvh_from_jax(jbvh, "cpu"),
                      tri_nrm_t=t(jnrm), tri_mat=t(jmat).to(torch.int32))
    torch.save(dict(scene=scene, width=W, height=H,
                    denoise=tparams().denoise,
                    hist=torch.zeros((H, W, 3)),
                    cams=[interop.camera_from_jax(c, "cpu") for c in cams]),
               tmp_path / "in.pt")
    spawn(cases.tile_frames, 2, (str(tmp_path / "in.pt"),
                                 str(tmp_path / "out.pt")), device="cpu")
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    assert len(got) == len(want) == 2
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (H, W, 3) and g.dtype == torch.uint8
        d = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
        assert d.max() <= 1, (k, d.max(), (d > 0).mean())


# the row form of each stage, on the bands of a 40-row image (and a band
# not aligned to the 8- and 16-row tiles), against the whole image's call
SH, SW = 40, 24
BANDS = ((0, 10), (10, 20), (20, 30), (30, 40), (17, 23))


def _stage_inputs():
    rng = np.random.default_rng(31)
    f = lambda *s: torch.from_numpy(rng.uniform(0.05, 3, s).astype(
        np.float32))
    depth = f(SH, SW) * 4
    depth[:3] = float("inf")  # sky rows
    normal = torch.nn.functional.normalize(f(SH, SW, 3) - 1.5, dim=-1)
    mat = torch.from_numpy(rng.integers(-1, 3, (SH, SW)).astype(np.int32))
    # up to 1.5 px of motion on each axis: the stencil fetch's weights and
    # its rejection of motion beyond a pixel both in play
    motion = torch.from_numpy((rng.uniform(-1.5, 1.5, (SH, SW, 2))
                               / [SW, SH]).astype(np.float32))
    return dict(color=f(SH, SW, 3), normal=normal, depth=depth, mat=mat,
                motion=motion, hc=f(SH, SW, 3), hd=depth + f(SH, SW) * 0.01,
                hm=mat.clone(), hn=f(SH, SW) * 8)


def _temporal(d, r0, r1, pad, reproj):
    from rtrt_tpu_torch.denoise.temporal import temporal_filter
    from rtrt_tpu_torch.ops.stencil import clamp_rows

    if r0 is None:
        cut, ext, at = (lambda x: x), (lambda x: x), {}
    else:
        cut = lambda x: x[r0:r1]
        ext = lambda x: clamp_rows(x, r0 - pad, r1 + pad)
        at = dict(row0=r0, full_h=SH, pad=pad)
    p = tparams().denoise
    if reproj:
        rep = reproject_plain(d["hc"], d["hc"], d["hd"], d["hm"], d["hn"],
                              d["motion"])
        kw = dict(reproj=tuple(cut(getattr(rep, f)) for f in (
            "color", "depth", "mat_id", "count", "ok")))
    else:
        kw = dict(hist_color=ext(d["hc"]), hist_depth=ext(d["hd"]),
                  hist_mat=ext(d["hm"]), hist_count=ext(d["hn"]))
    return temporal_filter(ext(d["color"]), cut(d["normal"]),
                           cut(d["depth"]), cut(d["mat"]), cut(d["motion"]),
                           True, p, **kw, **at)


@pytest.mark.parametrize("stage", ["temporal_stencil", "temporal_reproj",
                                   "spatial_7x7", "spatial_wide_12",
                                   "bloom", "lens_flare", "upscale"])
def test_stage_rows_equal_whole(stage):
    """Each stage's row form — row0, and the `pad` rows on each side that
    its stencil reads, cut with the image's edge rows repeated as
    RowMesh.extend cuts them — equal to the same rows of the whole image's
    call, bit for bit: the temporal pass through the ±1 px stencil fetch
    (motion to pixels by the image's rows) and on a reprojection, the 7x7
    pass and the 5x5 pass at stride 12 (24 rows a side, deeper than a
    band) with their tile-noise gates, bloom and the lens flare on rows
    around a band, and the Catmull-Rom upscale's screen rows of a band."""
    from rtrt_tpu_torch.denoise.spatial import (spatial_filter_7x7,
                                                spatial_filter_wide)
    from rtrt_tpu_torch.denoise.temporal import (tile_noise_downsample,
                                                 tile_noise_level)
    from rtrt_tpu_torch.ops.resize import upscale_catmull_rom
    from rtrt_tpu_torch.ops.stencil import clamp_rows
    from rtrt_tpu_torch.post.bloom import bloom
    from rtrt_tpu_torch.post.lensflare import lens_flare
    from rtrt_tpu_torch.post.pipeline import band_halo

    d = _stage_inputs()
    p = tparams().denoise
    geo = (d["color"], d["normal"], d["depth"], d["mat"])
    noise8 = tile_noise_level(d["color"], d["depth"], 8)
    noise16 = tile_noise_downsample(noise8)
    sun = torch.tensor([0.4, 0.3])
    if stage.startswith("temporal"):
        reproj = stage == "temporal_reproj"
        whole = _temporal(d, None, None, 0, reproj)
        band = lambda r0, r1: _temporal(d, r0, r1, 1, reproj)
        want = lambda out, r0, r1: tuple(x[r0:r1] for x in out)
    elif stage.startswith("spatial"):
        if stage == "spatial_7x7":
            fn = lambda *x, **k: spatial_filter_7x7(*x, noise8, p, 1, **k)
            pad = 3
        else:
            fn = lambda *x, **k: spatial_filter_wide(*x, noise16, p, 12, **k)
            pad = 24
        whole = fn(*geo)
        band = lambda r0, r1: fn(*(clamp_rows(x, r0 - pad, r1 + pad)
                                   for x in geo), row0=r0, pad=pad)
        want = lambda out, r0, r1: out[r0:r1]
    elif stage == "bloom":
        whole = bloom(d["color"], torch.tensor(0.5), 0.05)
        band = lambda r0, r1: bloom(clamp_rows(d["color"], r0 - 2, r1 + 2),
                                    torch.tensor(0.5), 0.05,
                                    whole=d["color"], row0=r0 - 2)
        want = lambda out, r0, r1: clamp_rows(out, r0 - 2, r1 + 2)
    elif stage == "lens_flare":
        whole = lens_flare(SH, SW, sun, torch.tensor(1.0), 1.0)
        band = lambda r0, r1: lens_flare(SH, SW, sun, torch.tensor(1.0),
                                         1.0, row0=r0 - 2, n=r1 - r0 + 4)
        want = lambda out, r0, r1: clamp_rows(out, r0 - 2, r1 + 2)
    else:  # 40 -> 60 screen rows, bands of 15 with K3's row on each side
        oh, k = 60, band_halo(SH, 60)
        whole = upscale_catmull_rom(d["color"], oh, 36)
        band = lambda r0, r1: upscale_catmull_rom(
            clamp_rows(d["color"], r0 - k, r1 + k), oh, 36,
            out_rows=(r0 * oh // SH - 1, r1 * oh // SH + 1), row0=r0 - k,
            in_h=SH)
        want = lambda out, r0, r1: clamp_rows(out, r0 * oh // SH - 1,
                                              r1 * oh // SH + 1)
    bands = BANDS[:4] if stage == "upscale" else BANDS
    for r0, r1 in bands:
        got, ref = band(r0, r1), want(whole, r0, r1)
        if torch.is_tensor(got):
            got, ref = (got,), (ref,)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (stage, r0, r1)
