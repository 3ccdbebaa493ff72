"""The CUDA kernels of rtrt_tpu_torch on the card, each against its plain
PyTorch version on the same inputs.  The file imports nothing of JAX: its
inputs are built by the port alone (scene, tables, sky and rays from the
port's Engine; random rays and frames from a numpy seed), so it runs on a
GPU host without JAX (`python -m pytest -m gpu tests/test_torch_kernels_gpu.py`).
Without a card every test skips.

Tolerances:
  * K1 traversal: hit slot equal on >= 99.9% of rays (a ray through a
    shared edge may resolve to either neighbour when nvcc contracts the
    Moller-Trumbore products into FMA), t to rtol 1e-5 where it is equal,
    0 stack overflows.
  * K2 megakernel: per pixel on >= 99% — depth rtol 1e-4, mat id equal,
    normal, albedo, esc_dir and esc_pdf atol 5e-3 (an ulp of FMA
    contraction can move a bounce across a decision boundary, and then the
    whole path diverges), esc_beta atol 5e-3 + rtol 1e-2; the escape planes
    exactly equal where the primary ray misses (nothing is computed there);
    mean radiance per channel within 1%.  Why esc_beta has an rtol: a
    scattered path's throughput is divided by 1 - q, the probability of
    the shadow-or-scatter choice, and q holds the sun-disk limb term,
    which turns an ulp of the sampled cosine into a percent-level change.
    In the plain version alone, on this scene at this size, computing the
    sun sample's cosine with one rounding instead of three moves esc_beta
    beyond atol 5e-3 on 3.2% of the primary hits (by 0.24% of its value at
    the median, the escape direction unchanged on 98.8% of them); with
    rtol 1e-2 added, 99.98% agree.  The kernel differs from the plain
    version the same way: 4.3% of hits beyond atol 5e-3, by 0.25-0.5%.
    The same bounds at segments=3 (RTRT_SEGMENTS=3), with step planes of
    4 rows.
  * K3 post tail: u8 within 1 LSB everywhere and equal on >= 99.9% (a value
    within a few ulps of a quantisation step may round either way: the
    kernel's gamma is exp2(log2) by the fast intrinsics and its divisions
    __fdividef, each within 2 ulps).  At ragged shapes (1x1 up to 1080p,
    widths that are not multiples of the 4-pixel group or the 128-pixel
    tile, a colour buffer that is not 16-byte aligned) every byte of the
    output is written: two launches into buffers pre-filled with 0 and 255
    agree.
  * K3 on pre-mapped input (the instantiation that follows the
    Catmull-Rom upscale): the same bound, at ragged shapes (1x1, 37x5,
    480x270, 1920x1080, an unaligned buffer), into outputs pre-filled
    with 0 and 255.
  * K2 as persistent lanes: a launch over any subset of a frame's pixels
    (1, 37, 4,099 or all of them; the output pre-filled with NaN) writes
    every pixel, bit-equal to the same pixels of the full frame's launch:
    each pixel's arithmetic does not depend on the lane or the chunk that
    runs it.
  * K4 a-trous pass: rtol 1e-4 + atol 1e-5 on >= 99.9% of pixels and
    rtol 1e-3 + atol 1e-4 on all.  The kernel does not round as the plain
    version does: x^sigma_n by binary exponentiation (six squarings for
    64, ~4e-6 relative), the depth weight by __expf, products and sums
    contracted into FMA (csrc/denoise_wide.cu states the a-priori error).
  * K5 reprojection: colour rtol 1e-5 + atol 1e-6 on >= 99.99% of pixels
    (the same order; each tap's product and sum fused by fmaf, so 16
    roundings a channel fewer, each within an ulp); depth, count,
    material and ok exactly equal on every pixel.  Also on three motion
    fields at a ragged size: a smooth pan, +-30 px noise (taps scattered
    over a 60-pixel window) and the two side by side.  Its bilinear
    instantiation (RTRT_HISTORY_FILTER=bilinear) at the same bounds, at
    1x1, 37x5 and 140x232 in both history dtypes; a filter without an
    instantiation refused by the wrapper and by the C entry.  Its band
    instantiation (row0, rows) bit-equal to the same rows of the full
    launch, in both filters and dtypes.
  * The row-sharded frame (parallel/frame_spmd.py) over 2 gloo ranks that
    share the card: within 1 u8 of the single-process frame on every
    pixel and differing on < 5% (bit-equal expected).
  * K1 under a step cap (max_steps / count_steps): as K1, and each ray's
    visit count equal on >= 99.9% of rays and never above the cap.
  * K1 and K2 on the chain scene (engine/scene.py::build_chain_scene, 12
    BVH4 levels, so its tables take the 256-entry stack): 0 dropped
    pushes, a deepest stack beyond 32 entries and within 3 per level; K1's
    hits equal the plain version's (slot and t as K1 above; the rays pass
    far from every edge, so all slots agree), K2's primary hits too (mat
    id equal and depth to rtol 1e-5 on every ray).
  * K6-K9, the traversal-step probes (rtrt_tpu_torch/tools): the tolerances
    of tests/test_torch_probes.py — K6 exact in loop and fetch and rtol
    2^-20 in the other modes, K7-K9 bit-equal with equal visit counts (the
    kernels round every product on its own, as torch does), on the tools'
    own inputs and on rays that hit every record.
  * K10-K16, the hardware probes (probe_cond, probe_smem, probe_pressure,
    probe_broadcast, probe_xpose, probe_bf16): bit-equal in every mode on
    every input recipe of tests/test_torch_hw_probes.py (K10, K12, K14 and
    K16 also at every row count 8-64, split over c = 1-4 SMs; K10, K12-K15
    refuse a table and K11 an x that is not 16-byte aligned).  The kernels
    round each product on its own (__fmul_rn) and each bf16 operation to
    bf16, as torch's ops do; K10's three modes agree, and so do K15's two.
    K11, on its grid of rows / 8 blocks at 8, 32 and 64 rows, is accepted
    at 48 KB and at the card's opt-in maximum, refused one float beyond it
    and at every size of the JAX tool (0.25-4 MiB).
  * K1 and K2 on the refitted tables of the animated 1080p terrain
    (Engine(..., animation="wave") after three frames): as K1 and K2 above,
    on every 8th primary ray (K1) and every 4th row and column of the
    frame (K2), except that K1's t, where the slots agree, is held as
    chip_smoke phase 3 holds it at 1080p: rtol 1e-5 + 4e-6 on >= 99.99%
    of rays and rtol 1e-3 on all (grazing rays over the terrain, |cos| ~
    0.005-0.02, differ by ~2.5e-5 t: measured one ray of 259,198 at
    1.08e-5 t); the frame's tables keep their levels and stack.  K1 on a
    tree whose empty slots hold the inverted (+inf, -inf) boxes refit
    writes (tests/torch_refit_cases.py): the same hits as the plain version
    and brute force, no NaN, 0 dropped pushes.
  * The two-level LBVH (Engine(..., bvh="lbvh", animation="wave") on the
    1080p terrain, three rebuilt frames under sync debug "error"): the
    device build equal to the CPU build of the same arrays on every table
    (the vertex normals, summed in atomic order, within 1e-5); K1's and
    K2's binary instantiations against their plain versions at the bounds
    of the refitted terrain's tests, 0 dropped pushes, the deepest stack
    within the static bound; the C entries refuse any (arity, stack) pair
    without an instantiation, the wrappers tables of the wrong layout.
  * The flat binary SAH tree (Engine(..., bvh="sah2") on the 1080p terrain
    with FeatureFlags(fourier_textures=True), three frames under sync
    debug "error"): K1's and K2's binary leaf-row instantiations at the
    tables' stack and at 256 entries against their plain versions at the
    bounds above (K1's hits also those of the BVH4 over the same leaf
    rows), 0 dropped pushes; K2's Fourier-texture instantiation on the
    flat tree, the BVH4 and the LBVH at K2's bounds; a leaf width or stack
    without an instantiation refused by the C entries, a fit that is not
    in cos / sin pairs by K2's wrapper.
  * K2's step instantiation (kSteps, the demo view above): its G-buffer
    bit-equal to the default instantiation's, its step planes equal to
    the plain version's on >= 99.9% of pixels.
"""

import numpy as np
import pytest
import torch

from rtrt_tpu_torch.bvh import packet as P
from rtrt_tpu_torch.core.camera import camera_basis
from rtrt_tpu_torch.denoise.reproject import reproject, reproject_plain
from rtrt_tpu_torch.denoise.spatial import (edge_aware_pass,
                                            edge_aware_pass_plain)
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.engine.scene import build_chain_scene, chain_scene_rays
from rtrt_tpu_torch.post.pipeline import dither_mask
from rtrt_tpu_torch.post.tail import post_tail, post_tail_plain, tail_params
from rtrt_tpu_torch.render import integrator as I
from rtrt_tpu_torch.render import megakernel as M
from rtrt_tpu_torch.render.ftex import upload_ftex
from rtrt_tpu_torch.render.kshade import pack_materials_rows
from rtrt_tpu_torch.render.raygen import generate_rays_padded
from rtrt_tpu_torch.render.sampling import rand2_bn
from rtrt_tpu_torch.tools import (probe_bf16, probe_broadcast, probe_cond,
                                  probe_cores, probe_leaf, probe_pressure,
                                  probe_smem, probe_xpose, ubench_step)
from rtrt_tpu_torch.utils import cuda
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings, default_params)
from torch_refit_cases import brute_hits, inverted_slot_case

torch.set_num_threads(1)
W, H = 128, 72
SLICE = FeatureFlags(denoise=False, bloom=False, lens_flare=False)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def engine(cuda_device):
    return Engine(GlobalSettings(scene="demo", render_width=W,
                                 render_height=H,
                                 dynamic_resolution=DynamicResolution(
                                     enabled=False)),
                  flags=SLICE, device=cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_matches_plain(engine, cuda_device, any_hit):
    rng = np.random.default_rng(21)
    n = 8192
    org = rng.uniform(-6, 6, (n, 3)) + [0, 3, -9]
    d = rng.uniform(-4, 4, (n, 3)) + [0, 1, 0] - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.2, rng.uniform(0.5, 8, n),
                     np.inf)
    args = [torch.from_numpy(x.astype(np.float32)).to(cuda_device)
            for x in (org, d, t_max)]
    tables = engine.scene_data.tables
    ovf = P.overflow_counter(cuda_device)
    got = P.packet_intersect(tables, *args, any_hit=any_hit, overflow=ovf)
    ref = P.packet_intersect_plain(tables, *args, any_hit=any_hit)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    assert (ref.tri >= 0).float().mean() > 0.3  # the rays do hit things
    same = got.tri == ref.tri
    assert same.float().mean() >= 0.999
    torch.testing.assert_close(got.t[same], ref.t[same], rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("use_bn", [False, True])
def test_megakernel_matches_plain(engine, cuda_device, use_bn):
    sc, consts = engine.scene_data, engine.consts
    rw, rh = engine.render_w, engine.render_h  # the bucket's size
    bn = consts.bn if use_bn else None
    pix = consts.pixel_ids
    jitter = rand2_bn(consts.bn, 3, 0)
    lens = rand2_bn(consts.bn, 3, 256)
    rays = generate_rays_padded(camera_basis(engine.camera), rw, rh, pix,
                                jitter, lens)
    args = (sc.tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 3, rays.org, rays.dir,
            rays.cone_width, pix)
    ovf = P.overflow_counter(cuda_device)
    got = M.megakernel_trace(*args, n_lights=1, bn=bn, overflow=ovf)
    ref = M.megakernel_trace_plain(*args, n_lights=1, bn=bn)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    miss = (got.mat_id == -1) & (ref.mat_id == -1)
    assert 0 < miss.float().mean() < 1  # sky and scene both in view
    d_ok = torch.isclose(got.depth, ref.depth, rtol=1e-4, atol=0) | (
        torch.isinf(got.depth) & torch.isinf(ref.depth))
    assert d_ok.float().mean() >= 0.99
    assert (got.mat_id == ref.mat_id).float().mean() >= 0.99
    for f in ("normal", "albedo", "esc_dir", "esc_beta", "esc_pdf"):
        a, b = getattr(got, f), getattr(ref, f)
        rtol = 1e-2 if f == "esc_beta" else 0.0
        ok = ((a - b).abs() - rtol * b.abs()).reshape(rh, rw, -1).amax(-1) \
            <= 5e-3
        assert ok[~miss].float().mean() >= 0.99, f
        if f.startswith("esc"):
            assert torch.equal(a[miss], b[miss]), f
    torch.testing.assert_close(got.radiance.mean((0, 1)),
                               ref.radiance.mean((0, 1)), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.gpu
def test_megakernel_steps_matches_plain(engine, cuda_device):
    """K2's step instantiation (kSteps): its G-buffer planes bit-equal to
    the default instantiation's on the same rays, its (SEGMENTS + 1, N)
    step planes equal to the plain version's on >= 99.9% of pixels (a
    path that branches apart at the bounds above counts other visits), the
    segments summing to the total, 0 after a path ends."""
    sc, consts = engine.scene_data, engine.consts
    rw, rh = engine.render_w, engine.render_h
    pix = consts.pixel_ids
    rays = generate_rays_padded(camera_basis(engine.camera), rw, rh, pix,
                                rand2_bn(consts.bn, 3, 0),
                                rand2_bn(consts.bn, 3, 256))
    args = (sc.tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 3, rays.org, rays.dir,
            rays.cone_width, pix)
    n = rw * rh
    out_a, out_b = (torch.full((18, n), float("nan"), device=cuda_device)
                    for _ in range(2))
    steps = torch.full((I.SEGMENTS + 1, n), -1, dtype=torch.int32,
                       device=cuda_device)
    plain = torch.zeros((I.SEGMENTS + 1, n), dtype=torch.int32,
                        device=cuda_device)
    cuda.reset_launch_counts()
    M.megakernel_trace(*args, n_lights=1, bn=consts.bn, out=out_a)
    M.megakernel_trace(*args, n_lights=1, bn=consts.bn, out=out_b,
                       steps=steps)
    M.megakernel_trace_plain(*args, n_lights=1, bn=consts.bn, steps=plain)
    torch.cuda.synchronize()
    assert cuda.launch_counts["megakernel_trace_steps"] == 1
    assert cuda.launch_counts["megakernel_trace"] == 1
    assert torch.equal(out_a, out_b)
    assert (steps >= 0).all()
    assert torch.equal(steps[1:].sum(0), steps[0])
    assert (steps[1] > 0).float().mean() > 0.3  # primaries traverse
    same = (steps == plain).all(0)
    assert same.float().mean() >= 0.999
    with pytest.raises(ValueError, match="Fourier"):
        M.megakernel_trace(*args, n_lights=1, bn=consts.bn, steps=steps,
                           ftex=object())


@pytest.mark.gpu
def test_megakernel_segments_matches_plain(engine, cuda_device):
    """K2 at segments=3 (RTRT_SEGMENTS=3's route): its planes against the
    plain version's at 3 at test_megakernel_matches_plain's bounds and
    unlike the 5-segment launch's, its step planes of 4 rows equal to the
    plain version's on >= 99.9% of pixels; 0 and 6 refused."""
    sc, consts = engine.scene_data, engine.consts
    rw, rh = engine.render_w, engine.render_h
    pix = consts.pixel_ids
    rays = generate_rays_padded(camera_basis(engine.camera), rw, rh, pix,
                                rand2_bn(consts.bn, 3, 0),
                                rand2_bn(consts.bn, 3, 256))
    args = (sc.tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 3, rays.org, rays.dir,
            rays.cone_width, pix)
    n = rw * rh
    kw = dict(n_lights=1, bn=consts.bn, segments=3)
    got = M.megakernel_trace(*args, **kw)
    ref = M.megakernel_trace_plain(*args, **kw)
    five = M.megakernel_trace(*args, n_lights=1, bn=consts.bn, segments=5)
    steps = torch.full((4, n), -1, dtype=torch.int32, device=cuda_device)
    plain = torch.zeros((4, n), dtype=torch.int32, device=cuda_device)
    got_s = M.megakernel_trace(*args, **kw, steps=steps)
    M.megakernel_trace_plain(*args, **kw, steps=plain)
    torch.cuda.synchronize()
    for f in ("radiance", "albedo", "normal", "depth", "esc_beta"):
        assert torch.equal(getattr(got, f), getattr(got_s, f)), f
    assert not (torch.equal(got.radiance, five.radiance)
                and torch.equal(got.esc_beta, five.esc_beta))
    d_ok = torch.isclose(got.depth, ref.depth, rtol=1e-4, atol=0) | (
        torch.isinf(got.depth) & torch.isinf(ref.depth))
    assert d_ok.float().mean() >= 0.99
    assert (got.mat_id == ref.mat_id).float().mean() >= 0.99
    miss = (got.mat_id == -1) & (ref.mat_id == -1)
    for f in ("normal", "albedo", "esc_dir", "esc_beta", "esc_pdf"):
        a, b = getattr(got, f), getattr(ref, f)
        rtol = 1e-2 if f == "esc_beta" else 0.0
        ok = ((a - b).abs() - rtol * b.abs()).reshape(rh, rw, -1).amax(-1) \
            <= 5e-3
        assert ok[~miss].float().mean() >= 0.99, f
    torch.testing.assert_close(got.radiance.mean((0, 1)),
                               ref.radiance.mean((0, 1)), rtol=1e-2,
                               atol=1e-4)
    assert (steps >= 0).all() and torch.equal(steps[1:].sum(0), steps[0])
    assert (steps == plain).all(0).float().mean() >= 0.999
    for bad in (0, 6):
        with pytest.raises(ValueError, match="segments"):
            M.megakernel_trace(*args, n_lights=1, bn=consts.bn,
                               segments=bad)


@pytest.mark.gpu
@pytest.mark.parametrize("tone", [0.0, 1.0, 2.0, 3.0])
def test_post_tail_kernel_matches_plain(cuda_device, tone):
    rng = np.random.default_rng(9)
    c = rng.lognormal(mean=-1.0, sigma=1.5, size=(301, 517, 3))
    c[:100] *= 4.0  # a bright band (sky-like)
    c = torch.from_numpy(c.astype(np.float32)).to(cuda_device)
    mask = dither_mask(cuda_device)
    par = tail_params(torch.tensor(0.8), tone, 2.2, 0.5, 0.37, cuda_device)
    for sh, di in ((True, True), (False, False)):
        got = post_tail(c, par, mask, do_sharpen=sh, do_dither=di)
        ref = post_tail_plain(c, par, mask, do_sharpen=sh, do_dither=di)
        torch.cuda.synchronize()
        d = (got.int() - ref.int()).abs()
        assert int(d.max()) <= 1
        assert (d.amax(-1) == 0).float().mean() >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("tone", [0.0, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (17, 131), (64, 130),
                                   (19, 260), (301, 517), (1080, 1920),
                                   "unaligned"])
def test_post_tail_kernel_ragged_shapes(cuda_device, shape, tone):
    h, w = (37, 256) if shape == "unaligned" else shape
    rng = np.random.default_rng(h * 7919 + w)
    c = rng.lognormal(mean=-1.0, sigma=1.5, size=(h, w, 3))
    c[: h // 3] *= 4.0
    c = torch.from_numpy(c.astype(np.float32)).to(cuda_device)
    if shape == "unaligned":  # a contiguous view 4 bytes into its buffer
        buf = torch.empty(h * w * 3 + 1, device=cuda_device)
        buf[1:].copy_(c.reshape(-1))
        c = buf[1:].view(h, w, 3)
        assert c.is_contiguous() and c.data_ptr() % 16
    mask = dither_mask(cuda_device)
    par = tail_params(torch.tensor(0.8), tone, 2.2, 0.5, 0.37, cuda_device)
    for sh, di in ((True, True), (False, False), (True, False)):
        outs = [post_tail(c, par, mask, do_sharpen=sh, do_dither=di,
                          out=torch.full((h, w, 3), v, dtype=torch.uint8,
                                         device=cuda_device))
                for v in (0, 255)]
        ref = post_tail_plain(c, par, mask, do_sharpen=sh, do_dither=di)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])  # every byte written
        d = (outs[0].int() - ref.int()).abs()
        assert int(d.max()) <= 1
        assert (d.amax(-1) == 0).float().mean() >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (37, 5), (270, 480), (1080, 1920),
                                   "unaligned"])
def test_post_tail_mapped_kernel_ragged_shapes(cuda_device, shape):
    h, w = (37, 256) if shape == "unaligned" else shape
    rng = np.random.default_rng(h * 131 + w)
    c = np.clip(rng.uniform(-0.1, 1.1, size=(h, w, 3)), 0.0, 1.0)
    c = torch.from_numpy(c.astype(np.float32)).to(cuda_device)
    if shape == "unaligned":  # a contiguous view 4 bytes into its buffer
        buf = torch.empty(h * w * 3 + 1, device=cuda_device)
        buf[1:].copy_(c.reshape(-1))
        c = buf[1:].view(h, w, 3)
        assert c.is_contiguous() and c.data_ptr() % 16
    mask = dither_mask(cuda_device)
    # ev and the tone map must not apply to a pre-mapped image
    par = tail_params(torch.tensor(3.0), 0.0, 1.0, 0.5, 0.37, cuda_device)
    cuda.reset_launch_counts()
    for sh, di in ((True, True), (False, False), (True, False)):
        outs = [post_tail(c, par, mask, do_sharpen=sh, do_dither=di,
                          mapped=True,
                          out=torch.full((h, w, 3), v, dtype=torch.uint8,
                                         device=cuda_device))
                for v in (0, 255)]
        ref = post_tail_plain(c, par, mask, do_sharpen=sh, do_dither=di,
                              mapped=True)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])  # every byte written
        d = (outs[0].int() - ref.int()).abs()
        assert int(d.max()) <= 1
        assert (d.amax(-1) == 0).float().mean() >= 0.999
    assert cuda.launch_counts["post_tail_mapped"] == 6
    assert cuda.launch_counts["post_tail"] == 0


@pytest.mark.gpu
def test_engine_frames_launch_the_kernels(engine):
    """The Engine renders its 480x270 bucket, out at the settings' 128x72:
    K2, then K3's pre-mapped instantiation after the resample."""
    cuda.reset_launch_counts()
    engine.overflow.zero_()
    for _ in range(2):
        img = engine.render_frame_device(1 / 60)
    torch.cuda.synchronize()
    assert (engine.render_w, engine.render_h) == (480, 270)
    assert img.shape == (H, W, 3) and img.dtype == torch.uint8
    assert cuda.launch_counts["megakernel_trace"] == 2
    assert cuda.launch_counts["post_tail_mapped"] == 2
    assert cuda.launch_counts["post_tail"] == 0
    assert int(engine.overflow) == 0
    for f in ("color", "albedo", "normal", "motion"):
        assert torch.isfinite(getattr(engine.last_gbuffer, f)).all(), f


def _gbuffer(engine, cuda_device):
    """A finished G-buffer of the demo scene from the port's own frame."""
    engine.render_frame_device(1 / 60)
    torch.cuda.synchronize()
    return engine.last_gbuffer


@pytest.mark.gpu
@pytest.mark.parametrize("radius,stride,half,parity", [
    (3, 1, True, 0), (3, 1, True, 1), (2, 3, False, 0), (2, 6, False, 0),
    (2, 12, False, 0)])
def test_denoise_wide_kernel_matches_plain(engine, cuda_device, radius,
                                           stride, half, parity):
    gb = _gbuffer(engine, cuda_device)
    args = (gb.color.contiguous(), gb.normal.contiguous(),
            gb.depth.contiguous(), gb.mat_id.contiguous(),
            default_params().denoise)
    kw = dict(radius=radius, stride=stride, half_taps=half, parity=parity)
    got = edge_aware_pass(*args, **kw)
    ref = edge_aware_pass_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs() - 1e-4 * ref.abs()
    assert (err.amax(-1) <= 1e-5).float().mean() >= 0.999
    assert bool((err <= 1e-4 + 9e-4 * ref.abs()).all())


def _gbuffer_np(h, w, seed=3):
    """A synthetic G-buffer: smooth normals and depth with noise, a sky
    band (inf depth), material patches; numpy seeded."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.stack([np.sin(xx / 7.0), np.ones_like(xx) * 2.0,
                  np.cos(yy / 5.0)], -1) + rng.normal(0, 0.05, (h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = 5.0 + xx / w * 20.0 + rng.normal(0, 0.1, (h, w))
    d[: max(h // 6, 1)] = np.inf
    mat = ((xx // 9 + yy // 7) % 3).astype(np.int32)
    c = rng.lognormal(-1.0, 1.0, (h, w, 3))
    return [x.astype(np.float32) if x.dtype.kind == "f" else x
            for x in (c, n, d, mat)]


@pytest.mark.gpu
@pytest.mark.parametrize("radius,stride,half,parity", [
    (3, 1, True, 0), (3, 1, True, 1), (2, 3, False, 0), (2, 6, False, 0),
    (2, 12, False, 0), (2, 64, False, 0), (3, 40, True, 1),
    (3, 2, False, 0)])
@pytest.mark.parametrize("h,w", [(37, 53), (8, 32), (101, 67)])
def test_denoise_wide_kernel_ragged_shapes(cuda_device, h, w, radius, stride,
                                          half, parity):
    """Sub-lattice tiles at shapes that are not multiples of the 32x8 tile,
    at strides up to beyond the image (every tap clamped to the edge)."""
    args = [torch.from_numpy(x).to(cuda_device) for x in _gbuffer_np(h, w)]
    kw = dict(radius=radius, stride=stride, half_taps=half, parity=parity)
    got = edge_aware_pass(*args, default_params().denoise, **kw)
    ref = edge_aware_pass_plain(*args, default_params().denoise, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs() - 1e-4 * ref.abs()
    assert (err.amax(-1) <= 1e-5).float().mean() >= 0.999
    assert bool((err <= 1e-4 + 9e-4 * ref.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", [270, 360, 540, 720])
def test_bucket_sizes_kernels_match_plain(cuda_device, bucket):
    """The dynamic-resolution buckets (480x270 ... 1280x720; no height a
    multiple of 16): K4's five passes of a frame, K5 and both K3
    instantiations against their plain versions at the bucket's size, with
    the tolerances above."""
    h, w = bucket, bucket * 16 // 9 // 16 * 16
    c, n, d, mat = (torch.from_numpy(x).to(cuda_device)
                    for x in _gbuffer_np(h, w, seed=bucket))
    p = default_params().denoise
    for radius, stride, half, parity in ((3, 1, True, 0), (3, 1, True, 1),
                                         (2, 3, False, 0), (2, 6, False, 0),
                                         (2, 12, False, 0)):
        kw = dict(radius=radius, stride=stride, half_taps=half,
                  parity=parity)
        got = edge_aware_pass(c, n, d, mat, p, **kw)
        ref = edge_aware_pass_plain(c, n, d, mat, p, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs() - 1e-4 * ref.abs()
        assert (err.amax(-1) <= 1e-5).float().mean() >= 0.999, kw
        assert bool((err <= 1e-4 + 9e-4 * ref.abs()).all()), kw
    rng = np.random.default_rng(bucket)
    bf = lambda x: x.to(torch.bfloat16)
    count = torch.from_numpy(rng.integers(0, 9, (h, w)).astype(
        np.float32)).to(cuda_device)
    motion = torch.from_numpy((rng.uniform(-4, 4, (h, w, 2)) / [w, h]).astype(
        np.float32)).to(cuda_device)
    got = reproject(bf(c), bf(c * 0.5), bf(d), mat, bf(count), motion)
    wide = lambda x: bf(x).to(torch.float32)
    ref = reproject_plain(wide(c), wide(c * 0.5), wide(d), mat, wide(count),
                          motion)
    torch.cuda.synchronize()
    for fld in ("color", "color2"):
        a, b = getattr(got, fld), getattr(ref, fld)
        close = ((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all(-1)
        assert close.float().mean() >= 0.9999, fld
    for fld in ("depth", "count", "mat_id", "ok"):
        assert torch.equal(getattr(got, fld), getattr(ref, fld)), fld
    mask = dither_mask(cuda_device)
    par = tail_params(torch.tensor(0.8), 1.0, 2.2, 0.5, 0.37, cuda_device)
    for mapped, img in ((False, c), (True, torch.clamp(c, 0.0, 1.0))):
        got = post_tail(img, par, mask, do_sharpen=True, do_dither=True,
                        mapped=mapped)
        ref = post_tail_plain(img, par, mask, do_sharpen=True, do_dither=True,
                              mapped=mapped)
        torch.cuda.synchronize()
        du = (got.int() - ref.int()).abs()
        assert int(du.max()) <= 1 and (du.amax(-1) == 0).float().mean() \
            >= 0.999, mapped


@pytest.fixture(scope="module")
def frame_1080p(cuda_device):
    """K2's planes of a full 1920x1080 demo frame, its inputs, and the
    plain version's planes."""
    eng = Engine(GlobalSettings(scene="demo", render_width=1920,
                                render_height=1080,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 flags=SLICE, device=cuda_device)
    sc, consts = eng.scene_data, eng.consts
    rays = generate_rays_padded(camera_basis(eng.camera), 1920, 1080,
                                consts.pixel_ids, rand2_bn(consts.bn, 1, 0),
                                rand2_bn(consts.bn, 1, 256))
    flat = dict(org=rays.org.reshape(-1, 3), dir=rays.dir.reshape(-1, 3),
                cone=rays.cone_width.reshape(-1),
                pix=consts.pixel_ids.reshape(-1), bn=consts.bn.reshape(-1, 2))
    common = (sc.tables, pack_materials_rows(sc.materials).to(cuda_device),
              M.pack_light_rows(sc.lights, cuda_device),
              M.pack_sun_params(sc.sky), 1)
    ovf, depth = P.overflow_counter(cuda_device), P.overflow_counter(
        cuda_device)
    full = torch.full((18, 1920 * 1080), float("nan"), device=cuda_device)
    got = M.megakernel_trace(*common, flat["org"], flat["dir"], flat["cone"],
                             flat["pix"], n_lights=1, bn=flat["bn"],
                             overflow=ovf, stack_depth=depth, out=full)
    ref = M.megakernel_trace_plain(*common, flat["org"], flat["dir"],
                                   flat["cone"], flat["pix"], n_lights=1,
                                   bn=flat["bn"])
    torch.cuda.synchronize()
    return common, flat, full, got, ref, int(ovf), int(depth)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 37, 4099, 1920 * 1080])
def test_megakernel_pixel_counts(frame_1080p, cuda_device, n):
    """Persistent lanes at pixel counts that are not multiples of a warp or
    a block and (but 1080p) smaller than one wave of the grid."""
    common, flat, full, got, ref, ovf, depth = frame_1080p
    stack = common[0].stack
    assert stack in cuda.traverse_stacks()
    assert ovf == 0 and 0 < depth < stack
    assert not torch.isnan(full).any()
    if n == 1920 * 1080:  # the full frame against the plain version
        miss = (got.mat_id == -1) & (ref.mat_id == -1)
        assert 0 < miss.float().mean() < 1
        d_ok = torch.isclose(got.depth, ref.depth, rtol=1e-4, atol=0) | (
            torch.isinf(got.depth) & torch.isinf(ref.depth))
        assert d_ok.float().mean() >= 0.99
        assert (got.mat_id == ref.mat_id).float().mean() >= 0.99
        for f in ("normal", "albedo", "esc_dir", "esc_beta", "esc_pdf"):
            a, b = getattr(got, f), getattr(ref, f)
            rtol = 1e-2 if f == "esc_beta" else 0.0
            ok = ((a - b).abs() - rtol * b.abs()).reshape(n, -1).amax(-1) \
                <= 5e-3
            assert ok[~miss].float().mean() >= 0.99, f
            if f.startswith("esc"):
                assert torch.equal(a[miss], b[miss]), f
        torch.testing.assert_close(got.radiance.mean(0), ref.radiance.mean(0),
                                   rtol=1e-2, atol=1e-4)
        return
    idx = torch.arange(n, device=cuda_device) * (full.shape[1] // n) + 11
    sub = {k: v[idx].contiguous() for k, v in flat.items()}
    out = torch.full((18, n), float("nan"), device=cuda_device)
    M.megakernel_trace(*common, sub["org"], sub["dir"], sub["cone"],
                       sub["pix"], n_lights=1, bn=sub["bn"], out=out)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    assert torch.equal(out, full[:, idx])


@pytest.mark.gpu
@pytest.mark.parametrize("half", [True, False])
def test_reproject_kernel_matches_plain(cuda_device, half):
    rng = np.random.default_rng(5)
    h, w = 72, 130
    dt = torch.bfloat16 if half else torch.float32
    f = lambda *s: torch.from_numpy(rng.uniform(0, 3, s).astype(
        np.float32)).to(cuda_device, dt)
    color, color2, count = f(h, w, 3), f(h, w, 3), f(h, w)
    depth = f(h, w)
    depth[:10] = float("inf")
    mat = torch.from_numpy(rng.integers(-1, 4, (h, w)).astype(
        np.int32)).to(cuda_device)
    px = np.concatenate([rng.uniform(-1, 1, (h // 4, w, 2)),
                         rng.uniform(-30, 30, (h // 4, w, 2)),
                         rng.integers(-4, 4, (h // 4, w, 2)) + 0.5,
                         rng.uniform(-0.6, 0.6, (h - 3 * (h // 4), w, 2))
                         * [w, h]])
    motion = torch.from_numpy((px / [w, h]).astype(np.float32)).to(
        cuda_device)
    got = reproject(color, color2, depth, mat, count, motion)
    wide = lambda x: x.to(torch.float32)
    ref = reproject_plain(wide(color), wide(color2), wide(depth), mat,
                          wide(count), motion)
    torch.cuda.synchronize()
    for fld in ("color", "color2"):
        a, b = getattr(got, fld), getattr(ref, fld)
        close = ((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all(-1)
        assert close.float().mean() >= 0.9999, fld
    for fld in ("depth", "count", "mat_id", "ok"):
        assert torch.equal(getattr(got, fld), getattr(ref, fld)), fld


def _motion_field(kind, h, w, rng):
    """(h, w, 2) motion in pixels: "pan", a uniform shift with a smooth
    sub-pixel ripple; "wild", +-30 px noise; "mixed", pan on the left half
    and wild on the right."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    pan = np.stack([-3.37 + 0.4 * np.sin(xx / 23.0 + yy / 41.0),
                    1.71 + 0.3 * np.cos(yy / 17.0)], -1)
    wild = rng.uniform(-30, 30, (h, w, 2))
    if kind == "pan":
        return pan
    if kind == "wild":
        return wild
    return np.where((xx < w // 2)[..., None], pan, wild)


def _reproject_field(dev, shape, kind, half, seed, history_filter=None):
    """K5 against its plain version on random history of `shape` under a
    motion field of `kind` (_motion_field), at the K5 bounds.  Returns the
    kernel's and the plain version's Reprojection."""
    rng = np.random.default_rng(seed)
    h, w = shape
    dt = torch.bfloat16 if half else torch.float32
    f = lambda *s: torch.from_numpy(rng.uniform(0, 3, s).astype(
        np.float32)).to(dev, dt)
    color, color2, count, depth = f(h, w, 3), f(h, w, 3), f(h, w), f(h, w)
    depth[: h // 14] = float("inf")  # sky rows
    mat = torch.from_numpy(rng.integers(-1, 4, (h, w)).astype(
        np.int32)).to(dev)
    px = _motion_field(kind, h, w, rng)
    motion = torch.from_numpy((px / [w, h]).astype(np.float32)).to(dev)
    got = reproject(color, color2, depth, mat, count, motion,
                    history_filter=history_filter)
    wide = lambda x: x.to(torch.float32)
    ref = reproject_plain(wide(color), wide(color2), wide(depth), mat,
                          wide(count), motion, history_filter=history_filter)
    torch.cuda.synchronize()
    for fld in ("color", "color2"):
        a, b = getattr(got, fld), getattr(ref, fld)
        close = ((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all(-1)
        assert close.float().mean() >= 0.9999, fld
    for fld in ("depth", "count", "mat_id", "ok"):
        assert torch.equal(getattr(got, fld), getattr(ref, fld)), fld
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("kind", ["pan", "wild", "mixed"])
def test_reproject_kernel_motion_fields(cuda_device, kind, half):
    _reproject_field(cuda_device, (140, 232), kind, half, 11)  # ragged 32x8


@pytest.mark.gpu
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("kind", ["pan", "wild", "mixed"])
@pytest.mark.parametrize("shape", [(1, 1), (37, 5), (140, 232)])
def test_reproject_bilinear_kernel_matches_plain(cuda_device, shape, kind,
                                                  half):
    """K5's bilinear instantiation (RTRT_HISTORY_FILTER=bilinear) against
    reproject_plain(..., history_filter="bilinear"): the bounds of the
    Catmull-Rom instantiation; its own launch counter."""
    cuda.reset_launch_counts()
    got, _ = _reproject_field(cuda_device, shape, kind, half, 13,
                              history_filter="bilinear")
    assert cuda.launch_counts["reproject_bilinear"] == 1
    assert cuda.launch_counts["reproject"] == 0
    if shape[0] * shape[1] > 100:  # the filter changes the colour
        cr, _ = _reproject_field(cuda_device, shape, kind, half, 13)
        assert not torch.allclose(got.color, cr.color)


@pytest.mark.gpu
def test_reproject_refuses_unknown_filter(cuda_device):
    """An unknown history filter is refused by the wrapper (ValueError) and
    by the C entry (cudaErrorInvalidValue) before anything launches."""
    import ctypes
    z = lambda *s: torch.zeros(s, device=cuda_device)
    planes = (z(4, 4, 3), z(4, 4, 3), z(4, 4), z(4, 4),
              torch.zeros((4, 4), dtype=torch.int32, device=cuda_device),
              z(4, 4, 2))
    with pytest.raises(ValueError, match="history filter"):
        reproject(*planes[:3], planes[4], planes[3], planes[5],
                  history_filter="lanczos")
    outs = (z(4, 4, 3), z(4, 4, 3), z(4, 4), z(4, 4),
            torch.zeros((4, 4), dtype=torch.int32, device=cuda_device),
            torch.zeros((4, 4), dtype=torch.bool, device=cuda_device))
    cuda.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        cuda.launch(cuda.library().rtrt_reproject, "reproject_bilinear",
                    cuda_device, *planes, ctypes.c_int(4), ctypes.c_int(4),
                    ctypes.c_int(0), ctypes.c_int(4), ctypes.c_int(0),
                    ctypes.c_int(2), *outs)
    assert cuda.launch_counts["reproject_bilinear"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("history_filter", ["catmull_rom", "bilinear"])
def test_reproject_band_kernel_matches_full(cuda_device, history_filter,
                                            half):
    """K5's band instantiation (row0, rows): the launch over each band of
    a ragged image (and a 1-row band) equal to the same rows of the full
    launch bit for bit, its own launch counter; rows beyond the history
    refused by the wrapper."""
    rng = np.random.default_rng(17)
    h, w = 140, 232
    dt = torch.bfloat16 if half else torch.float32
    f = lambda *s: torch.from_numpy(rng.uniform(0, 3, s).astype(
        np.float32)).to(cuda_device, dt)
    hist = (f(h, w, 3), f(h, w, 3), f(h, w),
            torch.from_numpy(rng.integers(-1, 4, (h, w)).astype(
                np.int32)).to(cuda_device), f(h, w))
    motion = torch.from_numpy((_motion_field("mixed", h, w, rng) / [w, h])
                              .astype(np.float32)).to(cuda_device)
    full = reproject(*hist, motion, history_filter=history_filter)
    name = ("reproject_bilinear" if history_filter == "bilinear"
            else "reproject") + "_band"
    cuda.reset_launch_counts()
    bands = ((0, 35), (35, 70), (70, 105), (105, 140), (77, 78))
    for r0, r1 in bands:
        got = reproject(*hist, motion[r0:r1].contiguous(),
                        history_filter=history_filter, row0=r0)
        torch.cuda.synchronize()
        for fld in got._fields:
            assert torch.equal(getattr(got, fld),
                               getattr(full, fld)[r0:r1]), (r0, fld)
    assert cuda.launch_counts[name] == len(bands)
    with pytest.raises(ValueError, match="rows"):
        reproject(*hist, motion[:10].contiguous(), row0=h - 5)


@pytest.mark.gpu
def test_sharded_frame_two_ranks_on_one_card(cuda_device, tmp_path):
    """The row-sharded frame (parallel/frame_spmd.py) over 2 gloo ranks
    that share cuda:0: the demo Engine's 480x270 frame out at 128x72 (the
    Catmull-Rom upscale and K3's pre-mapped instantiation), three frames of
    a slow pan with the history carried band-sharded: rank 0's gathered
    images within 1 u8 of the single-process frames on every pixel and
    differing on < 5% (bit-equal expected), each rank's history (135, 480,
    3), 0 dropped pushes."""
    import dataclasses

    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.parallel.frame_spmd import spawn

    import torch_spmd_cases as spmd_cases

    eng = Engine(GlobalSettings(scene="demo", render_width=W, render_height=H,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 flags=FeatureFlags(), device=cuda_device)
    cam0 = eng.camera
    cams = [dataclasses.replace(cam0, yaw=cam0.yaw + 0.01 * k)
            for k in range(4)]
    state, want = eng.state, []
    for prev, cam in zip(cams, cams[1:]):
        img, state, _ = F.render_frame(eng.static, eng.scene_data, state,
                                       cam, prev, eng.params, 1 / 60)
        want.append(img.cpu())
    torch.save(dict(frame=dict(static=eng.static, scene=eng.scene_data,
                               state=eng.state, cams=cams, params=eng.params,
                               frames=3)), tmp_path / "in.pt")
    cuda.library()  # the ranks load the built library
    spawn(spmd_cases.sharded_frames, 2,
          (str(tmp_path / "in.pt"), str(tmp_path / "out")), "cuda",
          share_device=True)
    recs = [torch.load(tmp_path / f"out{r}", weights_only=False)["frame"]
            for r in range(2)]
    assert len(recs[0]["images"]) == 3
    for k, (g, w) in enumerate(zip(recs[0]["images"], want)):
        assert g.shape == (H, W, 3)
        d = (g.int() - w.int()).abs().amax(-1)
        assert d.max() <= 1 and (d > 0).float().mean() < 0.05, k
    for rec in recs:
        assert rec["history"] == (135, 480, 3) and rec["overflow"] == 0


@pytest.mark.gpu
def test_engine_default_flags_launch_every_kernel(cuda_device):
    eng = Engine(GlobalSettings(scene="demo", render_width=W, render_height=H,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 flags=FeatureFlags(), device=cuda_device)
    cuda.reset_launch_counts()
    for _ in range(3):
        img = eng.render_frame_device(1 / 60)
    torch.cuda.synchronize()
    assert img.shape == (H, W, 3) and img.dtype == torch.uint8
    counts = cuda.launch_counts
    # the 480x270 bucket out at 128x72: K3's pre-mapped instantiation
    assert counts["megakernel_trace"] == 3 and counts["post_tail_mapped"] == 3
    assert counts["denoise_wide"] == 12 and counts["reproject"] == 3
    assert int(eng.overflow) == 0
    for fld in ("color", "color2", "depth", "count"):
        x = getattr(eng.state.history, fld).float()
        assert not torch.isnan(x).any(), fld


@pytest.mark.gpu
def test_engine_default_settings_render(cuda_device):
    """Engine(GlobalSettings(scene="terrain")), the defaults: 1080p, dynamic
    resolution on.  A slow frame drops to the 720 bucket, whose frames go
    through K3's pre-mapped instantiation; a fast one climbs back."""
    eng = Engine(GlobalSettings(scene="terrain"), device=cuda_device)
    cuda.reset_launch_counts()
    buckets = []
    for dt in (1 / 20, 1 / 60, 1 / 200, 1 / 60):
        img = eng.render_frame_device(dt)
        buckets.append(eng.render_h)
        assert eng.state.history.color.shape == (eng.render_h, eng.render_w,
                                                 3)
    torch.cuda.synchronize()
    assert img.shape == (1080, 1920, 3) and img.dtype == torch.uint8
    assert buckets == [720, 720, 1080, 1080]
    counts = cuda.launch_counts
    assert counts["megakernel_trace"] == 4 and counts["reproject"] == 4
    assert counts["post_tail"] == 2 and counts["post_tail_mapped"] == 2
    assert int(eng.overflow) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("frame", [4, 7])
def test_interlaced_frame_traces_full_rate_rows(engine, cuda_device, frame):
    """At 640x360 on the demo scene, an interlaced frame's traced G-buffer
    rows equal the full-rate frame's rows frame & 1, frame & 1 + 2, ...
    bit for bit, from the same state (K2 keys each pixel by its id)."""
    import dataclasses
    from rtrt_tpu_torch.denoise.pipeline import init_history
    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.post.exposure import init_exposure_state
    full = F.FrameStatic(render_w=640, render_h=360, screen_w=640,
                         screen_h=360, flags=FeatureFlags())
    il = dataclasses.replace(full, interlace=True)
    cam = engine.camera
    prev = dataclasses.replace(cam, yaw=cam.yaw - 0.01)
    out = {}
    cuda.reset_launch_counts()
    for static in (full, il):
        state = F.FrameState(exposure=init_exposure_state(cuda_device),
                             history=init_history(360, 640,
                                                  device=cuda_device),
                             frame_idx=frame)
        img, _, gb = F.render_frame(static, engine.scene_data, state, cam,
                                    prev, default_params(), 1 / 60)
        assert img.shape == (360, 640, 3)
        out[static.interlace] = gb
    torch.cuda.synchronize()
    assert cuda.launch_counts["megakernel_trace"] == 2
    p = frame & 1
    for name in ("color", "albedo", "normal", "depth", "motion", "mat_id"):
        traced, ref = getattr(out[True], name), getattr(out[False], name)
        assert traced.shape[0] == 180, name
        assert torch.equal(traced, ref[p::2]), name


def _random_rays(cuda_device, n=8192, seed=21):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-6, 6, (n, 3)) + [0, 3, -9]
    d = rng.uniform(-4, 4, (n, 3)) + [0, 1, 0] - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [torch.from_numpy(x.astype(np.float32)).to(cuda_device)
            for x in (org, d)]


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [2, 1 << 20])
def test_traverse_cap_matches_plain(engine, cuda_device, cap):
    org, d = _random_rays(cuda_device)
    tables = engine.scene_data.tables
    got = P.packet_intersect(tables, org, d, max_steps=cap, count_steps=True)
    ref = P.packet_intersect_plain(tables, org, d, max_steps=cap,
                                   count_steps=True)
    free = P.packet_intersect(tables, org, d)
    torch.cuda.synchronize()
    assert got.steps.dtype == torch.int32 and free.steps is None
    assert int(got.steps.max()) <= cap
    assert (got.steps == ref.steps).float().mean() >= 0.999
    same = got.tri == ref.tri
    assert same.float().mean() >= 0.999
    torch.testing.assert_close(got.t[same], ref.t[same], rtol=1e-5, atol=0)
    binding = bool((ref.steps == cap).any())
    assert binding == (cap == 2)
    if not binding:  # a cap that never binds changes no hit
        assert (got.tri == free.tri).float().mean() >= 0.999


@pytest.fixture(scope="module")
def chain_engine(cuda_device):
    return Engine(GlobalSettings(render_width=64, render_height=32,
                                 dynamic_resolution=DynamicResolution(
                                     enabled=False)),
                  flags=SLICE, scene=build_chain_scene(), device=cuda_device)


def _chain_rays(cuda_device, n=4096):
    return [torch.from_numpy(x).to(cuda_device)
            for x in chain_scene_rays(n, seed=3)]


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_deep_tree(chain_engine, cuda_device, any_hit):
    tables = chain_engine.scene_data.tables
    assert (tables.levels, tables.stack) == (12, 256)
    org, d = _chain_rays(cuda_device)
    ovf = P.overflow_counter(cuda_device)
    got = P.packet_intersect(tables, org, d, any_hit=any_hit, overflow=ovf)
    ref = P.packet_intersect_plain(tables, org, d, any_hit=any_hit)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    assert (ref.tri >= 0).float().mean() > 0.9
    assert torch.equal(got.tri, ref.tri)
    h = ref.tri >= 0
    torch.testing.assert_close(got.t[h], ref.t[h], rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_megakernel_deep_tree(chain_engine, cuda_device):
    sc = chain_engine.scene_data
    org, d = _chain_rays(cuda_device)
    n = org.shape[0]
    args = (sc.tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 0, org, d,
            torch.zeros(n, device=cuda_device),
            torch.arange(n, dtype=torch.int32, device=cuda_device))
    ovf, depth, pdepth = (P.overflow_counter(cuda_device) for _ in range(3))
    got = M.megakernel_trace(*args, n_lights=0, overflow=ovf,
                             stack_depth=depth)
    ref = M.megakernel_trace_plain(*args, n_lights=0, stack_depth=pdepth)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    for dep in (depth, pdepth):
        assert 32 < int(dep) <= 3 * sc.tables.levels
    assert (ref.mat_id >= 0).float().mean() > 0.9
    assert torch.equal(got.mat_id, ref.mat_id)
    h = ref.mat_id >= 0
    torch.testing.assert_close(got.depth[h], ref.depth[h], rtol=1e-5, atol=0)


# K6 on clusters of 1 (8, 16 rows), 2 (24) and 4 blocks (48, 64), across
# the wrap of its record index at 1024 steps
@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 50, 1025])
@pytest.mark.parametrize("rows", [8, 16, 24, 48, 64])
@pytest.mark.parametrize("mode", ubench_step.MODES)
def test_probe_step_kernel_matches_plain(cuda_device, mode, rows, steps):
    tab, ox = ubench_step.tool_inputs(rows, cuda_device)
    got = ubench_step.step_probe(mode, tab, ox, steps)
    ref = ubench_step.step_probe_plain(mode, tab, ox, steps)
    torch.cuda.synchronize()
    rtol = 0.0 if mode in ("loop", "fetch") else 2.0 ** -20
    torch.testing.assert_close(got, ref, rtol=rtol, atol=0)


# K7 across the wrap of its 128-entry stack
@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 50, 129])
@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("mode", probe_leaf.MODES)
def test_probe_leaf_kernel_matches_plain(cuda_device, mode, rows, steps):
    for make in (probe_leaf.tool_inputs, probe_leaf.hit_inputs):
        tab, planes = make(rows, cuda_device)
        got = probe_leaf.leaf_probe(mode, tab, planes, steps)
        ref = probe_leaf.leaf_probe_plain(mode, tab, planes, steps)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 16, 24, 32])
@pytest.mark.parametrize("mode", probe_cores.MODES)
def test_probe_cores_kernel_matches_plain(cuda_device, mode, rows):
    for make in (probe_cores.tool_inputs, probe_cores.hit_inputs):
        ntab, ttab, planes = make(rows, device=cuda_device)
        planes = planes[:, 0].contiguous()
        got, gv = probe_cores.cores_probe(mode, ntab, ttab, planes, 50)
        ref, rv = probe_cores.cores_probe_plain(mode, ntab, ttab, planes, 50)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(gv, rv)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tiles,big", [(8, 2, False), (32, 8, True)])
def test_probe_cores_grid_kernel_matches_plain(cuda_device, rows, tiles,
                                               big):
    for make in (probe_cores.tool_inputs, probe_cores.hit_inputs):
        ntab, ttab, planes = make(rows, tiles, big, device=cuda_device)
        got, gv = probe_cores.cores_probe_grid("both", ntab, ttab, planes, 50)
        ref, rv = probe_cores.cores_probe_grid_plain("both", ntab, ttab,
                                                     planes, 50)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(gv, rv)


@pytest.mark.gpu
def test_probe_wrappers_check_their_inputs(cuda_device):
    tab, ox = ubench_step.tool_inputs(8, cuda_device)
    with pytest.raises(ValueError, match="rows"):
        ubench_step.step_probe("loop", tab, torch.zeros(
            (12, 128), device=cuda_device), 4)
    with pytest.raises(ValueError, match="mode"):
        ubench_step.step_probe("fast", tab, ox, 4)
    ntab, ttab, planes = probe_cores.tool_inputs(8, device=cuda_device)
    with pytest.raises(ValueError, match="need >= 512"):
        probe_cores.cores_probe("both", ntab[:256].contiguous(), ttab,
                                planes[:, 0].contiguous(), 4)
    with pytest.raises(ValueError, match="planes"):
        probe_cores.cores_probe_grid("both", ntab, ttab,
                                     planes[:, 0].contiguous(), 4)


# ---------------------------------------------------------------------------
# K10-K16: the hardware probes
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", list(probe_cond.RECIPES))
@pytest.mark.parametrize("rows", list(range(8, 65, 8)))
def test_probe_cond_kernel_matches_plain(cuda_device, rows, recipe):
    """K10 over probe_cond.launch_geometry(rows)[0] = 1-4 SMs, each thread
    stepping element (0, 0): its three modes bit-equal to the plain
    version (so to each other), the spread and flip recipes' flagged steps
    included."""
    tab, x = probe_cond.RECIPES[recipe](rows, cuda_device)
    outs = [probe_cond.cond_probe(m, tab, x, 40) for m in probe_cond.MODES]
    ref = probe_cond.cond_probe_plain("flat", tab, x, 40)
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 32, 64])
def test_probe_smem_alloc_edges(cuda_device, rows):
    """K11 on its grid of rows / 8 blocks, each asking for the buffer:
    accepted at 48 KB and at the opt-in maximum, refused one float beyond
    and at every size of the JAX tool; bit-equal where it launches."""
    edges = probe_smem.edge_sizes(cuda_device)
    accepted = {label: probe_smem.try_alloc(n, cuda_device, rows)
                for label, n in edges}
    torch.cuda.synchronize()
    want = [False] * len(probe_smem.SIZES_MIB) + [True, True, False]
    assert list(accepted.values()) == want, accepted
    x = probe_cond.uniform_inputs(rows, cuda_device)[1]
    for n in (1, 2, 1024, probe_smem.optin_bytes(cuda_device) // 4):
        assert torch.equal(probe_smem.smem_alloc(x, n),
                           probe_smem.smem_alloc_plain(x, n))


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", list(probe_cond.RECIPES))
@pytest.mark.parametrize("rows", list(range(8, 65, 8)))
@pytest.mark.parametrize("mode", probe_smem.MODES)
def test_probe_smem_consume_kernel_matches_plain(cuda_device, mode, rows,
                                                 recipe):
    """K12 over 1-4 SMs in both modes, bit-equal to the plain version;
    extract also to K10 flat (the same instantiation)."""
    tab, x = probe_cond.RECIPES[recipe](rows, cuda_device)
    got = probe_smem.smem_consume(mode, tab, x, 40)
    ref = probe_smem.smem_consume_plain(mode, tab, x, 40)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if mode == "extract":
        assert torch.equal(got, probe_cond.cond_probe("flat", tab, x, 40))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", probe_pressure.ROWS)
@pytest.mark.parametrize("n_inv", probe_pressure.N_INV)
def test_probe_pressure_kernel_matches_plain(cuda_device, n_inv, rows):
    """K13 split over launch_geometry(rows)[0] blocks, each with its own
    shadow of element (0, 0): bit-equal on every recipe, the flip recipe's
    turning step flag included."""
    for name, make in probe_cond.RECIPES.items():
        tab, x = make(rows, cuda_device)
        got = probe_pressure.pressure_probe(n_inv, tab, x, 40)
        ref = probe_pressure.pressure_probe_plain(n_inv, tab, x, 40)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), name


@pytest.mark.gpu
@pytest.mark.parametrize("rows", list(range(8, 65, 8)))
@pytest.mark.parametrize("mode", probe_broadcast.MODES)
def test_probe_broadcast_kernel_matches_plain(cuda_device, mode, rows):
    """K14 on a cluster of launch_geometry(rows)[0] = 1, 2 or 4 blocks,
    every input recipe (the saturating one past step 32, where every lane
    adds record 0 each step), and the tool's pend shifted to negative
    values and above 2^30 (the int32 min orders both as the plain
    version's does): bit-equal to the plain version."""
    cases = {name: make(cuda_device, rows=rows)
             for name, make in probe_broadcast.RECIPES.items()}
    tab, ttab, pend = cases["scaled"]
    cases["negative"] = tab, ttab, pend - 512
    cases["above 2^30"] = tab, ttab, pend + (2 ** 30 + 1)
    for name, (tab, ttab, pend) in cases.items():
        got = probe_broadcast.broadcast_probe(mode, tab, ttab, pend, 300)
        ref = probe_broadcast.broadcast_probe_plain(mode, tab, ttab, pend,
                                                    300)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), name


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 16, 24, 32])
def test_probe_xpose_kernel_matches_plain(cuda_device, rows):
    """K15 over launch_geometry(rows)[0] = 1-4 blocks, both modes, both
    input recipes: bit-equal to each other and to the plain version."""
    for make in (probe_xpose.tool_inputs, probe_xpose.hit_inputs):
        tab, planes = make(rows, cuda_device)
        a, b = (probe_xpose.xpose_probe(m, tab, planes, 50)
                for m in probe_xpose.MODES)
        ref = probe_xpose.xpose_probe_plain("extract", tab, planes, 50)
        torch.cuda.synchronize()
        assert torch.equal(a, ref) and torch.equal(b, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 8, 50])
@pytest.mark.parametrize("dtype", list(probe_bf16.DTYPES))
def test_probe_bf16_kernel_matches_plain(cuda_device, dtype, steps):
    for make in (probe_bf16.tool_inputs, probe_bf16.uniform_inputs):
        x = make(64, cuda_device)
        got = probe_bf16.bf16_probe(dtype, x, steps)
        ref = probe_bf16.bf16_probe_plain(dtype, x, steps)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", list(range(8, 65, 8)))
@pytest.mark.parametrize("dtype", list(probe_bf16.DTYPES))
def test_probe_bf16_kernel_split_over_sms(cuda_device, dtype, rows):
    """K16 split over c = 1-4 SMs (probe_bf16.launch_geometry), both input
    recipes: bit-equal to the plain version."""
    assert probe_bf16.launch_geometry(rows)[0] == -(-rows // 16)
    for make in (probe_bf16.tool_inputs, probe_bf16.uniform_inputs):
        x = make(rows, cuda_device)
        ref = probe_bf16.bf16_probe_plain(dtype, x, 20)
        got = probe_bf16.bf16_probe(dtype, x, 20)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), make.__name__


@pytest.mark.gpu
def test_hw_probe_wrappers_check_their_inputs(cuda_device):
    tab, x = probe_cond.tool_inputs(64, cuda_device)
    with pytest.raises(ValueError, match="rows"):
        probe_cond.cond_probe("flat", tab, x[:12].contiguous(), 4)
    with pytest.raises(ValueError, match="rows"):
        probe_pressure.pressure_probe(0, tab, x[:16].contiguous(), 4)
    with pytest.raises(ValueError, match="n_inv"):
        probe_pressure.pressure_probe(5, tab, x, 4)
    with pytest.raises(ValueError, match="mode"):
        probe_smem.smem_consume("dma", tab, x, 4)
    # K10, K12, K13 and K15 read tab by float4: one float off a 16-byte
    # boundary is refused before any launch
    base = torch.zeros(128 * 128 + 1, device=cuda_device)
    bad = base[1:].view(128, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_cond.cond_probe("flat", bad, x, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_smem.smem_consume("smem", bad, x, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_pressure.pressure_probe(0, bad, x, 4)
    planes = probe_xpose.tool_inputs(8, cuda_device)[1]
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_xpose.xpose_probe("extract", bad, planes, 4)
    with pytest.raises(ValueError, match="dtype"):
        probe_broadcast.broadcast_probe(
            "extract", tab, tab, torch.zeros((64, 128), device=cuda_device),
            4)
    # K14 reads its records by float4 and K11 its x: one float off a
    # 16-byte boundary is refused before any launch
    pend = probe_broadcast.tool_inputs(cuda_device)[2]
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_broadcast.broadcast_probe("extract", bad, tab, pend, 4)
    xs = torch.zeros(64 * 128 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_smem.smem_alloc(xs[1:].view(64, 128), 1024)
    with pytest.raises(ValueError, match="rows"):
        probe_smem.smem_alloc(x[:12].contiguous(), 1024)


@pytest.fixture(scope="module")
def wave_engine(cuda_device):
    eng = Engine(GlobalSettings(scene="terrain", render_width=1920,
                                render_height=1080, texture_size=256,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 animation="wave", device=cuda_device)
    levels = (eng.scene_data.tables.levels, eng.scene_data.tables.stack)
    for _ in range(3):
        eng.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    assert (eng.scene_data.tables.levels,
            eng.scene_data.tables.stack) == levels
    assert int(eng.overflow) == 0
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_refitted_terrain(wave_engine, cuda_device, any_hit):
    eng = wave_engine
    consts = eng.consts
    rays = generate_rays_padded(camera_basis(eng.camera), eng.render_w,
                                eng.render_h, consts.pixel_ids,
                                rand2_bn(consts.bn, 3, 0),
                                rand2_bn(consts.bn, 3, 256))
    org = rays.org.reshape(-1, 3)[::8].contiguous()
    d = rays.dir.reshape(-1, 3)[::8].contiguous()
    tables = eng.scene_data.tables
    ovf = P.overflow_counter(cuda_device)
    got = P.packet_intersect(tables, org, d, any_hit=any_hit, overflow=ovf)
    ref = P.packet_intersect_plain(tables, org, d, any_hit=any_hit)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    assert (ref.tri >= 0).float().mean() > 0.3
    same = (got.tri == ref.tri) & (ref.tri >= 0)
    assert (got.tri == ref.tri).float().mean() >= 0.999
    dt = (got.t - ref.t).abs()[same]
    flat = 1e-5 * ref.t.abs()[same] + 4e-6
    assert (dt <= flat).float().mean() >= 0.9999
    assert (dt <= 1e-3 * ref.t.abs()[same]).all()


@pytest.mark.gpu
def test_megakernel_refitted_terrain(wave_engine, cuda_device):
    eng = wave_engine
    sc, consts = eng.scene_data, eng.consts
    sub = lambda x: x[::4, ::4].contiguous()
    rays = generate_rays_padded(camera_basis(eng.camera), eng.render_w,
                                eng.render_h, consts.pixel_ids,
                                rand2_bn(consts.bn, 5, 0),
                                rand2_bn(consts.bn, 5, 256))
    args = (sc.tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 5, sub(rays.org), sub(rays.dir),
            sub(rays.cone_width), sub(consts.pixel_ids))
    bn = sub(consts.bn)
    ovf = P.overflow_counter(cuda_device)
    got = M.megakernel_trace(*args, n_lights=0, bn=bn, overflow=ovf)
    ref = M.megakernel_trace_plain(*args, n_lights=0, bn=bn)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    miss = (got.mat_id == -1) & (ref.mat_id == -1)
    assert 0 < miss.float().mean() < 1
    d_ok = torch.isclose(got.depth, ref.depth, rtol=1e-4, atol=0) | (
        torch.isinf(got.depth) & torch.isinf(ref.depth))
    assert d_ok.float().mean() >= 0.99
    assert (got.mat_id == ref.mat_id).float().mean() >= 0.99
    for f in ("normal", "albedo", "esc_dir", "esc_beta", "esc_pdf"):
        a, b = getattr(got, f), getattr(ref, f)
        rtol = 1e-2 if f == "esc_beta" else 0.0
        ok = ((a - b).abs() - rtol * b.abs()).amax(-1) <= 5e-3 \
            if a.dim() == 3 else (a - b).abs() <= 5e-3
        assert ok[~miss].float().mean() >= 0.99, f
    torch.testing.assert_close(got.radiance.mean((0, 1)),
                               ref.radiance.mean((0, 1)), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_inverted_empty_slots(cuda_device, any_hit):
    tables, org, d = inverted_slot_case(cuda_device)
    ovf = P.overflow_counter(cuda_device)
    got = P.packet_intersect(tables, org, d, any_hit=any_hit, overflow=ovf)
    ref = P.packet_intersect_plain(tables, org, d, any_hit=any_hit)
    bt, btri = brute_hits(tables, org, d)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    assert not torch.isnan(got.t).any()
    assert torch.equal(got.tri, ref.tri)
    assert torch.equal(got.tri.long().clamp(max=0), btri.clamp(max=0))
    assert (got.tri[-128:] >= 0).all()
    h = got.tri >= 0
    torch.testing.assert_close(got.t[h], bt[h], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the two-level LBVH: the device build, K1 / K2's binary instantiations and
# the Engine that rebuilds it every frame
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lbvh_engine(cuda_device):
    """Engine(terrain, 1080p, bvh="lbvh", animation="wave") after three
    frames under sync debug "error": the rebuild (displace, normals, LBVH,
    tables in place) reads nothing back to the host."""
    eng = Engine(GlobalSettings(scene="terrain", render_width=1920,
                                render_height=1080, texture_size=256,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 animation="wave", bvh="lbvh", device=cuda_device)
    tables = eng.scene_data.tables
    ptrs = {f: getattr(tables, f).data_ptr()
            for f in ("nodes", "tris", "nrm", "ng", "mat")}
    nodes0 = tables.nodes.clone()
    eng.render_frame_device(dt=1 / 60)  # warm: first-call allocations
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.render_frame_device(dt=1 / 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cuda.launch_counts["megakernel_trace_binary"] == 3
    assert cuda.launch_counts["megakernel_trace"] == 0
    assert int(eng.overflow) == 0
    assert 0 < int(eng.stack_depth) <= tables.levels
    assert all(getattr(tables, f).data_ptr() == p for f, p in ptrs.items())
    assert not torch.equal(tables.nodes, nodes0)
    return eng


@pytest.mark.gpu
def test_lbvh_device_build_matches_cpu(lbvh_engine, cuda_device):
    """The terrain's build at the Engine's clock on the card and on the CPU
    from the same arrays (the vertices displaced and their normals summed
    on the card, then copied): every table equal (integer logic, and min /
    max of float32 boxes whose arithmetic rounds the same on both); the
    normals the card summed in atomic order against the CPU's sums within
    1e-5."""
    from rtrt_tpu_torch.engine import frame as F
    mesh, t = lbvh_engine.rest, lbvh_engine.state.time
    verts = F.displace_wave(mesh.vertices, t)
    nrm = F.compute_smooth_normals(verts, mesh.indices)
    torch.testing.assert_close(
        nrm.cpu(), F.compute_smooth_normals(verts.cpu(), mesh.indices.cpu()),
        rtol=0, atol=1e-5)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        out[dev.type] = F.build_scene_tables(
            mesh.valid.shape[0], *(x.to(dev) for x in (
                mesh.indices, mesh.tri_mat, mesh.valid, verts, nrm)))
    (g, gn, gm), (c, cn, cm) = out["cuda"], out["cpu"]
    for f in ("children_t", "sorted_tri_index", "boxes_t", "tris_t",
              "root_lo", "root_hi"):
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    assert torch.equal(gm.cpu(), cm) and torch.equal(gn.cpu(), cn)


def _terrain_rays(eng, frame, step):
    consts = eng.consts
    rays = generate_rays_padded(camera_basis(eng.camera), eng.render_w,
                                eng.render_h, consts.pixel_ids,
                                rand2_bn(consts.bn, frame, 0),
                                rand2_bn(consts.bn, frame, 256))
    return (rays.org.reshape(-1, 3)[::step].contiguous(),
            rays.dir.reshape(-1, 3)[::step].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_binary_matches_plain(lbvh_engine, cuda_device,
                                              any_hit):
    """K1's binary instantiation on the rebuilt terrain LBVH, at the bounds
    of the refitted terrain's test above."""
    org, d = _terrain_rays(lbvh_engine, 3, 8)
    tables = lbvh_engine.scene_data.tables
    ovf = P.overflow_counter(cuda_device)
    before = cuda.launch_counts["packet_intersect_binary"]
    got = P.packet_intersect(tables, org, d, any_hit=any_hit, overflow=ovf)
    ref = P.packet_intersect_plain(tables, org, d, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda.launch_counts["packet_intersect_binary"] == before + 1
    assert int(ovf) == 0
    assert (ref.tri >= 0).float().mean() > 0.3
    same = (got.tri == ref.tri) & (ref.tri >= 0)
    assert (got.tri == ref.tri).float().mean() >= 0.999
    dt = (got.t - ref.t).abs()[same]
    flat = 1e-5 * ref.t.abs()[same] + 4e-6
    assert (dt <= flat).float().mean() >= 0.9999
    assert (dt <= 1e-3 * ref.t.abs()[same]).all()


@pytest.mark.gpu
def test_megakernel_binary_matches_plain(lbvh_engine, cuda_device):
    """K2's binary instantiation on the rebuilt terrain LBVH, every 4th row
    and column of the frame, at K2's bounds; its deepest stack within the
    static bound."""
    eng = lbvh_engine
    sc, consts = eng.scene_data, eng.consts
    sub = lambda x: x[::4, ::4].contiguous()
    rays = generate_rays_padded(camera_basis(eng.camera), eng.render_w,
                                eng.render_h, consts.pixel_ids,
                                rand2_bn(consts.bn, 5, 0),
                                rand2_bn(consts.bn, 5, 256))
    args = (sc.tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 5, sub(rays.org), sub(rays.dir),
            sub(rays.cone_width), sub(consts.pixel_ids))
    bn = sub(consts.bn)
    ovf, depth = (P.overflow_counter(cuda_device) for _ in range(2))
    got = M.megakernel_trace(*args, n_lights=0, bn=bn, overflow=ovf,
                             stack_depth=depth)
    ref = M.megakernel_trace_plain(*args, n_lights=0, bn=bn)
    torch.cuda.synchronize()
    assert int(ovf) == 0 and 0 < int(depth) <= sc.tables.levels
    miss = (got.mat_id == -1) & (ref.mat_id == -1)
    assert 0 < miss.float().mean() < 1
    d_ok = torch.isclose(got.depth, ref.depth, rtol=1e-4, atol=0) | (
        torch.isinf(got.depth) & torch.isinf(ref.depth))
    assert d_ok.float().mean() >= 0.99
    assert (got.mat_id == ref.mat_id).float().mean() >= 0.99
    for f in ("normal", "albedo", "esc_dir", "esc_beta", "esc_pdf"):
        a, b = getattr(got, f), getattr(ref, f)
        rtol = 1e-2 if f == "esc_beta" else 0.0
        ok = ((a - b).abs() - rtol * b.abs()).amax(-1) <= 5e-3 \
            if a.dim() == 3 else (a - b).abs() <= 5e-3
        assert ok[~miss].float().mean() >= 0.99, f
    torch.testing.assert_close(got.radiance.mean((0, 1)),
                               ref.radiance.mean((0, 1)), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.gpu
def test_binary_kernels_refuse_other_layouts(lbvh_engine, cuda_device):
    """The binary instantiations exist at the 256-entry stack only, and the
    C entries refuse any other (arity, stack) pair before launching; tables
    of the wrong layout or on the CPU are refused by the wrappers."""
    import copy
    assert cuda.traverse_stacks(2, 1) == (256,)
    assert cuda.traverse_stacks() == P.STACK_DEPTHS
    tables = lbvh_engine.scene_data.tables
    org, d = _terrain_rays(lbvh_engine, 1, 4096)
    small = copy.copy(tables)
    small.stack = 32
    with pytest.raises(RuntimeError, match="cudaError 1"):
        P.packet_intersect(small, org, d)
    wrong = copy.copy(tables)
    wrong.tlas_internal += 1
    with pytest.raises(ValueError, match="two-level LBVH"):
        P.packet_intersect(wrong, org, d)
    with pytest.raises(ValueError, match="on cpu"):
        P.packet_intersect(tables.to("cpu"), org, d)


# ---------------------------------------------------------------------------
# the flat binary SAH tree (bvh="sah2": K1 / K2's binary instantiation with
# 8-slot leaf rows) and K2's Fourier-texture instantiations
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sah2_engine(cuda_device):
    """Engine(terrain, 1080p, FeatureFlags(fourier_textures=True),
    bvh="sah2") after its first three frames, all under sync debug "error"
    (the fit's coefficient table is made at init), and the same scene's
    BVH4 tables."""
    from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
    from rtrt_tpu_torch.engine.scene import padded_arrays
    eng = Engine(GlobalSettings(scene="terrain", render_width=1920,
                                render_height=1080, texture_size=256,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 FeatureFlags(fourier_textures=True), bvh="sah2",
                 device=cuda_device)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.render_frame_device(dt=1 / 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cuda.launch_counts["megakernel_trace_sah2_ftex"] == 3
    assert int(eng.overflow) == 0
    assert 0 < int(eng.stack_depth) <= eng.scene_data.tables.levels
    pad = padded_arrays(eng.scene)
    built = build_scene_tables_sah(
        eng.scene.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        eng.scene.vertices, eng.scene.normals, leaf_max=8)
    eng.bvh4_tables = P.pack_tables(*built, bvh4_nodes(built[0])).to(
        cuda_device)
    return eng


def _deep(tables):
    """The same tables traced at the 256-entry stack: the other
    instantiation of their tree."""
    import copy
    deep = copy.copy(tables)
    deep.stack = 256
    return deep


@pytest.mark.gpu
@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_sah2_matches_plain(sah2_engine, cuda_device,
                                            any_hit, deep):
    """K1's binary leaf-row instantiation on the terrain's flat SAH tree, at
    the tables' stack and at 256 entries, at the bounds of the refitted
    terrain's test; the hits of the BVH4 over the same leaf rows."""
    org, d = _terrain_rays(sah2_engine, 3, 8)
    tables = sah2_engine.scene_data.tables
    if deep:
        tables = _deep(tables)
    ovf = P.overflow_counter(cuda_device)
    before = cuda.launch_counts["packet_intersect_sah2"]
    got = P.packet_intersect(tables, org, d, any_hit=any_hit, overflow=ovf)
    ref = P.packet_intersect_plain(tables, org, d, any_hit=any_hit)
    four = P.packet_intersect(sah2_engine.bvh4_tables, org, d,
                              any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda.launch_counts["packet_intersect_sah2"] == before + 1
    assert int(ovf) == 0
    assert (ref.tri >= 0).float().mean() > 0.3
    same = (got.tri == ref.tri) & (ref.tri >= 0)
    assert (got.tri == ref.tri).float().mean() >= 0.999
    dt = (got.t - ref.t).abs()[same]
    flat = 1e-5 * ref.t.abs()[same] + 4e-6
    assert (dt <= flat).float().mean() >= 0.9999
    assert (dt <= 1e-3 * ref.t.abs()[same]).all()
    assert torch.equal(got.tri >= 0, four.tri >= 0) if any_hit else \
        (got.tri == four.tri).float().mean() >= 0.999


def _k2_close(got, ref):
    """K2's bounds (the module docstring) on a frame of planes."""
    miss = (got.mat_id == -1) & (ref.mat_id == -1)
    assert 0 < miss.float().mean() < 1
    d_ok = torch.isclose(got.depth, ref.depth, rtol=1e-4, atol=0) | (
        torch.isinf(got.depth) & torch.isinf(ref.depth))
    assert d_ok.float().mean() >= 0.99
    assert (got.mat_id == ref.mat_id).float().mean() >= 0.99
    for f in ("normal", "albedo", "esc_dir", "esc_beta", "esc_pdf"):
        a, b = getattr(got, f), getattr(ref, f)
        rtol = 1e-2 if f == "esc_beta" else 0.0
        ok = ((a - b).abs() - rtol * b.abs()).amax(-1) <= 5e-3 \
            if a.dim() == 3 else (a - b).abs() <= 5e-3
        assert ok[~miss].float().mean() >= 0.99, f
    torch.testing.assert_close(got.radiance.mean((0, 1)),
                               ref.radiance.mean((0, 1)), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("tree,ftex", [("sah2", False), ("sah2", True),
                                       ("sah2_deep", False), ("sah4", True),
                                       ("lbvh", True)])
def test_megakernel_sah2_and_ftex_match_plain(sah2_engine, lbvh_engine,
                                              cuda_device, tree, ftex):
    """K2's instantiations of this slice on the 1080p terrain, every 4th
    row and column: the flat SAH tree (at its stack and at 256 entries),
    and the Fourier-texture branch on each tree, at K2's bounds; the
    launch counted under its instantiation's name."""
    eng = lbvh_engine if tree == "lbvh" else sah2_engine
    sc, consts = eng.scene_data, eng.consts
    tables = {"sah2": sc.tables, "sah2_deep": _deep(sc.tables),
              "sah4": getattr(eng, "bvh4_tables", None),
              "lbvh": sc.tables}[tree]
    fit = sah2_engine.ftex if ftex else None
    sub = lambda x: x[::4, ::4].contiguous()
    rays = generate_rays_padded(camera_basis(eng.camera), eng.render_w,
                                eng.render_h, consts.pixel_ids,
                                rand2_bn(consts.bn, 5, 0),
                                rand2_bn(consts.bn, 5, 256))
    args = (tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 5, sub(rays.org), sub(rays.dir),
            sub(rays.cone_width), sub(consts.pixel_ids))
    bn = sub(consts.bn)
    name = P.kernel_name("megakernel_trace", tables) + ("_ftex" * ftex)
    before = cuda.launch_counts[name]
    ovf, depth = (P.overflow_counter(cuda_device) for _ in range(2))
    got = M.megakernel_trace(*args, n_lights=0, bn=bn, overflow=ovf,
                             stack_depth=depth, ftex=fit)
    hits = [0, 0, 0]
    ref = M.megakernel_trace_plain(*args, n_lights=0, bn=bn,
                                   ftex=fit.fit if ftex else None,
                                   hits=hits)
    torch.cuda.synchronize()
    assert cuda.launch_counts[name] == before + 1
    assert int(ovf) == 0 and 0 < int(depth) <= tables.levels * (
        3 if tables.arity == 4 else 1)
    assert hits[1] > 0.1 * hits[0]  # textured hits
    _k2_close(got, ref)


@pytest.mark.gpu
def test_sah2_and_ftex_kernels_refuse_other_layouts(sah2_engine,
                                                    cuda_device):
    """The flat tree's instantiations exist at both stacks; the C entries
    refuse a leaf width or a stack without an instantiation before
    launching, the wrappers tables of the wrong layout; a fit that is not
    in cos / sin pairs has no table, and K2's wrapper refuses a table
    that is not on the rays' device."""
    import copy
    assert cuda.traverse_stacks(2, 8) == P.STACK_DEPTHS
    assert cuda.traverse_stacks(2, 4) == ()
    tables = sah2_engine.scene_data.tables
    org, d = _terrain_rays(sah2_engine, 1, 4096)
    for attr, value in (("leaf_width", 4), ("stack", 64)):
        odd = copy.copy(tables)
        setattr(odd, attr, value)
        with pytest.raises(RuntimeError, match="cudaError 1"):
            P.packet_intersect(odd, org, d)
    wrong = copy.copy(tables)
    wrong.tlas_internal = 3
    with pytest.raises(ValueError, match="flat SAH tree"):
        P.packet_intersect(wrong, org, d)
    fit = sah2_engine.ftex.fit
    odd = fit._replace(albedo_ao=fit.albedo_ao._replace(
        phase=(0.5,) + fit.albedo_ao.phase[1:]))
    with pytest.raises(ValueError, match="cos / sin"):
        upload_ftex(odd, cuda_device)
    sc, consts = sah2_engine.scene_data, sah2_engine.consts
    rays = generate_rays_padded(camera_basis(sah2_engine.camera), 1920,
                                1080, consts.pixel_ids,
                                rand2_bn(consts.bn, 0, 0),
                                rand2_bn(consts.bn, 0, 256))
    with pytest.raises(ValueError, match="ftex: on cpu"):
        M.megakernel_trace(
            tables, pack_materials_rows(sc.materials).to(cuda_device),
            M.pack_light_rows(sc.lights, cuda_device),
            M.pack_sun_params(sc.sky), 0, rays.org, rays.dir,
            rays.cone_width, consts.pixel_ids, n_lights=0,
            ftex=upload_ftex(fit, "cpu"))


def _scene_to_cpu(sc):
    """A SceneData on the card -> the same tables on the CPU (the sky's
    tensors and its parameters too)."""
    import dataclasses

    def tensors_cpu(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).cpu()
            for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))})

    sky = tensors_cpu(sc.sky)
    sky = dataclasses.replace(sky, params=tensors_cpu(sky.params))
    return dataclasses.replace(
        sc, tables=sc.tables.to("cpu"), materials=sc.materials.to("cpu"),
        sky=sky, lights=None if sc.lights is None else sc.lights.to("cpu"))


@pytest.mark.gpu
def test_wavefront_frame_matches_plain(engine, cuda_device):
    """The wavefront route (trace="packets": K1 once a bounce segment) on
    the card against the same frame on the CPU, where K1's wrapper runs
    its plain version, from the same tables, sky and camera: 96x48 of the
    demo scene with its sphere light, the denoiser off.  K1 launches 5
    times, K2 none.  Bounds as K2's above: mat id equal and depth rtol
    1e-4 on >= 99% of pixels, mean demodulated colour per channel within
    1%, every plane finite."""
    import dataclasses

    from rtrt_tpu_torch.engine.frame import FrameState, render_frame
    from rtrt_tpu_torch.post.exposure import init_exposure_state

    static = dataclasses.replace(engine.static, render_w=96, render_h=48,
                                 screen_w=96, screen_h=48,
                                 use_megakernel=False)
    out = {}
    for dev, sc in ((cuda_device, engine.scene_data),
                    (torch.device("cpu"),
                     _scene_to_cpu(engine.scene_data))):
        cam = dataclasses.replace(engine.camera, **{
            f.name: getattr(engine.camera, f.name).to(dev)
            for f in dataclasses.fields(engine.camera)})
        state = FrameState(exposure=init_exposure_state(dev), frame_idx=3)
        cuda.reset_launch_counts()
        _, _, g = render_frame(static, sc, state, cam, cam, default_params(),
                               1 / 60)
        out[dev.type] = (g, dict(cuda.launch_counts))
    (a, counts), (b, _) = out["cuda"], out["cpu"]
    assert counts["packet_intersect"] == 5 and counts["megakernel_trace"] \
        == 0, counts
    a = dataclasses.replace(a, **{f.name: getattr(a, f.name).cpu()
                                  for f in dataclasses.fields(a)})
    for f in ("color", "albedo", "normal", "motion"):
        assert torch.isfinite(getattr(a, f)).all(), f
    assert (a.mat_id == b.mat_id).float().mean() >= 0.99
    same_d = torch.isclose(a.depth, b.depth, rtol=1e-4, atol=0) | (
        torch.isinf(a.depth) & torch.isinf(b.depth))
    assert same_d.float().mean() >= 0.99
    ma, mb = a.color.mean((0, 1)), b.color.mean((0, 1))
    assert ((ma - mb).abs() <= 0.01 * mb.abs()).all(), (ma, mb)
