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
  * K3 post tail: u8 within 1 LSB everywhere and equal on >= 99.9% (a value
    within an ulp of a quantisation step may round either way).
  * K4 a-trous pass: rtol 1e-4 + atol 1e-5 on >= 99.9% of pixels and
    rtol 1e-3 + atol 1e-4 on all (the kernel rounds each product and sum as
    the plain version does; powf / expf are the same library functions,
    but the compiler may still evaluate them in another way).
  * K5 reprojection: colour rtol 1e-5 + atol 1e-6 on >= 99.99% of pixels
    (the same float32 operations in the same order); depth, count,
    material and ok exactly equal on every pixel.
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
from rtrt_tpu_torch.post.pipeline import dither_mask
from rtrt_tpu_torch.post.tail import post_tail, post_tail_plain, tail_params
from rtrt_tpu_torch.render import megakernel as M
from rtrt_tpu_torch.render.kshade import pack_materials_rows
from rtrt_tpu_torch.render.raygen import generate_rays_padded
from rtrt_tpu_torch.render.sampling import rand2_bn
from rtrt_tpu_torch.utils import cuda
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings, default_params)

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
    bn = consts.bn if use_bn else None
    pix = consts.pixel_ids
    jitter = rand2_bn(consts.bn, 3, 0)
    lens = rand2_bn(consts.bn, 3, 256)
    rays = generate_rays_padded(camera_basis(engine.camera), W, H, pix,
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
        ok = ((a - b).abs() - rtol * b.abs()).reshape(H, W, -1).amax(-1) \
            <= 5e-3
        assert ok[~miss].float().mean() >= 0.99, f
        if f.startswith("esc"):
            assert torch.equal(a[miss], b[miss]), f
    torch.testing.assert_close(got.radiance.mean((0, 1)),
                               ref.radiance.mean((0, 1)), rtol=1e-2,
                               atol=1e-4)


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
def test_engine_frames_launch_the_kernels(engine):
    cuda.reset_launch_counts()
    engine.overflow.zero_()
    for _ in range(2):
        img = engine.render_frame_device(1 / 60)
    torch.cuda.synchronize()
    assert img.shape == (H, W, 3) and img.dtype == torch.uint8
    assert cuda.launch_counts["megakernel_trace"] == 2
    assert cuda.launch_counts["post_tail"] == 2
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
    assert counts["megakernel_trace"] == 3 and counts["post_tail"] == 3
    assert counts["denoise_wide"] == 12 and counts["reproject"] == 3
    assert int(eng.overflow) == 0
    for fld in ("color", "color2", "depth", "count"):
        x = getattr(eng.state.history, fld).float()
        assert not torch.isnan(x).any(), fld
