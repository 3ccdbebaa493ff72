"""The denoiser of the port (rtrt_tpu_torch.denoise, with the plain versions
of K4 and K5) against the JAX package's, on the same numpy inputs.

Inputs are 36x52 (not a multiple of 8 or 16, so the tile maps truncate and
edge-pad), with a sky region (inf depth), material changes and smooth
normals.  Tolerances:
  * colour transforms and stencils: exact (the same float32 operations,
    or pure index moves);
  * K4's plain version vs _edge_aware_pass: rtol 2e-5, atol 2e-5, the JAX
    suite's own bound for its Pallas twin (test_denoise_post.py).  pow
    (sigma_n = 64) and exp are separate library implementations in XLA and
    torch; a last-bit difference of a weight moves the result by ~1e-7;
  * the spatial filters with their noise gate, the tile noise and the
    temporal filter: rtol 1e-5, atol 1e-6 (sums of 64 or 9 values in
    another order, and the same pow / exp differences);
  * K5's plain version vs reproject_gather: colour rtol 1e-5, atol 1e-6
    (the same float32 operations); depth, count, material and ok exactly
    equal, including at exact half-pixel motion (both round half to even);
  * the denoise() chain over 3 frames with bfloat16 history: colour rtol
    1e-4 (the differences above, carried through two filters and the
    history); the stored bfloat16 history equal on >= 99.9% of entries and
    within 1 bf16 ulp elsewhere (a float32 value within 1e-7 of a bf16
    rounding boundary may round either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.core import color as JC
from rtrt_tpu.denoise import pipeline as JP
from rtrt_tpu.denoise import reproject as JR
from rtrt_tpu.denoise import spatial as JS
from rtrt_tpu.denoise import temporal as JT
from rtrt_tpu.ops import stencil as JST
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.core import color as TC
from rtrt_tpu_torch.denoise import pipeline as TP
from rtrt_tpu_torch.denoise import reproject as TR
from rtrt_tpu_torch.denoise import spatial as TS
from rtrt_tpu_torch.denoise import temporal as TT
from rtrt_tpu_torch.ops import stencil as TST
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

torch.set_num_threads(1)
H, W = 36, 52
JPD, TPD = jparams().denoise, tparams().denoise


def _gbuf(seed, h=H, w=W):
    """A G-buffer-like set of numpy planes: a sky band (inf depth, mat -1),
    three material regions, smooth normals with noise, lognormal colour."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    mat = np.where(xx < w // 3, 1, np.where(yy > 2 * h // 3, 4, 0))
    depth = 3.0 + 0.2 * yy + 0.05 * xx + rng.uniform(0, 0.05, (h, w))
    sky = (yy < h // 5) & (xx > w // 4)
    depth = np.where(sky, np.inf, depth)
    mat = np.where(sky, -1, mat).astype(np.int32)
    base = np.stack([0.2 * np.sin(xx / 7.0), np.ones((h, w)),
                     0.3 * (mat == 4)], -1)
    n = base + 0.05 * rng.normal(size=(h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    color = rng.lognormal(-0.5, 0.8, (h, w, 3))
    albedo = rng.uniform(0.2, 0.9, (h, w, 3))
    f = lambda a: np.ascontiguousarray(a, np.float32)
    return dict(color=f(color), albedo=f(albedo), normal=f(n),
                depth=f(depth), mat=mat)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _motion(kind, seed, h=H, w=W):
    """(H,W,2) uv motion of a given kind (pixels -> uv)."""
    rng = np.random.default_rng(seed)
    if kind == "subpixel":
        px = rng.uniform(-1, 1, (h, w, 2))
    elif kind == "multipixel":
        px = rng.uniform(-30, 30, (h, w, 2))
    elif kind == "halfpixel":
        px = rng.integers(-5, 5, (h, w, 2)) + 0.5
    else:  # "outside": out of the image on every side for a share
        px = rng.uniform(-0.6, 0.6, (h, w, 2)) * np.array([w, h])
    return np.ascontiguousarray(px / np.array([w, h]), np.float32)


def _bf16(a):
    """numpy float32 -> bfloat16-representable float32 (round to nearest
    even) and the bf16 tensor itself."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)
    return t.to(torch.float32).numpy(), t


# ---------------------------------------------------------------------------
# colour, stencils
# ---------------------------------------------------------------------------


def test_ycocg_roundtrip_matches_jax():
    c = _gbuf(1)["color"]
    y_j = np.asarray(JC.rgb_to_ycocg(jnp.asarray(c)))
    y_t = TC.rgb_to_ycocg(torch.from_numpy(c))
    np.testing.assert_array_equal(y_j, y_t.numpy())
    np.testing.assert_array_equal(np.asarray(JC.ycocg_to_rgb(jnp.asarray(y_j))),
                                  TC.ycocg_to_rgb(y_t).numpy())


@pytest.mark.parametrize("dy,dx", [(2, -3), (-7, 0), (0, 12), (40, -60)])
def test_shifted_matches_jax(dy, dx):
    g = _gbuf(2)
    for k in ("color", "depth", "mat"):
        np.testing.assert_array_equal(
            np.asarray(JST.shifted(jnp.asarray(g[k]), dy, dx)),
            TST.shifted(torch.from_numpy(g[k]), dy, dx).numpy())


@pytest.mark.parametrize("radius,stride", [(1, 1), (2, 3)])
def test_neighborhood_matches_jax(radius, stride):
    c = _gbuf(3)["color"]
    jt, jo = JST.neighborhood(jnp.asarray(c), radius, stride)
    tt, to = TST.neighborhood(torch.from_numpy(c), radius, stride)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_gaussian_weights_match_jax(radius):
    np.testing.assert_array_equal(np.asarray(JST.gaussian_weights(radius)),
                                  TST.gaussian_weights(radius, "cpu").numpy())


# ---------------------------------------------------------------------------
# K4 plain version, spatial filters, tile noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius,stride,half,parity", [
    (2, 3, False, 0), (2, 6, False, 0), (2, 12, False, 0),
    (3, 1, True, 0), (3, 1, True, 1)])
def test_edge_aware_pass_matches_jax(radius, stride, half, parity):
    g = _gbuf(4)
    j, t = _j(g), _t(g)
    ref = JS._edge_aware_pass(j["color"], j["normal"], j["depth"], j["mat"],
                              JPD, radius=radius, stride=stride,
                              half_taps=half, parity=parity)
    got = TS.edge_aware_pass(t["color"], t["normal"], t["depth"], t["mat"],
                             TPD, radius=radius, stride=stride,
                             half_taps=half, parity=parity)
    assert not np.allclose(np.asarray(ref), g["color"])  # it does filter
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_tile_noise_matches_jax():
    g = _gbuf(5)
    j, t = _j(g), _t(g)
    n8_j = JT.tile_noise_level(j["color"], j["depth"], 8)
    n8_t = TT.tile_noise_level(t["color"], t["depth"], 8)
    assert n8_t.shape == (H // 8, W // 8)
    np.testing.assert_allclose(n8_t.numpy(), np.asarray(n8_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(TT.tile_noise_downsample(n8_t).numpy(),
                               np.asarray(JT.tile_noise_downsample(n8_j)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["7x7-0", "7x7-1", "wide-3", "wide-6",
                                   "wide-12"])
def test_spatial_filters_match_jax(which):
    g = _gbuf(6)
    j, t = _j(g), _t(g)
    rng = np.random.default_rng(6)
    kind, arg = which.split("-")
    if kind == "7x7":
        # tile noise around the gate threshold (0.001): partly gated
        noise = rng.uniform(0, 0.002, (H // 8, W // 8)).astype(np.float32)
        ref = JS.spatial_filter_7x7(j["color"], j["normal"], j["depth"],
                                    j["mat"], jnp.asarray(noise), JPD,
                                    frame_parity=int(arg))
        got = TS.spatial_filter_7x7(t["color"], t["normal"], t["depth"],
                                    t["mat"], torch.from_numpy(noise), TPD,
                                    frame_parity=int(arg))
    else:
        noise = rng.uniform(0, 0.002, (H // 16, W // 16)).astype(np.float32)
        ref = JS.spatial_filter_wide(j["color"], j["normal"], j["depth"],
                                     j["mat"], jnp.asarray(noise), JPD,
                                     int(arg))
        got = TS.spatial_filter_wide(t["color"], t["normal"], t["depth"],
                                     t["mat"], torch.from_numpy(noise), TPD,
                                     int(arg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# K5 plain version, temporal filter
# ---------------------------------------------------------------------------


def _history(seed):
    g = _gbuf(seed)
    c1, c1_t = _bf16(g["color"])
    c2, c2_t = _bf16(g["color"] * g["albedo"])
    d, d_t = _bf16(g["depth"])
    rng = np.random.default_rng(seed)
    n, n_t = _bf16(rng.integers(0, 9, (H, W)).astype(np.float32))
    jh = dict(color=c1, color2=c2, depth=d, count=n, mat=g["mat"])
    th = dict(color=c1_t, color2=c2_t, depth=d_t, count=n_t,
              mat=torch.from_numpy(g["mat"]))
    return jh, th


@pytest.mark.parametrize("kind", ["subpixel", "multipixel", "halfpixel",
                                  "outside"])
def test_reproject_matches_jax_gather(kind):
    jh, th = _history(7)
    mv = _motion(kind, 7)
    if kind == "halfpixel":  # the case where round-half-even matters
        yh = np.arange(H)[:, None] + mv[..., 1] * np.float32(H)
        assert (yh - np.floor(yh) == 0.5).mean() > 0.5
    ref = JR.reproject_gather(*(jnp.asarray(jh[k]) for k in (
        "color", "color2", "depth", "mat", "count")), jnp.asarray(mv))
    got = TR.reproject(th["color"], th["color2"], th["depth"], th["mat"],
                       th["count"], torch.from_numpy(mv))
    if kind == "outside":
        assert 0.2 < got.ok.float().mean() < 0.9
    for f in ("color", "color2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    for f in ("depth", "mat_id", "count", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.mat_id.dtype == torch.int32 and got.ok.dtype == torch.bool


@pytest.mark.parametrize("valid", [True, False])
def test_temporal_filter_matches_jax(valid):
    g = _gbuf(8)
    j, t = _j(g), _t(g)
    jh, th = _history(9)
    mv = _motion("subpixel", 8)
    rep = JR.reproject_gather(*(jnp.asarray(jh[k]) for k in (
        "color", "color2", "depth", "mat", "count")), jnp.asarray(mv))
    reproj = (rep.color, rep.depth, rep.mat_id, rep.count, rep.ok)
    ref, ref_n = JT.temporal_filter(
        j["color"], j["normal"], j["depth"], j["mat"], jnp.asarray(mv),
        jnp.asarray(jh["color"]), jnp.asarray(jh["depth"]),
        jnp.asarray(jh["mat"]), jnp.asarray(valid), JPD,
        hist_count=jnp.asarray(jh["count"]), reproj=reproj)
    treproj = tuple(torch.from_numpy(np.array(a)) for a in reproj)
    got, got_n = TT.temporal_filter(t["color"], t["normal"], t["depth"],
                                    t["mat"], torch.from_numpy(mv), valid,
                                    TPD, treproj)
    if valid:  # some history is taken and some rejected
        assert 0.05 < (np.asarray(ref_n) > 1).mean() < 0.95
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))


# ---------------------------------------------------------------------------
# the chain over 3 frames
# ---------------------------------------------------------------------------


def _bf16_ulp_diff(a, b):
    """|a - b| in bf16 ulps of two bf16-representable float32 arrays
    (finite entries; non-finite ones must be equal)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(a[~fa], b[~fb])
    ia = a[fa].view(np.int32).astype(np.int64) >> 16
    ib = b[fb].view(np.int32).astype(np.int64) >> 16
    return np.abs(ia - ib)


def test_denoise_chain_three_frames_matches_jax():
    jflags, tflags = JFlags(), TFlags()
    jhist = JP.init_history(H, W, half=True)
    thist = TP.init_history(H, W, half=True, device="cpu")
    for frame in range(3):
        g = _gbuf(20 + frame)
        # the scene as seen a little later: sub- and multi-pixel motion
        mv = _motion("subpixel", 30 + frame) * 0.5 + np.float32(
            [2.0 / W, -1.0 / H]) * frame
        mv = np.ascontiguousarray(mv, np.float32)
        j, t = _j(g), _t(g)
        ref, jhist = JP.denoise(j["color"], j["albedo"], j["normal"],
                                j["depth"], j["mat"], jnp.asarray(mv), jhist,
                                JPD, jflags, frame_parity=frame & 1,
                                reproject_mode="gather")
        got, thist = TP.denoise(t["color"], t["albedo"], t["normal"],
                                t["depth"], t["mat"], torch.from_numpy(mv),
                                thist, TPD, tflags, frame_parity=frame & 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6, err_msg=f"frame {frame}")
        assert thist.valid and thist.color.dtype == torch.bfloat16
        for f in ("color", "color2", "depth", "count"):
            a = np.asarray(getattr(jhist, f).astype(jnp.float32))
            b = getattr(thist, f).to(torch.float32).numpy()
            ulps = _bf16_ulp_diff(a, b)
            assert (ulps == 0).mean() >= 0.999, (frame, f)
            assert ulps.max() <= 1, (frame, f)
        np.testing.assert_array_equal(np.asarray(jhist.mat_id),
                                      thist.mat_id.numpy())
    # the history is taken: the count grows past 1 on most pixels
    assert (thist.count.float() > 1).float().mean() > 0.5


def test_entry_points_default_to_the_card():
    """make_camera, init_exposure_state, make_sky_params and init_history
    ask for "cuda" unless told otherwise (here, without a card, they
    raise)."""
    import inspect

    from rtrt_tpu_torch.core.camera import make_camera
    from rtrt_tpu_torch.post.exposure import init_exposure_state
    from rtrt_tpu_torch.render.sky import make_sky_params

    calls = ((make_camera, ()), (init_exposure_state, ()),
             (make_sky_params, ()), (TP.init_history, (4, 4)))
    for fn, args in calls:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                fn(*args)
