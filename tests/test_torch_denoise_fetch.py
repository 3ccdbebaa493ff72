"""The denoiser's other history fetches in the port against the JAX
package's, on the same numpy inputs: `temporal_filter` without a
reprojection (the ±1 px shift stencil, and the bicubic gather), its
luma-weighted EMA branch (hist_count=None), `denoise` with
reproject_mode="stencil" and with FeatureFlags(temporal_filter=False), K5's
plain version under the bilinear history filter (JAX's reproject_gather
with its module's HISTORY_FILTER set to "bilinear" by monkeypatch), and
the tile-noise overlay.

Inputs are the 36x52 G-buffers of tests/test_torch_denoise.py.  Tolerances:
  * temporal_filter: rtol 1e-5, atol 1e-6 and the counts exactly equal, as
    test_temporal_filter_matches_jax (9 weighted shifted copies or 16
    bicubic taps summed in JAX's order, the clamp's 9 taps reduced in
    another);
  * reproject_plain bilinear: colour rtol 1e-5, atol 1e-6; depth, count,
    material and ok exactly equal;
  * the denoise() chain over 3 frames with bfloat16 history: the bounds of
    test_denoise_chain_three_frames_matches_jax (colour rtol 1e-4; the
    stored history equal on >= 99.9% of entries, within 1 bf16 ulp
    elsewhere);
  * noise_level_visualize: exactly equal (selects and one multiply-add).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.denoise import pipeline as JP
from rtrt_tpu.denoise import reproject as JR
from rtrt_tpu.denoise import temporal as JT
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.denoise import pipeline as TP
from rtrt_tpu_torch.denoise import reproject as TR
from rtrt_tpu_torch.denoise import temporal as TT
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams
from test_torch_denoise import (H, W, _bf16_ulp_diff, _gbuf, _history, _j,
                                _motion, _t)

torch.set_num_threads(1)
JPD, TPD = jparams().denoise, tparams().denoise


def _fetch_motion(kind, seed):
    """(H,W,2) uv motion for the stencil fetch: "inside" within ±1 px on
    both axes, "beyond" up to ±3 px (a share rejected), "edge" on the
    half-pixel rounding edges (±0.5, ±1.5 px exactly, in float32)."""
    rng = np.random.default_rng(seed)
    if kind == "inside":
        px = rng.uniform(-1, 1, (H, W, 2))
    elif kind == "beyond":
        px = rng.uniform(-3, 3, (H, W, 2))
    else:
        px = rng.choice([-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5], (H, W, 2))
    return np.ascontiguousarray(px / np.array([W, H]), np.float32)


def _filter_both(kind, counted, bicubic, seed=40):
    g = _gbuf(seed)
    j, t = _j(g), _t(g)
    jh, _ = _history(seed + 1)
    mv = (_motion("multipixel", seed) if bicubic
          else _fetch_motion(kind, seed))
    ref = JT.temporal_filter(
        j["color"], j["normal"], j["depth"], j["mat"], jnp.asarray(mv),
        jnp.asarray(jh["color"]), jnp.asarray(jh["depth"]),
        jnp.asarray(jh["mat"]), jnp.asarray(True), JPD, bicubic=bicubic,
        hist_count=jnp.asarray(jh["count"]) if counted else None)
    th = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jh.items()}
    got = TT.temporal_filter(
        t["color"], t["normal"], t["depth"], t["mat"], torch.from_numpy(mv),
        True, TPD, hist_color=th["color"], hist_depth=th["depth"],
        hist_mat=th["mat"], bicubic=bicubic,
        hist_count=th["count"] if counted else None)
    return mv, ref, got


@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("kind", ["inside", "beyond", "edge"])
def test_stencil_fetch_matches_jax(kind, counted):
    mv, ref, got = _filter_both(kind, counted, bicubic=False)
    if kind == "edge":  # the case where round-half-even picks the shift
        assert (np.abs(mv[..., 0] * np.float32(W)) % 1 == 0.5).mean() > 0.2
    if counted:
        (ref, ref_n), (got, got_n) = ref, got
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
        taken = (np.asarray(ref_n) > 1).mean()
        if kind == "beyond":  # motion beyond one pixel rejects history
            assert 0.05 < taken < 0.5, taken
        else:
            assert taken > 0.3, taken
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("counted", [True, False])
def test_bicubic_fetch_matches_jax(counted):
    _, ref, got = _filter_both(None, counted, bicubic=True)
    if counted:
        (ref, ref_n), (got, got_n) = ref, got
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["subpixel", "multipixel", "halfpixel",
                                  "outside"])
def test_reproject_bilinear_matches_jax_gather(kind, monkeypatch):
    monkeypatch.setattr(JR, "HISTORY_FILTER", "bilinear")
    jh, th = _history(42)
    mv = _motion(kind, 42)
    ref = JR.reproject_gather(*(jnp.asarray(jh[k]) for k in (
        "color", "color2", "depth", "mat", "count")), jnp.asarray(mv))
    args = (th["color"], th["color2"], th["depth"], th["mat"], th["count"],
            torch.from_numpy(mv))
    got = TR.reproject(*args, history_filter="bilinear")
    # the module default follows RTRT_HISTORY_FILTER the same way
    monkeypatch.setattr(TR, "HISTORY_FILTER", "bilinear")
    again = TR.reproject(*args)
    cr = TR.reproject(*args, history_filter="catmull_rom")
    for f in ("color", "color2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
        assert torch.equal(getattr(again, f), getattr(got, f))
        assert not torch.allclose(getattr(cr, f), getattr(got, f))
    for f in ("depth", "mat_id", "count", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_unknown_filter_and_mode_raise():
    _, th = _history(43)
    mv = torch.from_numpy(_motion("subpixel", 43))
    with pytest.raises(ValueError, match="history filter"):
        TR.reproject(th["color"], th["color2"], th["depth"], th["mat"],
                     th["count"], mv, history_filter="lanczos")
    g = _t(_gbuf(43))
    hist = TP.init_history(H, W, device="cpu")
    with pytest.raises(ValueError, match="reproject_mode"):
        TP.denoise(g["color"], g["albedo"], g["normal"], g["depth"],
                   g["mat"], mv, hist, TPD, TFlags(),
                   reproject_mode="tile_shift")


@pytest.mark.parametrize("case", ["stencil", "no_temporal_filter"])
def test_denoise_chain_other_fetches_match_jax(case):
    """Three frames of the chain: reproject_mode="stencil" (both temporal
    passes through the shift stencil), and FeatureFlags(
    temporal_filter=False) with the default second pass, which JAX runs
    through the stencil."""
    mode = "stencil" if case == "stencil" else "gather"
    jflags = JFlags() if case == "stencil" else JFlags(temporal_filter=False)
    tflags = TFlags() if case == "stencil" else TFlags(temporal_filter=False)
    jhist = JP.init_history(H, W, half=True)
    thist = TP.init_history(H, W, half=True, device="cpu")
    for frame in range(3):
        g = _gbuf(50 + frame)
        # mostly within the stencil's ±1 px, some beyond it
        mv = _motion("subpixel", 60 + frame) * 0.6 + np.float32(
            [0.3 / W, -0.2 / H]) * frame
        mv = np.ascontiguousarray(mv, np.float32)
        j, t = _j(g), _t(g)
        ref, jhist = JP.denoise(j["color"], j["albedo"], j["normal"],
                                j["depth"], j["mat"], jnp.asarray(mv), jhist,
                                JPD, jflags, frame_parity=frame & 1,
                                reproject_mode=mode)
        got, thist = TP.denoise(t["color"], t["albedo"], t["normal"],
                                t["depth"], t["mat"], torch.from_numpy(mv),
                                thist, TPD, tflags, frame_parity=frame & 1,
                                reproject_mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6, err_msg=f"frame {frame}")
        for f in ("color", "color2", "depth", "count"):
            a = np.asarray(getattr(jhist, f).astype(jnp.float32))
            b = getattr(thist, f).to(torch.float32).numpy()
            ulps = _bf16_ulp_diff(a, b)
            assert (ulps == 0).mean() >= 0.999, (frame, f)
            assert ulps.max() <= 1, (frame, f)
        np.testing.assert_array_equal(np.asarray(jhist.mat_id),
                                      thist.mat_id.numpy())
    counts = thist.count.float()
    if case == "stencil":  # the stencil takes history
        assert (counts > 1).float().mean() > 0.3
    else:  # no first pass: the count is not accumulated
        assert not counts.any()


@pytest.mark.parametrize("h,w", [(36, 52), (20, 20)])
def test_noise_level_visualize_matches_jax(h, w):
    """Tiles that do not cover the image (36 = 4 x 8 + 4) edge-pad."""
    rng = np.random.default_rng(h)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    noise = rng.uniform(0, 0.002, (h // 8, w // 8)).astype(np.float32)
    noise.flat[0], noise.flat[-1] = 0.0, 0.002  # a tile each side
    ref = JT.noise_level_visualize(jnp.asarray(img), jnp.asarray(noise),
                                   0.001)
    got = TT.noise_level_visualize(torch.from_numpy(img),
                                   torch.from_numpy(noise), 0.001)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < (got != torch.from_numpy(img)).any(-1).float().mean() < 1
