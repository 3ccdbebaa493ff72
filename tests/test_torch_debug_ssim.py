"""The port's small modules against their JAX namesakes on the same numpy
inputs: utils/debug.py (nan_guard, safe_gather, center_pixel_print,
dump_csv, dump_bvh_intermediates, frame_dump), utils/ssim.py, the
parameter registry of utils/config.py, and tools/quality.py's `measure`
on the CPU at a tiny size.

Tolerances: the debug helpers' outputs and files exactly equal (selects,
clamped gathers, the same savetxt format); ssim within 1e-9 of the JAX
module's numpy ssim (both float64; the Gaussian window summed by a
convolution in another order, ~1e-16 apart); the registry equal entry for
entry.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.utils import config as JC
from rtrt_tpu.utils import debug as JD
from rtrt_tpu.utils.ssim import ssim as jssim
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah
from rtrt_tpu_torch.engine.scene import build_demo_scene as tdemo
from rtrt_tpu_torch.engine.scene import padded_arrays as tpadded
from rtrt_tpu_torch.tools import quality
from rtrt_tpu_torch.utils import config as TC
from rtrt_tpu_torch.utils import debug as TD
from rtrt_tpu_torch.utils.image import read_png, read_ppm
from rtrt_tpu_torch.utils.ssim import ssim

torch.set_num_threads(1)


def _with_bad_values(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(12, 20, 3)).astype(np.float32)
    x[1, 2, 0] = np.nan
    x[5, 7] = np.inf
    x[9, 19, 2] = -np.inf
    return x


# ---------------------------------------------------------------------------
# utils/debug.py
# ---------------------------------------------------------------------------


def test_nan_guard_matches_jax(capsys):
    x = _with_bad_values(1)
    ref = np.asarray(JD.nan_guard(jnp.asarray(x), "t", enabled=True))
    capsys.readouterr()
    got = TD.nan_guard(torch.from_numpy(x), "trace.radiance", enabled=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isfinite(ref).all()
    assert capsys.readouterr().out == \
        "[nan_guard:trace.radiance] bad values: 5\n"


def test_nan_guard_off_is_identity(capsys, monkeypatch):
    t = torch.from_numpy(_with_bad_values(2))
    assert TD.nan_guard(t, "x", enabled=False) is t
    monkeypatch.setattr(TD, "DEBUG", False)
    assert TD.nan_guard(t, "x") is t
    monkeypatch.setattr(TD, "DEBUG", True)  # the RTRT_DEBUG=1 default
    assert torch.isfinite(TD.nan_guard(t, "x")).all()
    assert capsys.readouterr().out == "[nan_guard:x] bad values: 5\n"


def test_safe_gather_matches_jax(capsys):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(17, 4)).astype(np.float32)
    idx = np.array([-5, -1, 0, 3, 16, 17, 40], np.int32)
    ref = np.asarray(JD.safe_gather(jnp.asarray(table), jnp.asarray(idx),
                                    enabled=False))
    got = TD.safe_gather(torch.from_numpy(table), torch.from_numpy(idx),
                         "leaf", enabled=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(),
                                  table[np.clip(idx, 0, 16)])
    assert capsys.readouterr().out == "[safe_gather:leaf] oob indices: 4\n"


def test_center_pixel_print(capsys):
    img = torch.arange(5 * 6 * 3, dtype=torch.float32).reshape(5, 6, 3)
    TD.center_pixel_print(img, "c")
    assert capsys.readouterr().out == "[center:c] [45. 46. 47.]\n"


@pytest.mark.parametrize("fmt,dtype", [("%.7g", np.float32), ("%d",
                                                               np.int32)])
def test_dump_csv_round_trips_as_jax(tmp_path, fmt, dtype):
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(6, 2, 3)) * 100).astype(dtype)
    JD.dump_csv(str(tmp_path / "j.csv"), jnp.asarray(a), fmt=fmt)
    TD.dump_csv(str(tmp_path / "t.csv"), torch.from_numpy(a), fmt=fmt)
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    back = np.loadtxt(tmp_path / "t.csv", delimiter=",", dtype=dtype)
    # %.7g keeps 7 significant digits: half a unit of the 7th, 5e-7
    np.testing.assert_allclose(back.reshape(a.shape), a,
                               rtol=5e-7 if fmt == "%.7g" else 0)


def test_dump_bvh_intermediates_match_jax(tmp_path):
    """The demo scene's flat SAH tree (bit-equal in both packages) dumps to
    the same four CSV files."""
    host = build_demo_scene()
    pad = padded_arrays(host)
    jbvh = jbuild(host.num_batches, pad["indices"], pad["tri_mat"],
                  pad["valid"], host.vertices, host.normals, leaf_max=8)[0]
    th = tdemo()
    tpad = tpadded(th)
    tbvh = build_scene_tables_sah(th.num_batches, tpad["indices"],
                                  tpad["tri_mat"], tpad["valid"],
                                  th.vertices, th.normals, leaf_max=8)[0]
    JD.dump_bvh_intermediates(str(tmp_path / "j"), jbvh)
    TD.dump_bvh_intermediates(str(tmp_path / "t"), tbvh)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == ["boxes_t.csv", "children_t.csv", "root_aabb.csv",
                     "sorted_tri_index.csv"]
    assert names == sorted(os.listdir(tmp_path / "j"))
    for n in names:
        assert (tmp_path / "t" / n).read_text() == \
            (tmp_path / "j" / n).read_text(), n


def test_frame_dump_png_and_ppm(tmp_path):
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 256, (7, 9, 3), dtype=np.uint8))
    TD.frame_dump(str(tmp_path / "f.png"), img)
    TD.frame_dump(str(tmp_path / "f.ppm"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")),
                                  img.numpy())
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "f.ppm")),
                                  img.numpy())


# ---------------------------------------------------------------------------
# utils/ssim.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data_range", [255.0, 1.0])
@pytest.mark.parametrize("shape", [(40, 60, 3), (30, 25)])
def test_ssim_matches_jax(data_range, shape):
    rng = np.random.default_rng(len(shape) + int(data_range))
    a = rng.uniform(0, 1, shape)
    b = np.clip(a + rng.normal(0, 0.15, shape), 0, 1)
    if data_range == 255.0:
        a, b = np.round(a * 255.0), np.round(b * 255.0)
    ref = jssim(a, b, data_range=data_range)
    assert 0.05 < ref < 0.99
    assert abs(ssim(a, b, data_range) - ref) <= 1e-9
    # tensors, and a float32 tensor beside a numpy array
    for x, y in ((torch.from_numpy(a), torch.from_numpy(b)),
                 (torch.from_numpy(a).float(), b)):
        want = jssim(np.asarray(x, np.float64), np.asarray(y), data_range)
        assert abs(ssim(x, y, data_range=data_range) - want) <= 1e-9
    assert ssim(a, a, data_range) == pytest.approx(1.0, abs=1e-12)


def test_ssim_range_guard():
    rng = np.random.default_rng(7)
    a, b = rng.uniform(0, 1, (2, 20, 20, 3))
    with pytest.raises(AssertionError):
        jssim(a, b, data_range=255.0)
    with pytest.raises(ValueError, match="data_range=1.0"):
        ssim(a, b, data_range=255.0)
    with pytest.raises(ValueError, match="shapes"):
        ssim(a, b[:10], data_range=1.0)


# ---------------------------------------------------------------------------
# the parameter registry, the quality tool
# ---------------------------------------------------------------------------


def test_param_registry_matches_jax():
    assert len(TC.PARAM_REGISTRY) == 19
    assert TC.PARAM_REGISTRY == JC.PARAM_REGISTRY
    params = TC.default_params()
    for path, _label, _widget, lo, hi, _log in TC.PARAM_REGISTRY:
        assert lo <= TC.get_param(params, path) <= hi, path
        moved = TC.set_param(params, path, hi)
        assert TC.get_param(moved, path) == hi


def test_quality_measure_on_the_cpu(tmp_path, capsys):
    r = quality.measure(32, 16, spp=2, frames=3, scene="demo",
                        device="cpu", log=print)
    assert [f for f, _ in r["trajectory"]] == [1, 2, 3]
    for value in [r["ceiling"]] + [s for _, s in r["trajectory"]]:
        assert 0.0 < value <= 1.0
    assert r["final"] == r["trajectory"][-1][1]
    assert r["image"].shape == (16, 32, 3)
    assert r["image"].dtype == torch.uint8
    out = capsys.readouterr().out
    assert out.startswith("ceiling: SSIM(1-spp A, 1-spp B)")
    assert "frame   3: SSIM vs 2-spp converged" in out
    if not torch.cuda.is_available():  # no device number without a card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            quality.main(["--width", "32", "--height", "16", "--spp", "2",
                          "--frames", "1", "--scene", "demo"])
