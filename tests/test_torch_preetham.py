"""The Preetham daylight sky: port == JAX, and both == the published
formulas.

  * the port's skyref.py is the JAX module's numpy twin: the same values;
  * preetham_radiance against JAX's on the bake grid's directions (jitted
    on the CPU, as the JAX bake runs it): rtol 1e-4 (float32 exp / arccos /
    tan chains that the two libraries round alike to a few ulps; the XLA
    program may contract products into FMAs);
  * preetham_radiance against the port's own float64 skyref.sky_rgb at the
    bounds of tests/test_sky_parity.py: the luminance ratio's spread below
    1e-3 of its mean (the one calibration constant apart) and every
    channel correlated above 0.999;
  * bake_sky_maps(model="preetham") and the env fit against JAX's at the
    bounds tests/test_torch_sky.py holds the physical model to (rtol 1e-4
    on the sky map, the host fit within rtol 1e-4 of its largest
    coefficient, the fit's evaluation within rtol 1e-4 + atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rtrt_tpu.render import sky as JS
from rtrt_tpu.render import skyref as JR
from rtrt_tpu_torch.render import sky as TS
from rtrt_tpu_torch.render import skyref as TR
from rtrt_tpu_torch.utils.interop import sky_from_jax

torch.set_num_threads(1)
RTOL = 1e-4
LUMA = np.array([0.2126, 0.7152, 0.0722])


def _params():
    kw = dict(sun_elevation=0.6, sun_azimuth=0.3)
    return JS.make_sky_params(**kw), TS.make_sky_params(**kw, device="cpu")


def _grid(h=16, w=32):
    vv, uu = np.meshgrid((np.arange(h, dtype=np.float32) + 0.5) / h,
                         (np.arange(w, dtype=np.float32) + 0.5) / w,
                         indexing="ij")
    uv = np.stack([uu, vv], -1)
    return np.array(JS.equal_area_uv_to_dir(jnp.asarray(uv))).reshape(-1, 3)


def test_skyref_is_the_jax_twin():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = np.array([0.3, 0.6, 0.74])
    for f in ("sky_rgb", "sky_luminance"):
        np.testing.assert_array_equal(getattr(TR, f)(d, sun, 2.5),
                                      getattr(JR, f)(d, sun, 2.5), f)
    for name in ("_PEREZ_X", "_PEREZ_Y", "_ZENITH_X", "_ZENITH_Y"):
        assert getattr(TR, name) == getattr(JR, name)
    assert TS.PREETHAM_LUM_SCALE == JS.PREETHAM_LUM_SCALE


def test_preetham_radiance_matches_jax_and_formulas():
    jp, tp = _params()
    dirs = _grid()
    ref = np.asarray(jax.jit(JS.preetham_radiance)(jnp.asarray(dirs), jp))
    got = TS.preetham_radiance(torch.from_numpy(dirs), tp).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)
    up = dirs[:, 1] > 0.0
    assert 0 < up.sum() < dirs.shape[0]  # both hemispheres (ground tint)

    published = TR.sky_rgb(dirs[up], tp.sun_dir.numpy(), 2.5)
    lo, lr = got[up] @ LUMA, published @ LUMA
    ratio = lo / np.maximum(lr, 1e-9)
    assert ratio.std() / ratio.mean() < 1e-3
    for c in range(3):
        assert np.corrcoef(got[up][:, c], published[:, c])[0, 1] > 0.999


def test_preetham_bake_and_fit_match_jax():
    jp, tp = _params()
    jm = JS.finalize_sky_maps(jax.jit(lambda p: JS.bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4), model="preetham"))(jp))
    tm = TS.finalize_sky_maps(TS.bake_sky_maps(tp, sky_res=(16, 32),
                                               sun_res=(4, 4),
                                               model="preetham"))
    a, b = np.asarray(jm.sky_map), tm.sky_map.numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-7)
    # the maps differ from the physical model's
    phys = TS.bake_sky_maps(tp, sky_res=(16, 32), sun_res=(4, 4))
    assert not np.allclose(phys.sky_map.numpy(), b, rtol=0.1)
    for f in ("sun_map", "sun_trans"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=RTOL,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(
        TS._fit_env_host(b, tm.sun_dir.numpy()),
        JS._fit_env_host(a, np.asarray(jm.sun_dir)), rtol=RTOL,
        atol=RTOL * np.abs(np.asarray(jm.env_fit)).max())
    rng = np.random.default_rng(7)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(JS.env_radiance_fit(jm, jnp.asarray(d)))
    got = TS.env_radiance_fit(sky_from_jax(jm, "cpu"),
                              torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)
