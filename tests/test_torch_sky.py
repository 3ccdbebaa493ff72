"""Physical sky: port == JAX.  Bake at (16,32) / (4,4), the host env fit and
env_radiance_fit at rtol 1e-4: the raymarch is 32x8 float32 exp/sqrt steps
whose per-op rounding differs between XLA and torch, and the fit is an f64
lstsq whose truncated-SVD solution moves with those input ulps.

The sky map itself holds rtol 1e-4 on >= 99% of texels and 3e-4 on all:
the march computes altitude as h = sqrt(p.p) - 6.36e6 m in float32, where
one ulp of p.p (~4e13) moves h by ~0.33 m and the Mie density
exp(-h / 1200 m) by 2.7e-4 relative.  XLA's fused loops and torch's
kernels round such steps differently (the densities of single points agree
to 1e-7, the 8-step sun optical depths already only to 6e-6); the few
texels above 1e-4 are near the sun, where Mie scattering dominates.

The host-folded sun-disk constants must be EXACTLY the JAX module's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.render import light as JL
from rtrt_tpu.render import sky as JS
from rtrt_tpu.render.megakernel import pack_sun_params as jpack_sun
from rtrt_tpu_torch.render import light as TL
from rtrt_tpu_torch.render import sky as TS
from rtrt_tpu_torch.render.megakernel import pack_sun_params as tpack_sun
from rtrt_tpu_torch.utils.interop import sky_from_jax

torch.set_num_threads(1)
RTOL = 1e-4


@pytest.fixture(scope="module")
def skies():
    jp = JS.make_sky_params(sun_elevation=0.5, sun_azimuth=-0.4)
    jmaps = JS.finalize_sky_maps(jax.jit(lambda p: JS.bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(jp))
    tp = TS.make_sky_params(sun_elevation=0.5, sun_azimuth=-0.4,
                            device="cpu")
    tmaps = TS.finalize_sky_maps(TS.bake_sky_maps(tp, sky_res=(16, 32),
                                                  sun_res=(4, 4)))
    return jp, jmaps, tp, tmaps


def test_sun_constants_exact():
    assert TS.SUN_COS_THETA_MAX == JS.SUN_COS_THETA_MAX
    # kshade's folded cone pdf and light.sun_pdf_dir's f32 cone pdf
    assert np.float32(TS.SUN_DISK_PDF) == np.asarray(jnp.float32(1.0) / (
        jnp.maximum(2.0 * jnp.pi * (1.0 - JS.SUN_COS_THETA_MAX), 1e-8)))
    assert np.float32(TS.SUN_CONE_PDF) == np.asarray(
        JS.jnp.float32(1.0) / (6.283185307179586 * jnp.maximum(
            1.0 - jnp.float32(JS.SUN_COS_THETA_MAX), 1e-8)))


def test_params_and_sun_path(skies):
    jp, _, tp, _ = skies
    np.testing.assert_allclose(np.asarray(jp.sun_dir), tp.sun_dir.numpy(),
                               rtol=1e-6, atol=1e-7)
    for tod in (0.2, 0.35, 0.6):
        np.testing.assert_allclose(
            np.asarray(JS.sun_direction_from_time(jnp.float32(tod), 0.3)),
            TS.sun_direction_from_time(tod, 0.3).numpy(), atol=1e-6)


def test_bake_matches(skies):
    _, jm, _, tm = skies
    a, b = np.asarray(jm.sky_map), tm.sky_map.numpy()
    assert np.isclose(a, b, rtol=RTOL, atol=1e-7).mean() >= 0.99
    np.testing.assert_allclose(a, b, rtol=3e-4, atol=1e-7)
    for f in ("sun_map", "sun_trans", "sun_basis_t", "sun_basis_b"):
        np.testing.assert_allclose(np.asarray(getattr(jm, f)),
                                   getattr(tm, f).numpy(), rtol=RTOL,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(
        np.asarray(JS.atmosphere_radiance(
            JS.equal_area_uv_to_dir(jnp.asarray([[0.3, 0.9], [0.7, 0.2]])),
            jm.params)),
        TS.atmosphere_radiance(TS.equal_area_uv_to_dir(
            torch.tensor([[0.3, 0.9], [0.7, 0.2]])), tm.params).numpy(),
        rtol=RTOL)


def test_env_fit_and_eval_match(skies):
    _, jm, _, tm = skies
    # the port's fit of the port's bake vs JAX's fit of JAX's bake
    np.testing.assert_allclose(
        JS._fit_env_host(np.asarray(jm.sky_map), np.asarray(jm.sun_dir)),
        TS._fit_env_host(tm.sky_map.numpy(), tm.sun_dir.numpy()),
        rtol=RTOL, atol=RTOL * np.abs(np.asarray(jm.env_fit)).max())
    rng = np.random.default_rng(5)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8] = np.asarray(jm.sun_dir)  # sun-disk lanes
    # evaluation of one fit (carried over) on both sides
    carried = sky_from_jax(jm)
    ref = np.asarray(JS.env_radiance_fit(jm, jnp.asarray(d)))
    got = TS.env_radiance_fit(carried, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(ref, got, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(JL.sun_pdf_dir(jm, jnp.asarray(d))),
        TL.sun_pdf_dir(carried, torch.from_numpy(d)).numpy(), rtol=0)
    np.testing.assert_array_equal(np.asarray(jpack_sun(jm)),
                                  tpack_sun(carried).numpy())
