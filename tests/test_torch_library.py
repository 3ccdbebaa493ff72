"""The library functions the port gained to match the JAX package's names:
each against its JAX counterpart on the same numpy inputs (a seed), the
JAX function run op by op on the CPU.

Bound: rtol 1e-6 (atol 1e-7 for values near 0) on floats, equality on
integers and on the sampler's bits.  A matrix-vector product sums in
another order in XLA's dot and torch's einsum, so where its terms cancel
the result holds rtol 1e-6 of the sum of the terms' magnitudes (the
rounding of a 3- or 4-term sum in any order), not of the sum.  Where a transcendental enters, its
bound is stated: the sRGB transfer functions' pow and the axis-angle
sin / cos are within an ulp or two of float32 in either library (rtol
1e-6 holds); env_radiance_analytic is the atmosphere's raymarch, 32x8
float32 exp / sqrt steps whose altitude sqrt(p.p) - 6.36e6 m amplifies an
ulp of p.p to 2.7e-4 of the Mie density, so it takes the sky map's bound
of tests/test_torch_sky.py, rtol 3e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.core import camera as JC
from rtrt_tpu.core import color as Jcol
from rtrt_tpu.core import vecmath as JV
from rtrt_tpu.post import sharpen as JSh
from rtrt_tpu.render import raygen as JR
from rtrt_tpu.render import sampling as JSa
from rtrt_tpu.render import sky as JSk
from rtrt_tpu_torch.core import camera as TC
from rtrt_tpu_torch.core import color as Tcol
from rtrt_tpu_torch.core import vecmath as TV
from rtrt_tpu_torch.post import sharpen as TSh
from rtrt_tpu_torch.render import raygen as TR
from rtrt_tpu_torch.render import sampling as TSa
from rtrt_tpu_torch.render import sky as TSk
from rtrt_tpu_torch.utils import interop

RNG = np.random.default_rng(1405)
V = RNG.normal(size=(64, 3)).astype(np.float32)
V2 = RNG.normal(size=(64, 3)).astype(np.float32)
UNIT = (V2 / np.linalg.norm(V2, axis=-1, keepdims=True)).astype(np.float32)
ANG = RNG.uniform(-3.0, 3.0, 64).astype(np.float32)
M3 = RNG.normal(size=(64, 3, 3)).astype(np.float32)
M4 = RNG.normal(size=(64, 4, 4)).astype(np.float32)
COL = RNG.uniform(-0.1, 1.3, (32, 32, 3)).astype(np.float32)
Q1 = RNG.normal(size=(64, 4)).astype(np.float32)
Q2 = RNG.normal(size=(64, 4)).astype(np.float32)
QU = (Q1 / np.linalg.norm(Q1, axis=-1, keepdims=True)).astype(np.float32)
SEEDS = RNG.integers(0, 2**32, 256, dtype=np.uint64)
EXACT = ("sobol_owen_2d", "median3")  # integer bits, sorted taps
# matrix-vector products: name -> the magnitude of their terms
TERMS = {"matvec": lambda: np.einsum("...ij,...j->...i", np.abs(M3),
                                     np.abs(V))}

t = torch.from_numpy
j = jnp.asarray

# name -> (JAX call, port call)
CASES = {
    "xyz_to_srgb": (lambda: Jcol.xyz_to_srgb(j(COL)),
                    lambda: Tcol.xyz_to_srgb(t(COL))),
    "srgb_to_xyz": (lambda: Jcol.srgb_to_xyz(j(COL)),
                    lambda: Tcol.srgb_to_xyz(t(COL))),
    "xyz_to_aces2065": (lambda: Jcol.xyz_to_aces2065(j(COL)),
                        lambda: Tcol.xyz_to_aces2065(t(COL))),
    "srgb_to_acescg": (lambda: Jcol.srgb_to_acescg(j(COL)),
                       lambda: Tcol.srgb_to_acescg(t(COL))),
    "acescg_to_srgb": (lambda: Jcol.acescg_to_srgb(j(COL)),
                       lambda: Tcol.acescg_to_srgb(t(COL))),
    "linear_to_srgb_gamma": (lambda: Jcol.linear_to_srgb_gamma(j(COL)),
                             lambda: Tcol.linear_to_srgb_gamma(t(COL))),
    "srgb_gamma_to_linear": (lambda: Jcol.srgb_gamma_to_linear(j(COL)),
                             lambda: Tcol.srgb_gamma_to_linear(t(COL))),
    "clamp": (lambda: JV.clamp(j(V), -0.5, 0.7),
              lambda: TV.clamp(t(V), -0.5, 0.7)),
    "saturate": (lambda: JV.saturate(j(V)), lambda: TV.saturate(t(V))),
    "project": (lambda: JV.project(j(V), j(V2)),
                lambda: TV.project(t(V), t(V2))),
    "abs_max_component_index": (
        lambda: JV.abs_max_component_index(j(V)),
        lambda: TV.abs_max_component_index(t(V))),
    "matvec": (lambda: JV.matvec(j(M3), j(V)),
               lambda: TV.matvec(t(M3), t(V))),
    "mat3_from_axis_angle": (lambda: JV.mat3_from_axis_angle(j(UNIT), j(ANG)),
                             lambda: TV.mat3_from_axis_angle(t(UNIT),
                                                             t(ANG))),
    "rotate_axis_angle": (
        lambda: JV.rotate_axis_angle(j(V), j(UNIT), j(ANG)),
        lambda: TV.rotate_axis_angle(t(V), t(UNIT), t(ANG))),
    "mat4_translate": (lambda: JV.mat4_translate(j(V[0])),
                       lambda: TV.mat4_translate(t(V[0]))),
    "mat4_scale": (lambda: JV.mat4_scale(j(V[1])),
                   lambda: TV.mat4_scale(t(V[1]))),
    "mat4_scale_uniform": (lambda: JV.mat4_scale(2.5),
                           lambda: TV.mat4_scale(2.5)),
    "mat4_from_mat3": (lambda: JV.mat4_from_mat3(j(M3[0])),
                       lambda: TV.mat4_from_mat3(t(M3[0]))),
    "transform_point": (lambda: JV.transform_point(j(M4), j(V)),
                        lambda: TV.transform_point(t(M4), t(V))),
    "transform_dir": (lambda: JV.transform_dir(j(M4), j(V)),
                      lambda: TV.transform_dir(t(M4), t(V))),
    "quat_from_axis_angle": (
        lambda: JV.quat_from_axis_angle(j(UNIT), j(ANG)),
        lambda: TV.quat_from_axis_angle(t(UNIT), t(ANG))),
    "quat_mul": (lambda: JV.quat_mul(j(Q1), j(Q2)),
                 lambda: TV.quat_mul(t(Q1), t(Q2))),
    "quat_rotate": (lambda: JV.quat_rotate(j(QU), j(V)),
                    lambda: TV.quat_rotate(t(QU), t(V))),
    "kahan_add": (lambda: JV.kahan_add(j(V[:, 0]), j(V[:, 1]) * 1e-4,
                                       j(V[:, 2])),
                  lambda: TV.kahan_add(t(V[:, 0]), t(V[:, 1]) * 1e-4,
                                       t(V[:, 2]))),
    "sobol_owen_2d": (
        lambda: JSa.sobol_owen_2d(jnp.uint32(7), j(SEEDS.astype(np.uint32))),
        lambda: TSa.sobol_owen_2d(7, t(SEEDS.astype(np.int64)))),
    "median3": (lambda: JSh.median3(j(COL)), lambda: TSh.median3(t(COL))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    jfn, tfn = CASES[name]
    ref, got = jfn(), tfn()
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for r, g in zip(refs, gots, strict=True):
        r, g = np.asarray(r), g.numpy()
        assert r.shape == g.shape, name
        if np.issubdtype(r.dtype, np.integer) or name in EXACT:
            np.testing.assert_array_equal(g, r.astype(g.dtype))
        elif name in TERMS:
            assert (np.abs(g - r) <= 1e-6 * TERMS[name]() + 1e-7).all()
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def camera_pair():
    jc = JC.make_camera(pos=(0.3, 2.0, -5.0), yaw=0.2, pitch=-0.1, fov_y=1.1,
                        aperture=0.05, focal_dist=4.0)
    return JC.camera_basis(jc), TC.camera_basis(
        interop.camera_from_jax(jc, "cpu"))


def test_pixel_grid(camera_pair):
    jc, ji = JR.pixel_grid(13, 7)
    tc, ti = TR.pixel_grid(13, 7, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32


def test_generate_rays(camera_pair):
    jb, tb = camera_pair
    w, h = 24, 10
    jit = RNG.uniform(size=(w * h, 2)).astype(np.float32)
    lens = RNG.uniform(size=(w * h, 2)).astype(np.float32)
    ref = JR.generate_rays(jb, w, h, j(jit), j(lens))
    got = TR.generate_rays(tb, w, h, t(jit), t(lens))
    for f in ("org", "dir", "uv", "cone_width"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def test_env_radiance_analytic():
    jm = JSk.finalize_sky_maps(jax.jit(lambda p: JSk.bake_sky_maps(
        p, sky_res=(8, 16), sun_res=(4, 4)))(JSk.make_sky_params()))
    tm = interop.sky_from_jax(jm, "cpu")
    d = RNG.normal(size=(96, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sun = np.asarray(jm.sun_dir, np.float32)
    d[:4] = sun  # the sun disk itself
    ref = np.asarray(JSk.env_radiance_analytic(jm, j(d)))
    got = TSk.env_radiance_analytic(tm, t(d)).numpy()
    assert (ref[:4] > ref[4:].max()).all()  # the disk is in
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=1e-7)
