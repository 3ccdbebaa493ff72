"""Fourier-fitted textures and the texture module: port == JAX on the same
numpy inputs (JAX on the CPU).

  * make_soil_textures: every texel of every mip level equal bit for bit
    (the same numpy noise and float32 math; the 2x2 box means in float32);
    the fit of those texels (host numpy lstsq) equal tuple for tuple;
  * the gather path (sample_trilinear, triplanar_sample, apply_normal_map)
    against JAX's on random hits: atol 1e-6 (float32 ops in the same order;
    XLA may contract products into FMAs);
  * eval_fourier_c, triplanar_fourier_c, ftex_shading_c against JAX's run
    op by op (jax.disable_jit), at positions within 40 tiles: atol 2e-5
    (24 atoms' cosines of angles up to ~2000 rad, whose float32 rounding
    the two libraries' cos treat alike to an ulp or two);
  * ftex_from_jax carries a JAX fit across unchanged, and pack_ftex /
    upload_ftex write it as K2's coefficient table; the port's constants
    equal the JAX functions' defaults and kshade.cuh's table layout.
The plain K2 with the fit is held to JAX's simulator in
tests/test_torch_ftex_megakernel.py, K2's Fourier branch to the plain
version on the card in tests/test_torch_kernels_gpu.py and chip_smoke.py
phase 15."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.render import ftex as JX
from rtrt_tpu.render import kshade as JK
from rtrt_tpu.render import texture as JT
from rtrt_tpu_torch.render import ftex as TX
from rtrt_tpu_torch.render import kshade as TK
from rtrt_tpu_torch.render import texture as TT
from rtrt_tpu_torch.utils import interop

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def soils():
    return JT.make_soil_textures(32), TT.make_soil_textures(32,
                                                            device="cpu")


@pytest.fixture(scope="module")
def fits(soils):
    js, ts = soils
    return JX.fit_soil_fourier(js), TX.fit_soil_fourier(ts)


def test_soil_texels_bit_equal(soils):
    js, ts = soils
    for f in ("albedo_ao", "normal_rough"):
        j, t = getattr(js, f), getattr(ts, f)
        assert t.base_size == j.base_size == 32 and t.num_levels == 6
        assert np.array_equal(np.asarray(j.offsets), t.offsets.numpy())
        a, b = np.asarray(j.texels), t.texels.numpy()
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes(), f


def test_soil_fit_equal(fits):
    jf, tf = fits
    assert tuple(tf.albedo_ao) == tuple(jf.albedo_ao)
    assert tuple(tf.normal_rough) == tuple(jf.normal_rough)
    assert len(tf.albedo_ao.freq) == 48  # 24 atoms, a cos and a sin term


def _hits(n, seed, spread=5.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    cone = rng.uniform(0.0, 0.3, n).astype(np.float32)
    return pos, nrm, cone


def test_gather_path_matches_jax(soils):
    js, ts = soils
    pos, nrm, cone = _hits(512, 3)
    for f in ("albedo_ao", "normal_rough"):
        ref = np.asarray(jax.jit(lambda p, n, c, f=f: JT.triplanar_sample(
            getattr(js, f), p, n, c))(pos, nrm, cone))
        got = TT.triplanar_sample(getattr(ts, f), torch.from_numpy(pos),
                                  torch.from_numpy(nrm),
                                  torch.from_numpy(cone)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=f)
    uv = np.random.default_rng(4).uniform(0, 1, (256, 2)).astype(np.float32)
    lod = np.linspace(0.0, 6.0, 256).astype(np.float32)
    ref = np.asarray(JT.sample_trilinear(js.albedo_ao, uv, lod))
    got = TT.sample_trilinear(ts.albedo_ao, torch.from_numpy(uv),
                              torch.from_numpy(lod)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    tex_n = np.asarray(js.normal_rough.texels[:256, :3])
    ref = np.asarray(JT.apply_normal_map(jnp.asarray(nrm[:256]),
                                         jnp.asarray(tex_n)))
    got = TT.apply_normal_map(torch.from_numpy(nrm[:256]),
                              torch.from_numpy(np.array(tex_n))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _v3(mod, a, conv):
    return mod.V3(*(conv(a[:, k]) for k in range(3)))


def test_fourier_eval_matches_jax(fits):
    jf, tf = fits
    pos, nrm, cone = _hits(512, 5, spread=160.0)  # 40 tiles a side
    jp, jn = _v3(JK, pos, jnp.asarray), _v3(JK, nrm, jnp.asarray)
    tp, tn = _v3(TK, pos, torch.from_numpy), _v3(TK, nrm, torch.from_numpy)
    jc, tc = jnp.asarray(cone), torch.from_numpy(cone)
    with jax.disable_jit():
        ref_e = JX.eval_fourier_c(jf.albedo_ao, jp.x * 0.25, jp.z * 0.25,
                                  jc * 0.125)
        ref_t = JX.triplanar_fourier_c(jf.normal_rough, jp, jn, jc)
        ref_s = JX.ftex_shading_c(jf, jp, jn, jc)
    got_e = TX.eval_fourier_c(tf.albedo_ao, tp.x * 0.25, tp.z * 0.25,
                              tc * 0.125)
    got_t = TX.triplanar_fourier_c(tf.normal_rough, tp, tn, tc)
    got_s = TX.ftex_shading_c(tf, tp, tn, tc)
    pairs = list(zip(ref_e, got_e)) + list(zip(ref_t, got_t))
    (ja, jr, jn2), (ta, tr, tn2) = ref_s, got_s
    pairs += list(zip(ja, ta)) + [(jr, tr)] + list(zip(jn2, tn2))
    for r, g in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-5)
    # the series against the float64 oracle at the same coordinates
    oracle = TX.eval_fourier_np(tf.albedo_ao, pos[:, 0] * 0.25,
                                pos[:, 2] * 0.25, 0.0)
    got0 = TX.eval_fourier_c(tf.albedo_ao, tp.x * 0.25, tp.z * 0.25,
                             torch.zeros_like(tc))
    for c in range(4):
        np.testing.assert_allclose(got0[c].numpy(), oracle[:, c], atol=2e-4)


def test_ftex_from_jax_and_table(fits):
    jf, tf = fits
    carried = interop.ftex_from_jax(jf)
    assert carried == tf and isinstance(carried, TX.FourierTextures)
    up = TX.upload_ftex(carried, "cpu")
    assert up.fit is carried
    table = up.table.numpy()
    assert np.array_equal(table, TX.pack_ftex(carried))
    assert table.shape == (2, TX.FTEX_ROW) and table.dtype == np.float32
    for row, tex in zip(table, carried):
        assert tuple(row[:4]) == tuple(np.float32(m) for m in tex.mean)
        assert row[4] == TX.WORLD_SCALE and not row[5:TX.FTEX_HEAD].any()
        rec = row[TX.FTEX_HEAD:].reshape(TX.FTEX_ATOMS, TX.FTEX_ATOM)
        fx, fy = np.asarray(tex.freq[0::2]).T
        assert np.array_equal(rec[:, 0], np.float32(2.0 * np.pi * fx))
        assert np.array_equal(rec[:, 2], np.float32(
            -2.0 * np.pi ** 2 * (fx * fx + fy * fy)))
        assert np.array_equal(rec[:, 4:8], np.float32(tex.weight[0::2]))
        assert np.array_equal(rec[:, 8:12], np.float32(tex.weight[1::2]))
    odd = tf.albedo_ao._replace(phase=(0.5,) + tf.albedo_ao.phase[1:])
    with pytest.raises(ValueError, match="cos / sin"):
        TX.pack_ftex(tf._replace(albedo_ao=odd))
    short = tf.albedo_ao._replace(**{f: getattr(tf.albedo_ao, f)[:-2]
                                     for f in ("freq", "phase", "weight")})
    with pytest.raises(ValueError, match="46 terms"):
        TX.pack_ftex(tf._replace(albedo_ao=short))


def test_constants_match_jax_and_kernel():
    """The port fixes as module constants what the JAX functions take as
    defaults (the fit's atoms and frequencies, the textures' world scale,
    the Preetham turbidity), and K2's table layout in csrc/kshade.cuh
    equals render/ftex.py's."""
    import inspect
    import os
    import re
    from rtrt_tpu.render import sky as JS
    from rtrt_tpu_torch.render import sky as TS

    default = lambda fn, name: inspect.signature(fn).parameters[name].default
    assert default(JX.fit_fourier_texture, "n_terms") == TX.N_TERMS
    assert default(JX.fit_soil_fourier, "max_freq") == TX.MAX_FREQ
    assert default(JX.triplanar_fourier_c, "world_scale") == TX.WORLD_SCALE
    assert default(JT.triplanar_sample, "world_scale") == TT.WORLD_SCALE
    assert default(JS.preetham_radiance, "turbidity") == \
        TS.PREETHAM_TURBIDITY
    src = open(os.path.join(os.path.dirname(TX.__file__), os.pardir, "csrc",
                            "kshade.cuh")).read()
    for name in ("FTEX_ATOMS", "FTEX_HEAD", "FTEX_ATOM"):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert got and int(got.group(1)) == getattr(TX, name), name
