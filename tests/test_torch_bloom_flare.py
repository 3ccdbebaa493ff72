"""Bloom, lens flare and the bilinear upsample of the port against the JAX
package's, and the post chain with both on against the JAX XLA post path,
on numpy inputs.

Tolerances: upsample_linear atol 1e-5 (jax.image.resize contracts dense
weight matrices; F.interpolate blends two taps per axis, and the sample
positions differ in the last bit); bloom rtol 1e-5 + atol 1e-5 (5x5
Gaussian sums in another order); lens flare atol 1e-5 (exp / sqrt of the
same float32 arguments; cos / sin of the streak angles in float64 vs
float32); the post chain u8 within 1 LSB on >= 99.9% of pixels and
max |du8| <= 1 (a value within an ulp of a quantisation step may round
to either neighbour)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.ops.resize import upsample_linear as jup
from rtrt_tpu.post import exposure as JE
from rtrt_tpu.post.bloom import bloom as jbloom
from rtrt_tpu.post.lensflare import lens_flare as jflare
from rtrt_tpu.post.pipeline import postprocess as jpost
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.ops.resize import upsample_linear as tup
from rtrt_tpu_torch.post import exposure as TE
from rtrt_tpu_torch.post.bloom import bloom as tbloom
from rtrt_tpu_torch.post.lensflare import lens_flare as tflare
from rtrt_tpu_torch.post.pipeline import postprocess as tpost
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from rtrt_tpu_torch.utils.config import default_params as tparams

torch.set_num_threads(1)
H, W = 75, 130


def _frame(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    c = rng.lognormal(mean=-1.0, sigma=1.5, size=(h, w, 3))
    c[: h // 3] *= 4.0  # a bright band (sky-like)
    return c.astype(np.float32)


def test_upsample_linear_non_integer_ratio():
    """1080p's 1/16 bloom level: 1080 // 16 = 67 rows, so 67 -> 1080 is not
    an exact 16x (nor is 120 -> 1920 / 1080 -> 67 a whole ratio)."""
    rng = np.random.default_rng(1)
    small = rng.uniform(0, 4, (1080 // 16, 1920 // 16, 3)).astype(np.float32)
    ref = np.asarray(jup(jnp.asarray(small), 1080, 1920))
    got = tup(torch.from_numpy(small), 1080, 1920)
    assert got.shape == (1080, 1920, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bright", [0.3, 2.0])
def test_bloom_matches_jax(bright):
    c = _frame(2)
    ref = jbloom(jnp.asarray(c), jnp.float32(bright), jnp.float32(0.05))
    got = tbloom(torch.from_numpy(c), torch.tensor(bright), 0.05)
    assert not np.allclose(np.asarray(ref), c)  # it does add light
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sun_uv,visible", [((0.3, 0.2), 1.0),
                                            ((0.8, 0.6), 1.0),
                                            ((0.3, 0.2), 0.0)])
def test_lens_flare_matches_jax(sun_uv, visible):
    ref = np.asarray(jflare(H, W, jnp.asarray(sun_uv, jnp.float32),
                            jnp.float32(visible), jnp.float32(1.0)))
    got = tflare(H, W, torch.tensor(sun_uv, dtype=torch.float32),
                 torch.tensor(visible), 1.0)
    assert (ref.max() > 0.1) == (visible > 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_postprocess_with_bloom_and_flare_matches_jax():
    c = _frame(3)
    jf, tf = JFlags(), TFlags()
    jp, tp = jparams().post, tparams().post
    jst, tst = JE.init_exposure_state(), TE.init_exposure_state("cpu")
    sun_uv, vis = (0.35, 0.25), 1.0
    for frame in (0, 5):
        ju8, jst = jpost(jnp.asarray(c), jst, jnp.float32(1 / 60),
                         jnp.asarray(sun_uv, jnp.float32), jnp.float32(vis),
                         jp, jf, H, W, jnp.uint32(frame), use_pallas=False)
        tu8, tst = tpost(torch.from_numpy(c), tst, 1 / 60,
                         torch.tensor(sun_uv, dtype=torch.float32),
                         torch.tensor(vis), tp, tf, H, W, frame)
        d = np.abs(np.asarray(ju8, np.int32) - tu8.numpy().astype(np.int32))
        assert d.max() <= 1, d.max()
        assert (d.max(-1) == 0).mean() >= 0.999
        np.testing.assert_allclose(np.asarray(jst), tst.numpy(), rtol=1e-5)
