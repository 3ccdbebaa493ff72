"""Post chain: the port's postprocess (exposure pyramid + the plain tail) vs
the JAX postprocess(use_pallas=False), on random HDR frames made with numpy.

u8 output within 1 LSB on >= 99.9% of pixels: both sides run the same
float32 tone map / sharpen / dither, and a value that lands within an ulp
of a quantisation step may round to either neighbour (XLA contracts a*b+c
into FMA, torch rounds twice; powf implementations differ in the last
bit).  Exposure state rtol 1e-5, the 4x4 pyramid rtol 1e-6 (sums of 16
values in another order).  K3 is held to the plain version on the card in
test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.ops.resize import downsample4 as jdown
from rtrt_tpu.post import exposure as JE
from rtrt_tpu.post.pipeline import postprocess as jpost
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.ops.resize import downsample4 as tdown
from rtrt_tpu_torch.post import exposure as TE
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


def _u8_close(a, b, frac=0.999):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert (d.max(-1) <= 1).mean() >= frac, (d.max(), (d > 1).mean())


def test_pyramid_and_exposure():
    c = _frame(1, 128, 256)
    js, ts = jnp.asarray(c), torch.from_numpy(c)
    for _ in range(3):
        js, ts = jdown(js), tdown(ts)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-6)
    jst = JE.init_exposure_state()
    tst = TE.init_exposure_state("cpu")
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
    for _ in range(3):  # first step initialises, later ones adapt
        jst = JE.auto_exposure(js, jst, jnp.float32(1 / 30), jnp.float32(1.3))
        tst = TE.auto_exposure(ts, tst, 1 / 30, 1.3)
        np.testing.assert_allclose(np.asarray(jst), tst.numpy(), rtol=1e-5)


@pytest.mark.parametrize("tone", [0.0, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("sharpen,dither", [(True, True), (False, True),
                                            (True, False)])
def test_postprocess_matches(tone, sharpen, dither):
    c = _frame(int(tone) + 7)
    jp = jparams().post._replace(tone_map=jnp.float32(tone))
    tp = tparams().post
    tp.tone_map = tone
    jf = JFlags(denoise=False, bloom=False, lens_flare=False,
                sharpen=sharpen, dither=dither)
    tf = TFlags(denoise=False, bloom=False, lens_flare=False,
                sharpen=sharpen, dither=dither)
    jst, tst = JE.init_exposure_state(), TE.init_exposure_state("cpu")
    for frame in (0, 5):
        ju8, jst = jpost(jnp.asarray(c), jst, jnp.float32(1 / 60),
                         jnp.zeros(2), jnp.float32(0.0), jp, jf, H, W,
                         jnp.uint32(frame), use_pallas=False)
        tu8, tst = tpost(torch.from_numpy(c), tst, 1 / 60, torch.zeros(2),
                         torch.tensor(0.0), tp, tf, H, W, frame)
        assert tu8.dtype == torch.uint8 and tu8.shape == (H, W, 3)
        _u8_close(np.asarray(ju8), tu8.numpy())
        np.testing.assert_allclose(np.asarray(jst), tst.numpy(), rtol=1e-5)


def test_unported_passes_raise():
    """The render-to-screen upscale is the one pass of the chain not
    ported; bloom and lens flare run (test_torch_bloom_flare.py)."""
    c = torch.from_numpy(_frame(3))
    st = TE.init_exposure_state("cpu")
    for oh, ow in ((2 * H, 2 * W), (H, 2 * W)):
        with pytest.raises(NotImplementedError):
            tpost(c, st, 1 / 60, torch.zeros(2), torch.tensor(0.0),
                  tparams().post, TFlags(), oh, ow, 0)
