"""Resampling and the upscaled post tail: the port vs the JAX modules on
numpy inputs.

Tolerances:
  * bilinear_sample, bicubic_catmull_rom_sample, upscale_catmull_rom:
    rtol 1e-5, atol 1e-6.  Both sides take the same products and sums in
    the same order (the port's upscale is separable, and equal to its
    16-tap sampler on the pixel centres, checked exactly below); XLA may
    contract a*b+c into one FMA where torch rounds twice.
  * downsample2: rtol 1e-6 (sums of 4 values in another order).
  * The upscaled tail: the port's tone map, Catmull-Rom upscale and plain
    tail on pre-mapped input vs the JAX postprocess at an output size
    other than the render size (use_pallas=False): u8 within 1 everywhere
    and equal on >= 99.9% of pixels (a value within an ulp of a
    quantisation step may round either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.ops import resize as JR
from rtrt_tpu.ops import stencil as JS
from rtrt_tpu.post.exposure import init_exposure_state as jexpo
from rtrt_tpu.post.pipeline import postprocess as jpost
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu.utils.config import default_params as jparams
from rtrt_tpu_torch.ops import resize as TR
from rtrt_tpu_torch.ops import stencil as TS
from rtrt_tpu_torch.post.pipeline import dither_mask
from rtrt_tpu_torch.post.tail import post_tail, post_tail_plain, tail_params
from rtrt_tpu_torch.post.tonemap import tonemap
from rtrt_tpu_torch.render.sampling import _to_unit_float, hash_pcg, u32
from rtrt_tpu_torch.utils.config import default_params as tparams

torch.set_num_threads(1)
SHAPES = [(16, 32), (1, 1), (1, 9), (9, 1), (37, 5)]


def _img(seed, h, w, c=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(h, w, c)).astype(np.float32)


@pytest.mark.parametrize("fn", ["bilinear_sample",
                                "bicubic_catmull_rom_sample"])
@pytest.mark.parametrize("shape", SHAPES)
def test_samplers_match(fn, shape):
    h, w = shape
    img = _img(h * 31 + w, h, w)
    rng = np.random.default_rng(7)
    # uv beyond [0, 1] on both sides: the coordinates clamp to the edge
    uv = rng.uniform(-0.25, 1.25, (11, 13, 2)).astype(np.float32)
    uv[0, :3] = [[0.0, 0.0], [1.0, 1.0], [0.5, 0.5]]
    ref = np.asarray(getattr(JS, fn)(jnp.asarray(img), jnp.asarray(uv)))
    got = getattr(TS, fn)(torch.from_numpy(img), torch.from_numpy(uv))
    assert got.shape == (11, 13, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((16, 32), (24, 48)),
                                     ((27, 48), (108, 192)),
                                     ((72, 128), (16, 32)),
                                     ((1, 1), (5, 7)), ((9, 1), (4, 3)),
                                     ((1, 9), (2, 20))])
def test_upscale_catmull_rom_matches(src, dst):
    img = _img(src[0] + 100 * src[1], *src)
    ref = np.asarray(JR.upscale_catmull_rom(jnp.asarray(img), *dst))
    got = TR.upscale_catmull_rom(torch.from_numpy(img), *dst)
    assert got.shape == dst + (3,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    # the separable form is the 16-tap sampler on the output's pixel
    # centres, value for value
    oh, ow = dst
    ys = (torch.arange(oh, dtype=torch.float32) + 0.5) / oh
    xs = (torch.arange(ow, dtype=torch.float32) + 0.5) / ow
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    taps = TS.bicubic_catmull_rom_sample(torch.from_numpy(img),
                                         torch.stack([xx, yy], dim=-1))
    assert torch.equal(got, taps)


@pytest.mark.parametrize("shape", [(16, 32), (9, 13), (2, 2)])
def test_downsample2_matches(shape):
    img = _img(5, *shape)
    ref = np.asarray(JR.downsample2(jnp.asarray(img)))
    got = TR.downsample2(torch.from_numpy(img))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tone", [0.0, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("size", [(24, 40, 48, 80), (27, 48, 108, 192),
                                  (30, 50, 17, 29)])
def test_upscaled_tail_matches(tone, size):
    """Render h x w, screen oh x ow; bloom and lens flare off, so that the
    tail alone differs from test_torch_post.py's equal-size chain."""
    h, w, oh, ow = size
    rng = np.random.default_rng(int(tone) + h)
    c = rng.lognormal(mean=-1.0, sigma=1.5, size=(h, w, 3))
    c[: h // 3] *= 4.0
    c = c.astype(np.float32)
    flags = JFlags(denoise=False, bloom=False, lens_flare=False)
    jp = jparams().post._replace(tone_map=jnp.float32(tone))
    ref, jst = jpost(jnp.asarray(c), jexpo(), jnp.float32(1 / 60),
                     jnp.zeros(2), jnp.float32(0.0), jp, flags, oh, ow,
                     jnp.uint32(5), use_pallas=False)
    ev = float(np.asarray(jst)[0])
    tp = tparams().post
    fshift = float(_to_unit_float(hash_pcg(u32(5))))
    par = tail_params(ev, tone, tp.gamma, tp.sharpen_amount, fshift, "cpu")
    ldr = tonemap(torch.from_numpy(c) * par[0], par[1], par[2])
    ldr = torch.clamp(TR.upscale_catmull_rom(ldr, oh, ow), 0.0, 1.0)
    mask = dither_mask("cpu")
    for sh, di in ((True, True), (False, False)):
        if not (sh and di):
            flags = JFlags(denoise=False, bloom=False, lens_flare=False,
                           sharpen=sh, dither=di)
            ref, _ = jpost(jnp.asarray(c), jexpo(), jnp.float32(1 / 60),
                           jnp.zeros(2), jnp.float32(0.0), jp, flags, oh, ow,
                           jnp.uint32(5), use_pallas=False)
        got = post_tail_plain(ldr, par, mask, do_sharpen=sh, do_dither=di,
                              mapped=True)
        # the wrapper takes the plain version for a CPU tensor
        assert torch.equal(post_tail(ldr, par, mask, do_sharpen=sh,
                                     do_dither=di, mapped=True), got)
        assert got.shape == (oh, ow, 3) and got.dtype == torch.uint8
        d = np.abs(got.numpy().astype(np.int32)
                   - np.asarray(ref).astype(np.int32))
        assert d.max() <= 1, d.max()
        assert (d.max(-1) == 0).mean() >= 0.999, (d.max(-1) == 0).mean()
