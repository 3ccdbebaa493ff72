"""Interlaced rendering (engine/frame.py, FrameStatic.interlace): the port
against the JAX pieces and against its own full-rate frame.

JAX's interlace runs only on its megakernel route (a TPU, or Pallas
interpret mode in the slow tier), so the JAX frame on the CPU ignores the
flag; the port's interlace is held to the JAX functions piece by piece:
  * interleave_rows on float and integer planes, 2-D and 3-D: exact;
  * the full-height reconstruction of given traced planes (linear fills
    for radiance and albedo, nearest rows for geometry) vs the JAX formula
    (rtrt_tpu/engine/frame.py:434-444, written out here on top of JAX's
    interleave_rows, since _lin and _nn are closures there): exact;
  * each field's pixel ids and blue-noise rows vs the JAX construction
    (:326-358): exact;
and the port's interlaced frame traces, for either parity, rows equal bit
for bit to the same rows of its full-rate frame at the same frame index,
on every G-buffer plane (a pixel's path does not depend on its
neighbours).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh.packet import TILE_SHAPE
from rtrt_tpu.engine.frame import interleave_rows as jinterleave
from rtrt_tpu.render.sampling import blue_offsets_flat as jblue
from rtrt_tpu_torch.bvh.packet import overflow_counter, pack_tables
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.core.camera import make_camera
from rtrt_tpu_torch.denoise.pipeline import init_history
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu_torch.post.exposure import init_exposure_state
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.render.sky import (bake_sky_maps, finalize_sky_maps,
                                       make_sky_params)
from rtrt_tpu_torch.utils.config import FeatureFlags, default_params

torch.set_num_threads(1)
W, H = 32, 16
PLANES = ("color", "albedo", "normal", "depth", "motion", "mat_id")


def _planes(seed, h2, w):
    rng = np.random.default_rng(seed)
    return dict(color=rng.lognormal(size=(h2, w, 3)).astype(np.float32),
                depth=rng.uniform(1, 50, (h2, w)).astype(np.float32),
                mat_id=rng.integers(-1, 5, (h2, w)).astype(np.int32),
                motion=rng.normal(size=(h2, w, 2)).astype(np.float32))


@pytest.mark.parametrize("name", ["color", "depth", "mat_id", "motion"])
def test_interleave_rows_matches(name):
    a, b = _planes(1, 5, 7)[name], _planes(2, 5, 7)[name]
    ref = np.asarray(jinterleave(jnp.asarray(a), jnp.asarray(b)))
    got = TF.interleave_rows(torch.from_numpy(a), torch.from_numpy(b))
    assert got.numpy().dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _jax_lin(c, parity):
    nxt = jnp.concatenate([c[1:], c[-1:]], axis=0)
    prv = jnp.concatenate([c[:1], c[:-1]], axis=0)
    even = jinterleave(c, (c + nxt) * 0.5)
    odd = jinterleave((prv + c) * 0.5, c)
    return jnp.where(parity == 1, odd, even)


@pytest.mark.parametrize("parity", [0, 1])
def test_reconstruction_matches(parity):
    planes = _planes(3 + parity, 6, 9)
    for name, x in planes.items():
        t = torch.from_numpy(x)
        got = TF.fill_nearest(t)
        ref = jinterleave(jnp.asarray(x), jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), name)
        if x.dtype == np.float32:
            got = TF.fill_linear(t, parity)
            ref = _jax_lin(jnp.asarray(x), jnp.int32(parity))
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                          name)


@pytest.mark.parametrize("size", [(32, 16), (480, 270), (640, 360)])
def test_field_ids_and_blue_noise_rows(size):
    w, h = size
    static = TF.FrameStatic(render_w=w, render_h=h, screen_w=w, screen_h=h,
                            flags=FeatureFlags(), interlace=True)
    consts = TF.make_frame_consts(static, "cpu")
    if h % 2:  # odd heights trace every row (as JAX)
        assert consts.fields is None and not TF.interlaced(static)
        return
    th, tw = TILE_SHAPE
    ht = h // 2
    hp, wp = -(-ht // th) * th, -(-w // tw) * tw
    rows = jblue(w, h, w * h).reshape(h, w, 2)
    for parity in (0, 1):
        yy = np.minimum(np.arange(hp, dtype=np.int32) * 2 + parity, h - 1)
        xx = np.minimum(np.arange(wp, dtype=np.int32), w - 1)
        ids = (yy[:, None] * w + xx[None, :])[:ht, :w]
        bn = np.pad(rows[parity::2], ((0, hp - ht), (0, wp - w), (0, 0)),
                    mode="edge")[:ht, :w]
        got_ids, got_bn = consts.fields[parity]
        np.testing.assert_array_equal(got_ids.numpy(), ids)
        np.testing.assert_array_equal(got_bn.numpy(), bn)


@pytest.fixture(scope="module")
def scene():
    host = build_demo_scene()
    pad = padded_arrays(host)
    bvh, nrm, mat = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    sky = finalize_sky_maps(bake_sky_maps(make_sky_params(device="cpu"),
                                          sky_res=(16, 32), sun_res=(4, 4)))
    return SceneData(tables=pack_tables(bvh, nrm, mat, bvh4_nodes(bvh)),
                     materials=host.materials, sky=sky, lights=host.lights)


@pytest.mark.parametrize("frame", [4, 7])
def test_interlaced_frame_traces_full_rate_rows(scene, frame):
    """Frame `frame` of a slow pan, denoised (default flags), full rate and
    interlaced from the same state: the field's traced G-buffer rows equal
    rows frame & 1, frame & 1 + 2, ... of the full-rate G-buffer."""
    full = TF.FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                          flags=FeatureFlags())
    il = dataclasses.replace(full, interlace=True)
    cam = make_camera(pos=(0.1, 3.0, -9.0), yaw=0.02, pitch=-0.15,
                      fov_y=1.1, device="cpu")
    prev = make_camera(pos=(0.05, 3.0, -9.0), yaw=0.01, pitch=-0.15,
                       fov_y=1.1, device="cpu")
    out = {}
    for static in (full, il):
        state = TF.FrameState(exposure=init_exposure_state("cpu"),
                              history=init_history(H, W, device="cpu"),
                              frame_idx=frame)
        ovf = overflow_counter("cpu")
        img, new_state, gb = TF.render_frame(static, scene, state, cam, prev,
                                             default_params(), 1 / 60,
                                             overflow=ovf)
        assert int(ovf) == 0
        assert img.shape == (H, W, 3) and img.dtype == torch.uint8
        assert new_state.history.color.shape == (H, W, 3)
        out[static.interlace] = gb
    p = frame & 1
    for name in PLANES:
        traced, ref = getattr(out[True], name), getattr(out[False], name)
        assert traced.shape[0] == H // 2, name
        assert torch.equal(traced, ref[p::2]), name
