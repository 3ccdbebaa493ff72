"""The animation clock and the wave displacement of the sorted rows
(engine/frame.py): the port against the JAX frame's displace_wave_rows /
wave_normal_rows and its float32 clock.

Tolerances: the displaced rows within 2e-6 absolute plus one float32 ulp
of the coordinate (rtol 1.2e-7), and the transformed normals within 2e-6
per component, on coordinates up to 64 units at clock values up to the
1,000th frame's.  XLA on the CPU contracts `freq * x + time * speed` into
one FMA, torch rounds the product first: the sine's argument moves by an
ulp, ~4e-6 at 57, and dy by its 0.35 amplitude times that, ~1.3e-6; the
sum y + dy may then round to the neighbouring ulp of y (measured: one
element of 18,432 by 3.8e-6 at y ~ 60, the rest within 5e-7).  The clock
must equal JAX's float32 accumulation bit for bit after 1,000 frames of
dt = 1/60 s, and save_state / load_state keep it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.engine import frame as JF
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah
from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                         GlobalSettings)

torch.set_num_threads(1)


def _jax_clock(n, dt):
    step = jax.jit(lambda t, d: t + d)
    t = jnp.float32(0.0)
    for _ in range(n):
        t = step(t, jnp.float32(max(dt, 1e-4)))
    return np.float32(t)


def test_clock_matches_jax_float32_after_1000_frames():
    t = 0.0
    for _ in range(1000):
        t = TF.advance_clock(t, max(1 / 60, 1e-4))
    ref = _jax_clock(1000, 1 / 60)
    assert np.float32(t).tobytes() == ref.tobytes()
    assert float(np.float32(t)) == t  # a float32 value, held on the host
    # a float64 clock drifts from it: the phase the wave and the ocean read
    assert abs(1000 / 60 - t) > 5e-5


def _tables():
    host = build_demo_scene()
    pad = padded_arrays(host)
    bvh, nrm, _ = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    rng = np.random.default_rng(5)
    p = 2048  # a terrain-scale table: coordinates up to 64 units
    big = rng.uniform(-64, 64, (9, p)).astype(np.float32)
    n = rng.normal(size=(3, 3, p)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return [(bvh.tris_t, nrm),
            (torch.from_numpy(big), torch.from_numpy(n.reshape(9, p)))]


@pytest.mark.parametrize("t", [0.0, 0.37, 5.25, 16.666584])
def test_wave_rows_match_jax(t):
    for tris_t, nrm_t in _tables():
        jt = np.asarray(JF.displace_wave_rows(jnp.asarray(tris_t.numpy()),
                                              jnp.float32(t)))
        jn = np.asarray(JF.wave_normal_rows(jnp.asarray(nrm_t.numpy()),
                                            jnp.asarray(tris_t.numpy()),
                                            jnp.float32(t)))
        got = TF.displace_wave_rows(tris_t, t)
        gn = TF.wave_normal_rows(nrm_t, tris_t, t)
        assert got.shape == tris_t.shape and gn.shape == nrm_t.shape
        np.testing.assert_allclose(got.numpy(), jt, rtol=1.2e-7, atol=2e-6)
        np.testing.assert_allclose(gn.numpy(), jn, rtol=0, atol=2e-6)
        # x and z rows pass through; the rest pose is not written
        for r in (0, 2, 3, 5, 6, 8):
            assert torch.equal(got[r], tris_t[r])
        assert not torch.equal(got, tris_t)


def test_state_file_keeps_the_clock(tmp_path):
    s = GlobalSettings(scene="demo", render_width=32, render_height=16,
                       dynamic_resolution=DynamicResolution(enabled=False))
    flags = FeatureFlags(denoise=False)
    eng = Engine(s, flags=flags, device="cpu")
    t = 0.0
    for _ in range(777):
        t = TF.advance_clock(t, 1 / 60)
    eng.state.time = t
    path = str(tmp_path / "state.npz")
    eng.save_state(path)
    other = Engine(s, flags=flags, device="cpu")
    other.load_state(path)
    assert other.state.time == t
    assert np.float32(other.state.time).tobytes() == np.float32(t).tobytes()
