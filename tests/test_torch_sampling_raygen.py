"""Counter-based RNG and raygen: port == JAX.

hash_pcg / rand2 / rand2_bn / blue_offsets_flat are BIT-EXACT (the port's
uint32 math runs in masked int64 and must reproduce every bit).  Rays from
generate_rays_padded agree to atol 1e-6: the camera basis, ray normalize and
the trigonometry of the thin-lens disk go through different float32 kernels
(XLA vs torch), which may round the last bit differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.core.camera import camera_basis as jbasis
from rtrt_tpu.core.camera import make_camera as jcam
from rtrt_tpu.render import raygen as JR
from rtrt_tpu.render import sampling as JSmp
from rtrt_tpu_torch.core.camera import camera_basis as tbasis
from rtrt_tpu_torch.render import raygen as TR
from rtrt_tpu_torch.render import sampling as TSmp
from rtrt_tpu_torch.utils.interop import camera_from_jax

torch.set_num_threads(1)
N = 4096


@pytest.fixture(scope="module")
def ints():
    rng = np.random.default_rng(3)
    return rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)


def test_hash_pcg_bit_exact(ints):
    ref = np.asarray(JSmp.hash_pcg(jnp.asarray(ints)))
    got = TSmp.hash_pcg(torch.from_numpy(ints.astype(np.int64)))
    np.testing.assert_array_equal(ref, got.numpy().astype(np.uint32))


@pytest.mark.parametrize("frame,dim", [(0, 0), (7, 4), (123456, 256),
                                      (2 ** 32 - 1, 194)])
def test_rand2_bit_exact(frame, dim):
    pix = np.arange(N, dtype=np.int32) * 37
    ref = np.asarray(JSmp.rand2(jnp.asarray(pix), jnp.uint32(frame),
                                jnp.uint32(dim)))
    got = TSmp.rand2(torch.from_numpy(pix), frame, dim).numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("frame,dim", [(0, 0), (5, 256), (99, 130)])
def test_rand2_bn_and_offsets_bit_exact(frame, dim):
    w, h = 97, 70
    ref_off = JSmp.blue_offsets_flat(w, h, w * h + 5)
    got_off = TSmp.blue_offsets_flat(w, h, w * h + 5)
    np.testing.assert_array_equal(ref_off, got_off)
    ref = np.asarray(JSmp.rand2_bn(jnp.asarray(ref_off), jnp.uint32(frame),
                                   jnp.uint32(dim)))
    got = TSmp.rand2_bn(torch.from_numpy(got_off), frame, dim).numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_generate_rays_padded(aperture):
    w, h = 40, 24
    cam = jcam(pos=(0.5, 3.0, -9.0), yaw=0.3, pitch=-0.15, fov_y=1.1,
               aperture=aperture, focal_dist=6.0)
    pix = np.minimum(np.arange(w * h + 17, dtype=np.int32), w * h - 1)
    bn = JSmp.blue_offsets_flat(w, h, w * h + 17)
    jit_j = JSmp.rand2_bn(jnp.asarray(bn), jnp.uint32(3), jnp.uint32(0))
    lens_j = JSmp.rand2_bn(jnp.asarray(bn), jnp.uint32(3), jnp.uint32(256))
    ref = JR.generate_rays_padded(jbasis(cam), w, h, jnp.asarray(pix),
                                  jit_j, lens_j)
    got = TR.generate_rays_padded(
        tbasis(camera_from_jax(cam, "cpu")), w, h, torch.from_numpy(pix),
        torch.from_numpy(np.array(jit_j)),
        torch.from_numpy(np.array(lens_j)))
    for f in ("org", "dir", "uv", "cone_width"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                   getattr(got, f).numpy(), atol=1e-6,
                                   err_msg=f)
