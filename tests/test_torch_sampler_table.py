"""The megakernel's per-launch sampler table (render/kshade.py:
sampler_table, bn_rotate; csrc/kshade.cuh: sampler_entry, bn_rotate): the
blue-noise pair split into the part shared by a launch, (u1, u2, sx, sy) of
(frame, dim), and the per-pixel rotation, held bit for bit to the JAX
rand2_bn_c (rtrt_tpu/render/kshade.py), which computes both per pixel.
Seeded numpy mask offsets, all 20 dims of the table, several frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.render import kshade as JK
from rtrt_tpu.render.sampling import _dim_shift as j_dim_shift
from rtrt_tpu_torch.render import kshade as TK
from rtrt_tpu_torch.render.kshade import SAMPLER_SEGS as SEGMENTS

torch.set_num_threads(1)


def test_sampler_dims_are_the_megakernels():
    dims = TK.sampler_dims(SEGMENTS)
    assert dims == [b + 2 * s for b in (2, 64, 128, 192)
                    for s in range(SEGMENTS)]
    assert len(set(dims)) == 20


@pytest.mark.parametrize("frame", [0, 1, 77, 4093, 2 ** 31 + 5])
def test_sampler_table_split_matches_jax(frame):
    rng = np.random.default_rng(frame % 9973)
    bn = rng.uniform(0.0, 1.0, (2048, 2)).astype(np.float32)
    bn[:4] = [[0.0, 0.0], [0.99999994, 0.5], [0.5, 0.99999994],
              [0.25, 0.75]]
    table = TK.sampler_table(frame, SEGMENTS)
    assert table.dtype == torch.float32 and table.shape == (4 * SEGMENTS, 4)
    tb = torch.from_numpy(bn)
    for k, dim in enumerate(TK.sampler_dims(SEGMENTS)):
        # the shared part: the sequence's pair at pixel 0 and the shift
        u1, u2 = JK.rand2_c(jnp.uint32(0), jnp.uint32(frame), jnp.uint32(dim))
        sx, sy = j_dim_shift(jnp.uint32(dim))
        want = np.array([u1, u2, sx, sy], dtype=np.float32)
        np.testing.assert_array_equal(table[k].numpy(), want)
        # the rotation of every pixel
        jx, jy = JK.rand2_bn_c(jnp.asarray(bn[:, 0]), jnp.asarray(bn[:, 1]),
                               jnp.uint32(frame), jnp.uint32(dim))
        tx, ty = TK.bn_rotate(table[k].tolist(), tb[:, 0], tb[:, 1])
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        assert float(tx.min()) >= 0.0 and float(tx.max()) < 1.0
