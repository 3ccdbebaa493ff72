# Frozen copy of rtrt_tpu_torch/ops/gather.py
# (framebench's plain reference).
"""Batched permutation gather (port of rtrt_tpu/ops/gather.py).

On a TPU a general gather runs near-serially, so the JAX package permutes
with a one-hot matrix product on the MXU.  On the card an index gather is
the natural form, and it is exact for any values (the one-hot product
needs finite values and integers below 2^24).  The name stays, so that a
reader finds the counterpart.
"""

from __future__ import annotations

import torch


def onehot_permute(values, idx):
    """out[b, m] = values[b, idx[b, m]]: values (B, N, C), idx (B, M)
    integer indices into axis 1 -> (B, M, C)."""
    return torch.gather(values, 1, idx.to(torch.int64).unsqueeze(-1).expand(
        -1, -1, values.shape[-1]))
