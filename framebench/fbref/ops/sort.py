# Frozen copy of rtrt_tpu_torch/ops/sort.py
# (framebench's plain reference).
"""Batched key sorting (port of rtrt_tpu/ops/sort.py).

Keys are int64 tensors holding uint32 values; padding slots carry PAD_KEY
(0xFFFFFFFF) and sort last.  JAX sorts on two keys, the code and then the
in-batch index, so that ties come out in index order; here ONE torch.sort
of the composite key (code << bits) | index gives the same order (every
composite is distinct, so the sort's stability does not matter).
"""

from __future__ import annotations

import torch

PAD_KEY = 0xFFFFFFFF


def sort_key_index(keys):
    """Sort (..., N) keys along the last axis; also return the gather
    indices (`reorder`, int64) mapping sorted position -> original
    position, ties in index order."""
    n = keys.shape[-1]
    bits = max(1, (n - 1).bit_length())
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    comp, _ = torch.sort((keys.to(torch.int64) << bits) | idx, dim=-1)
    return comp >> bits, comp & ((1 << bits) - 1)
