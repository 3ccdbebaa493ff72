"""BVH table layout and stack-entry encoding (port of rtrt_tpu/bvh/types.py).

The flat SAH tree of a static scene uses the JAX package's entry encoding:

    internal -> node id in bits 0..21
    leaf     -> LEAF_BIT | (slot // 1024) << 11 | (slot % 1024)
                (decodes to triangle base slot = batch * 1024 + idx)
    -1       -> empty child slot
"""

from __future__ import annotations

import dataclasses

import torch

BATCH_SIZE = 1024          # triangles per batch of the padded scene arrays
GROUP = 1                  # triangles per binary-tree leaf entry
_IDX_BITS = 11
_BATCH_SHIFT = 11
_IDX_MASK = (1 << _IDX_BITS) - 1
_BATCH_MASK = (1 << 11) - 1
_BLAS_BIT = 1 << 22
_LEAF_BIT = 1 << 23
ENTRY_INVALID = -1


def entry_slot(e):
    """Triangle base slot of a leaf entry (ints or integer tensors)."""
    return ((e >> _BATCH_SHIFT) & _BATCH_MASK) * BATCH_SIZE + (e & _IDX_MASK)


@dataclasses.dataclass
class SceneBvh:
    """Flat binary SAH tree over the sorted triangle soup.

    Column-major tables as in the JAX SceneBvh, held as torch tensors:
      boxes_t (12, M) f32 child AABB pairs [Llo, Lhi, Rlo, Rhi]
      children_t (2, M) i32 packed child entries
      tris_t (9, P) f32 sorted [v0 | v1 | v2]
      sorted_tri_index (P,) i32 sorted slot -> original triangle id
    """

    boxes_t: torch.Tensor
    children_t: torch.Tensor
    tris_t: torch.Tensor
    sorted_tri_index: torch.Tensor
    root_lo: torch.Tensor
    root_hi: torch.Tensor

    def to(self, device) -> "SceneBvh":
        return SceneBvh(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))
