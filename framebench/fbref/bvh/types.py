# Frozen copy of rtrt_tpu_torch/bvh/types.py
# (framebench's plain reference).
"""BVH table layout and stack-entry encoding (port of rtrt_tpu/bvh/types.py).

Stack entries (int32), as in the JAX package:

    bits  0..10  node index within its level, or a BLAS leaf's index
    bits 11..21  batch index (<= 1023)
    bit  22      is_blas
    bit  23      is_leaf (a leaf's triangle base slot = batch * 1024 + idx)
    -1           empty child slot

The two trees the port traverses use it so:
  * the flat SAH tree of a static scene (bvh/sah.py): internal -> node id
    in bits 0..21 (is_blas clear); leaf -> LEAF_BIT | slot's batch and
    index;
  * the two-level LBVH (bvh/build.py): TLAS rows first, then the BLAS
    rows of every batch.  A TLAS node is its row (batch 0, is_blas
    clear); a BLAS node is row tlas_internal + batch * BLAS_NODES + idx;
    a TLAS leaf is pre-resolved to its batch's BLAS root, so traversal
    never meets one; a BLAS leaf holds GROUP = 1 triangle.
"""

from __future__ import annotations

import dataclasses

import torch

BATCH_SIZE = 1024          # triangles per batch of the padded scene arrays
GROUP = 1                  # triangles per binary-tree leaf entry
GROUPS_PER_BATCH = BATCH_SIZE // GROUP
BLAS_NODES = GROUPS_PER_BATCH - 1   # internal nodes of one batch's BLAS
_IDX_BITS = 11
_BATCH_SHIFT = 11
_IDX_MASK = (1 << _IDX_BITS) - 1
_BATCH_MASK = (1 << 11) - 1
_BLAS_BIT = 1 << 22
_LEAF_BIT = 1 << 23


def _flag(x, bit):
    """`bit` where x holds: a bool tensor's int64 bits, or a Python bool's
    (a constant, never copied to the device)."""
    return x.to(torch.int64) * bit if torch.is_tensor(x) else bit * bool(x)


def pack_entry(idx, batch, is_blas, is_leaf):
    """Packed int64 entries of an integer tensor idx, an integer tensor or
    int batch and bool tensors or bools is_blas / is_leaf."""
    e = (idx.to(torch.int64) & _IDX_MASK) \
        | ((batch & _BATCH_MASK) << _BATCH_SHIFT)
    return e | _flag(is_blas, _BLAS_BIT) | _flag(is_leaf, _LEAF_BIT)


def entry_idx(e):
    return e & _IDX_MASK


def entry_batch(e):
    return (e >> _BATCH_SHIFT) & _BATCH_MASK


def entry_slot(e):
    """Triangle base slot of a leaf entry (ints or integer tensors)."""
    return ((e >> _BATCH_SHIFT) & _BATCH_MASK) * BATCH_SIZE + (e & _IDX_MASK)


@dataclasses.dataclass
class SceneBvh:
    """A BVH over the sorted triangle soup: the flat binary SAH tree of a
    static scene (bvh/sah.py), or the two-level LBVH (bvh/build.py), whose
    rows are the B - 1 TLAS nodes, then BLAS_NODES rows for each of the B
    batches (entries: see the module docstring).

    Column-major tables as in the JAX SceneBvh, held as torch tensors:
      boxes_t (12, M) f32 child AABB pairs [Llo, Lhi, Rlo, Rhi]
      children_t (2, M) i32 packed child entries
      tris_t (9, P) f32 sorted [v0 | v1 | v2]
      sorted_tri_index (P,) i32 sorted slot -> original triangle id
      root_lo, root_hi (3,) f32 the scene's box
    """

    boxes_t: torch.Tensor
    children_t: torch.Tensor
    tris_t: torch.Tensor
    sorted_tri_index: torch.Tensor
    root_lo: torch.Tensor
    root_hi: torch.Tensor


    @property
    def num_batches(self) -> int:
        return self.tris_t.shape[1] // BATCH_SIZE

    @property
    def tlas_internal(self) -> int:
        """TLAS rows of a two-level tree (B - 1)."""
        return self.boxes_t.shape[1] - self.num_batches * BLAS_NODES
