# Frozen copy of rtrt_tpu_torch/ops/reduce.py
# (framebench's plain reference).
"""Range reductions without atomics (port of rtrt_tpu/ops/reduce.py).

Every internal node of a Karras LBVH covers a contiguous range of sorted
leaves, so a doubling sparse table of minima / maxima turns each node's box
into two O(1) range lookups: exact (min / max are idempotent, so the two
overlapping blocks are fine) and data-parallel.
"""

from __future__ import annotations

import torch


def bit_length(x, bits: int = 32):
    """Bit length of each integer of x in [0, 2^bits), by integer compares
    (torch has no clz): the count of powers 2^0 .. 2^(bits-1) at or below
    x.  Exact for every value, unlike a float log2."""
    pw = 2 ** torch.arange(bits, dtype=torch.int64, device=x.device)
    return (x.to(torch.int64).unsqueeze(-1) >= pw).sum(-1)


def build_minmax_table(values_lo, values_hi):
    """Doubling sparse tables for range-min of `values_lo` and range-max of
    `values_hi` over the second-to-last axis.

    values_lo/hi: (..., N, C).  Returns (lo_table, hi_table), each
    (L, ..., N, C) with L = floor(log2 N) + 1;
    lo_table[k, ..., i] = min(values_lo[..., i : i + 2^k]) (clamped at N).
    """
    n = values_lo.shape[-2]
    levels = max(1, n.bit_length())
    lo_t, hi_t = [values_lo], [values_hi]
    for k in range(1, levels):
        off = 1 << (k - 1)
        prev_lo, prev_hi = lo_t[-1], hi_t[-1]
        # shift by `off` along the N axis; out of range pads with identity
        pad_lo = torch.full_like(prev_lo[..., :off, :], float("inf"))
        pad_hi = torch.full_like(prev_hi[..., :off, :], float("-inf"))
        lo_t.append(torch.minimum(
            prev_lo, torch.cat([prev_lo[..., off:, :], pad_lo], dim=-2)))
        hi_t.append(torch.maximum(
            prev_hi, torch.cat([prev_hi[..., off:, :], pad_hi], dim=-2)))
    return torch.stack(lo_t, dim=0), torch.stack(hi_t, dim=0)


def range_minmax(lo_table, hi_table, first, last):
    """Range min / max over inclusive index ranges [first, last].

    lo_table/hi_table: (L, ..., N, C) from build_minmax_table; first, last:
    (..., Q) integer tensors with first <= last and the tables' batch dims
    (none for one table, as the JAX function; the JAX package vmaps over
    batches).  Returns (lo, hi): (..., Q, C).
    """
    span = last - first + 1
    k = bit_length(span, lo_table.shape[0]) - 1  # floor(log2(span))
    second = last - (1 << k) + 1
    nb = first.dim() - 1
    batch = tuple(torch.arange(s, device=first.device).reshape(
        (1,) * i + (s,) + (1,) * (nb - i)) for i, s in enumerate(
            first.shape[:-1]))
    lo = torch.minimum(lo_table[(k,) + batch + (first,)],
                       lo_table[(k,) + batch + (second,)])
    hi = torch.maximum(hi_table[(k,) + batch + (first,)],
                       hi_table[(k,) + batch + (second,)])
    return lo, hi


def segment_sum(data, segment_ids, num_segments: int):
    """Sum of the rows of `data` (N, ...) into `num_segments` rows by
    segment id (jax.ops.segment_sum; here index_add_, whose additions run
    in another order on the card: sums agree to float32 rounding, not
    bit for bit)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.to(torch.int64), data)
