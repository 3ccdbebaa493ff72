"""The yardstick of the kernels' roofline shares: the card's peaks, the bound
arithmetic, and each counted kernel's operations and bytes from the cell's
shapes and its configuration's constants.

Peaks and `bound_ms` are frozen copies of rtrt_tpu_torch/utils/timing.py
(HBM_BPS, F32_OPS, `bound_ms`): the H100 SXM data sheet at its 700 W
limit.  The per-visit and per-hit operation counts are frozen copies of
chip_smoke.py's (NODE_OPS, LEAF_OPS, NODE2_OPS, LEAF2_OPS, SURF_OPS,
SOIL_OPS, BSDF_OPS), counted from csrc/ at the time of the copy; K4's
44 bytes a pixel a pass is the count in the header of
rtrt_tpu_torch/csrc/denoise_wide.cu.  Nothing here is read from the
program at run time, so a kernel's share reads the same work whatever
implements it.
"""

from __future__ import annotations

# H100 SXM data sheet, at its 700 W limit: device memory bytes per second
# and float32 operations per second outside the tensor cores (an FMA counts
# as two)
HBM_BPS = 3.35e12
F32_OPS = 67e12


def bound_ms(nbytes: float, ops: float, share: float = 1.0,
             rate: float = F32_OPS):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over `rate`, both scaled by `share`, the
    fraction of the card's SMs the launch can fill."""
    t_b = nbytes / (HBM_BPS * share) * 1e3
    t_o = ops / (rate * share) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# K2's traversal: a BVH4 node visit is 4 slab tests of 20 plus the
# 5-comparator sort and the prune test; a BVH4 leaf visit 8
# Moller-Trumbore tests of 59.  A binary (two-level LBVH) node visit is 2
# slab tests of 20 plus the near / far choice and the prune test; a binary
# leaf visit one Moller-Trumbore test.
VISIT_OPS = {"bvh4": (86, 8 * 59), "binary": (2 * 20 + 4, 59)}
# K2's shading per hit: surface interaction, procedural soil of a textured
# hit (13 fbm octaves of 208 and ~90 of colour and bump), BSDF and sun
# sampling of a sampled hit plus 3 blue-noise rotations of 12
SURF_OPS, SOIL_OPS, BSDF_OPS = 109, 13 * 208 + 90, 264 + 3 * 12
# K2's bytes a pixel: ray, cone, pixel id and blue-noise pair in (40), 18
# float planes out (72)
K2_PX_BYTES = 40 + 72
# K4, one joint-bilateral pass: 8 words in and 3 out a pixel (44 B); its
# operations (25 taps of 21 and 10 a pixel) stay under the bytes' time
K4_PX_BYTES = 44
K4_PX_OPS = 25 * 21 + 10


def k2_bound_ms(pixels: int, counts: dict):
    """K2's bound for one frame of `pixels` primary paths.  counts: the
    configuration's `k2_counts`: the tree's kind ("bvh4" or "binary"), node
    and leaf visits, shaded, textured and sampled hits, each a mean per
    pixel over all segments, and the tables' bytes."""
    node, leaf = VISIT_OPS[counts["tree"]]
    ops = pixels * (counts["node_visits"] * node
                    + counts["leaf_visits"] * leaf
                    + counts["shaded_hits"] * SURF_OPS
                    + counts["textured_hits"] * SOIL_OPS
                    + counts["sampled_hits"] * BSDF_OPS)
    return bound_ms(pixels * K2_PX_BYTES + counts["table_bytes"], ops)


def k4_pass_bound_ms(pixels: int):
    """One K4 pass's bound at `pixels` pixels."""
    return bound_ms(pixels * K4_PX_BYTES, pixels * K4_PX_OPS)
