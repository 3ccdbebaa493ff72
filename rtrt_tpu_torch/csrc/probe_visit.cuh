// The leaf visit of K7 (probe_leaf.cu) and K8 / K9 (probe_cores.cu): one
// device function, so that the two probes cannot drift apart.
//
// A visit tests the tile's rays against the 8 triangle records of one row
// (Moller-Trumbore, probe_common.cuh::tri_hit, against each lane's best
// so far), keeps each lane's nearest accepted hit (and, for K8, its
// record slot), updates best, and takes the tile-wide max of the new best
// as the prune bound with probe_tile.cuh's one-barrier reduction.  A
// record (9 floats at a 16-float stride, 64-byte aligned) is two 16-byte
// loads and one scalar load from global memory (L1): every thread reads
// the same row, so each load is one request a warp.
//
// K7's stripped modes are forms of the same visit: literal records
// (LEAF_LITERAL: record values replaced by constants, the same math), a
// 7-product sum in place of the test (LEAF_NOMATH), 2 records in place of
// 8 (kNrec), no tile-wide max (kReduce false).
#pragma once

#include "probe_tile.cuh"

namespace probe {

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

enum LeafForm { LEAF_FULL, LEAF_LITERAL, LEAF_NOMATH };

// record rec of a row: two 16-byte loads and one scalar
__device__ __forceinline__ void record(const float* __restrict__ row,
                                       int rec, float (&v)[9]) {
  const float* p = row + 16 * rec;
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  v[8] = __ldg(p + 8);
}

// The visit of `row` (records base .. base + kNrec - 1): best per lane and,
// with kSlot, the record slot of each lane's best in tri (base + record;
// during the visit each lane's record index is a 4-bit field of one
// register, not a register a lane); bound = the tile-wide max of best
// (with kReduce; over a thread-block cluster with kCluster)
template <int L, int kNrec, int kForm, bool kReduce, bool kSlot,
          bool kCluster = false>
__device__ __forceinline__ void leaf_visit(const float* __restrict__ row,
                                           int base, const Ray (&r)[L],
                                           float (&best)[L], int (&tri)[L],
                                           float& bound, TileRed& red) {
  static_assert(!kSlot || (L <= 8 && kNrec <= 16), "4-bit slot fields");
  float gt[L];
  unsigned gi = 0;  // lane j's record: bits 4j .. 4j + 3
#pragma unroll
  for (int j = 0; j < L; ++j) gt[j] = CUDART_INF_F;
#pragma unroll
  for (int rec = 0; rec < kNrec; ++rec) {
    float v[9];
    if constexpr (kForm == LEAF_LITERAL) {
      const float lit[9] = {0.1f, 0.2f, 0.3f, 1.0f, 0.0f, 0.1f,
                            0.0f, 1.0f, 0.1f};
#pragma unroll
      for (int c = 0; c < 9; ++c) v[c] = lit[c];
    } else {
      record(row, rec, v);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float tt;
      bool ok;
      if constexpr (kForm == LEAF_NOMATH) {
        tt = mul(r[j].ox, v[0]) + mul(r[j].oy, v[1]) + mul(r[j].oz, v[2]) +
             mul(r[j].dx, v[3]) + mul(r[j].dy, v[4]) + mul(r[j].dz, v[5]) +
             v[6];
        ok = tt > 0.5f;
      } else {
        ok = tri_hit(v, r[j].ox, r[j].oy, r[j].oz, r[j].dx, r[j].dy,
                     r[j].dz, best[j], tt);
      }
      if (ok && tt < gt[j]) {
        gt[j] = tt;
        if constexpr (kSlot)
          gi = (gi & ~(0xFu << (4 * j))) | (unsigned(rec) << (4 * j));
      }
    }
  }
  float m[1] = {-CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool better = gt[j] < best[j];
    best[j] = better ? gt[j] : best[j];
    if constexpr (kSlot)
      tri[j] = better ? base + static_cast<int>((gi >> (4 * j)) & 0xFu)
                      : tri[j];
    m[0] = fmaxf(m[0], best[j]);
  }
  if constexpr (kReduce) {
    tile_reduce<1, true, kCluster>(m, red);
    bound = m[0];
  }
}

}  // namespace probe
