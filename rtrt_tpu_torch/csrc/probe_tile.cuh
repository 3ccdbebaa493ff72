// The one-barrier tile reduction of K6 (probe_step.cu), K7 (probe_leaf.cu)
// and K8 / K9 (probe_cores.cu).  Of K10-K16, only K14 reduces over its
// tile (an int32 min: probe_common.cuh::block_min_int).
//
// A tile-wide min or max of N values a thread: each warp reduces its lanes
// with shuffles; lane r * N + n of each warp stores the warp's n-th partial
// into slot n of block r's shared memory; every block waits once; then
// every warp reads all the partials, one or two a lane, and reduces them
// with shuffles again, so that every thread holds the tile's result and
// every branch on it is uniform.  A min or max does not depend on the order
// of its operands, so the result is the two-barrier reduction's.
//
// A lone block stores into its own slots and waits at __syncthreads.  A
// thread-block cluster sends each partial to block r with st.async, which
// counts its bytes on block r's mbarrier (complete_tx), and each block
// waits on its own mbarrier until all c x warps x N partials have landed:
// no fence and no cluster barrier a call.  (The cluster barrier,
// barrier.cluster.arrive.release / wait.acquire, compiles to a GPU-scope
// MEMBAR before the arrive, which waits for every load in flight, and an
// L1 invalidation after the wait: in K6's reduce2 it cost 0.96 us a
// reduction on 4 SMs and 0.93 on one, against 0.56 for this exchange on 4
// SMs and 0.38 for __syncthreads on one, on an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md, K6.)
//
// The slots are double-buffered: call i writes buffer i & 1.  Call i + 2
// writes it again only after the writer has passed call i + 1, and so has
// received call i + 1's partials from every warp of the cluster, each sent
// after that warp had read call i's.  So one wait a call guards both the
// exchange and the reuse.  Each buffer has its own mbarrier, whose phase
// flips at each use: call i waits for parity (i >> 1) & 1 of mbarrier i & 1.
#pragma once

#include <cooperative_groups.h>

#include "probe_common.cuh"

namespace probe {

constexpr int TILE_MAX_N = 4;
// partials a value: up to 16 warps x 4 blocks (K6), or 32 warps x 1 (K7,
// K8)
constexpr int TILE_SLOTS = 64;
constexpr int TILE_RED_FLOATS = 2 * TILE_MAX_N * TILE_SLOTS;

// the reduction's shared slots (TILE_RED_FLOATS floats), the two
// mbarriers of the cluster form, and the calls made so far
struct TileRed {
  float* slots;
  unsigned long long* bars;
  int calls;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Before the first call of the cluster form: every thread of every block
// of the cluster calls it (the mbarriers are ready before any block sends)
__device__ __forceinline__ void tile_cluster_init(const TileRed& r) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(r.bars + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cooperative_groups::this_cluster().sync();
}

template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int n) {
  float x = v[0];  // a select chain: a dynamic index would go to memory
#pragma unroll
  for (int i = 1; i < N; ++i) x = n == i ? v[i] : x;
  return x;
}

// First half: the warp's partials go out -- work that does not need the
// result may follow before tile_take
template <int N, bool kMax, bool kCluster>
__device__ __forceinline__ void tile_post(float (&v)[N], const TileRed& r) {
  static_assert(N <= TILE_MAX_N, "tile_post: at most TILE_MAX_N values");
  warp_reduce<N, kMax>(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = r.slots + (r.calls & 1) * (TILE_MAX_N * TILE_SLOTS);
  if constexpr (kCluster) {
    namespace cg = cooperative_groups;
    const cg::cluster_group cl = cg::this_cluster();
    const int nb = static_cast<int>(cl.num_blocks());
    const unsigned bar = smem_addr(r.bars + (r.calls & 1));
    if (threadIdx.x == 0)  // this block's mbarrier expects every partial
      asm volatile(
          "{\n.reg .b64 st;\n"
          "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
              bar),
          "r"(nb * (blockDim.x >> 5) * N * 4)
          : "memory");
    if (lane < nb * N) {
      const int p = static_cast<int>(cl.block_rank()) * (blockDim.x >> 5) +
                    warp;
      const unsigned rank = lane / N;
      unsigned dst, dbar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(dst)
                   : "r"(smem_addr(buf + (lane % N) * TILE_SLOTS + p)),
                     "r"(rank));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(dbar)
                   : "r"(bar), "r"(rank));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
          "%1, [%2];\n" ::"r"(dst),
          "r"(__float_as_uint(pick(v, lane % N))), "r"(dbar)
          : "memory");
    }
  } else {
    if (lane < N) buf[lane * TILE_SLOTS + warp] = pick(v, lane);
  }
}

// Second half: the wait, then every warp reduces the partials
template <int N, bool kMax, bool kCluster>
__device__ __forceinline__ void tile_take(float (&v)[N], TileRed& r) {
  const float id = kMax ? -CUDART_INF_F : CUDART_INF_F;
  const int lane = threadIdx.x & 31;
  int parts = blockDim.x >> 5;
  if constexpr (kCluster) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" ::"r"(smem_addr(r.bars + (r.calls & 1))),
        "r"((r.calls >> 1) & 1)
        : "memory");
    parts *= static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  } else {
    __syncthreads();
  }
  const float* buf = r.slots + (r.calls & 1) * (TILE_MAX_N * TILE_SLOTS);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float x = lane < parts ? buf[n * TILE_SLOTS + lane] : id;
    if constexpr (kCluster) {  // more than 32 partials only on a cluster
      const float y = lane + 32 < parts ? buf[n * TILE_SLOTS + lane + 32] : id;
      x = kMax ? fmaxf(x, y) : fminf(x, y);
    }
    v[n] = x;
  }
  warp_reduce<N, kMax>(v);
  ++r.calls;
}

template <int N, bool kMax, bool kCluster>
__device__ __forceinline__ void tile_reduce(float (&v)[N], TileRed& r) {
  tile_post<N, kMax, kCluster>(v, r);
  tile_take<N, kMax, kCluster>(v, r);
}

}  // namespace probe
