// The one-wait tile reduction of K6 (probe_step.cu), K7 (probe_leaf.cu),
// K8 / K9 (probe_cores.cu) and K14 (probe_record.cu).  K6-K9 reduce
// float32 values; K14 takes the int32 min of its pend, with redux
// (__reduce_min_sync) as the warp step: an int32 min stays exact at every
// magnitude and orders negative values right, which a float reduction of
// the same bits would not.
//
// A tile-wide min or max of N values a thread: each warp reduces its lanes
// with shuffles (float) or redux (int32); lane r * N + n of each warp
// stores the warp's n-th partial into slot n of block r's shared memory;
// every block waits once; then every warp reads all the partials, one or
// two a lane, and reduces them the same way again, so that every thread
// holds the tile's result and every branch on it is uniform.  A min or max
// does not depend on the order of its operands, so the result is the
// two-barrier reduction's.
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
// partials a value: up to 16 warps x 4 blocks (K6, K14), or 32 warps x 1
// (K7, K8)
constexpr int TILE_SLOTS = 64;
// 32-bit words (float or int32 partials)
constexpr int TILE_RED_FLOATS = 2 * TILE_MAX_N * TILE_SLOTS;

// the reduction's shared slots (TILE_RED_FLOATS words), the two
// mbarriers of the cluster form, and the calls made so far
struct TileRed {
  float* slots;
  unsigned long long* bars;
  int calls;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The element type's pieces: the min or max of two values, its identity,
// and its 32 bits for st.async
template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : fminf(a, b);
}
template <bool kMax>
__device__ __forceinline__ int combine(int a, int b) {
  return kMax ? max(a, b) : min(a, b);
}
template <typename T, bool kMax>
__device__ __forceinline__ T identity();
template <>
__device__ __forceinline__ float identity<float, false>() {
  return CUDART_INF_F;
}
template <>
__device__ __forceinline__ float identity<float, true>() {
  return -CUDART_INF_F;
}
template <>
__device__ __forceinline__ int identity<int, false>() {
  return 0x7fffffff;
}
template <>
__device__ __forceinline__ int identity<int, true>() {
  return static_cast<int>(0x80000000u);
}
__device__ __forceinline__ unsigned bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned bits(int x) {
  return static_cast<unsigned>(x);
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

template <int N, typename T>
__device__ __forceinline__ T pick(const T (&v)[N], int n) {
  T x = v[0];  // a select chain: a dynamic index would go to memory
#pragma unroll
  for (int i = 1; i < N; ++i) x = n == i ? v[i] : x;
  return x;
}

// First half: the warp's partials go out -- work that does not need the
// result may follow before tile_take
template <int N, bool kMax, bool kCluster, typename T>
__device__ __forceinline__ void tile_post(T (&v)[N], const TileRed& r) {
  static_assert(N <= TILE_MAX_N, "tile_post: at most TILE_MAX_N values");
  warp_reduce<N, kMax>(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* buf = reinterpret_cast<T*>(r.slots) +
           (r.calls & 1) * (TILE_MAX_N * TILE_SLOTS);
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
          "r"(bits(pick(v, lane % N))), "r"(dbar)
          : "memory");
    }
  } else {
    if (lane < N) buf[lane * TILE_SLOTS + warp] = pick(v, lane);
  }
}

// Second half: the wait, then every warp reduces the partials
template <int N, bool kMax, bool kCluster, typename T>
__device__ __forceinline__ void tile_take(T (&v)[N], TileRed& r) {
  const T id = identity<T, kMax>();
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
  const T* buf = reinterpret_cast<const T*>(r.slots) +
                 (r.calls & 1) * (TILE_MAX_N * TILE_SLOTS);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    T x = lane < parts ? buf[n * TILE_SLOTS + lane] : id;
    if constexpr (kCluster) {  // more than 32 partials only on a cluster
      const T y = lane + 32 < parts ? buf[n * TILE_SLOTS + lane + 32] : id;
      x = combine<kMax>(x, y);
    }
    v[n] = x;
  }
  warp_reduce<N, kMax>(v);
  ++r.calls;
}

template <int N, bool kMax, bool kCluster, typename T>
__device__ __forceinline__ void tile_reduce(T (&v)[N], TileRed& r) {
  tile_post<N, kMax, kCluster>(v, r);
  tile_take<N, kMax, kCluster>(v, r);
}

// Host side: `blocks` blocks of `threads` threads in clusters of
// `cluster` (K6, K8 / K9, K14), `smem` bytes of dynamic shared memory a
// block; the launch's error, else cudaGetLastError()
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int blocks,
                           int cluster, int threads, size_t smem,
                           cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace probe
