// K14, K15: where a record's values come from.
//
// K14 replaces tools/probe_broadcast.py::make_kernel (pallas_call at
// probe_broadcast.py:88).  Each step takes cand = the tile-wide int32 min
// of pend, reads the 13 values of record i = cand & 1023, adds them on the
// lanes where pend == cand (13 carried planes) and sets those pend to
// 2^30; out = ((acc0 + acc1) + ... + acc12) + float(pend).  The modes are
// the two record layouts (the TPU's lane roll and lane broadcast are TPU
// machinery; on Hopper both are uniform loads):
//   EXTRACT  AoS: value v at tab[16 i + v], 13 values in one 64-byte span,
//            read as three 16-byte loads and one 4-byte load
//   BCAST16  SoA: value v at ttab[(i / 128) * 16 + v][i % 128], 13 values
//            in 13 rows 512 bytes apart
// What bounds it on the H100: ~29 operations per lane per step (compare,
// 13 adds and 13 selects, the pend select, the lane's share of the min) on
// the SMs that hold the tile, and the tile-wide min that each step waits
// for.  On one SM a 64-row tile cannot keep its state in registers (8,192
// lanes x 14 words against 65,536 registers): the one-block port spilled.
// Design: the tile is split over a thread-block cluster of c blocks, the
// smallest c of 1, 2, 4 with rows <= BCAST_MAX_BLOCK_ROWS c
// (tools/probe_broadcast.py::launch_geometry, which passes c; K6's rule),
// one block an SM, BCAST_L = 8 lanes a thread (8 warps of 139-143
// registers a block at 16 rows, no spill; of 2, 4 and 8 lanes, and 2
// blocks of 32 rows at 8, which spills, 8 was the fastest in both modes
// on an NVIDIA H100 80GB HBM3 at 700 W: PERF.md, K14).  The min goes
// through probe_tile.cuh's one-wait reduction in int32 (redux a warp,
// then st.async into every block's slots counted on its mbarrier; a lone
// block: a store and __syncthreads), and it overlaps the adds: once
// cand arrives, each lane computes its hit, its new pend and the local min
// of the new pend, posts that min (tile_post), then does the 13 adds of
// the record (loaded first), and only then takes the next cand
// (tile_take).  The adds do not feed the min, so the function and its bits
// are the plain version's.  Every lane does its compare, its 13 selected
// adds and its pend select every step, as LANE_OPS counts them: no warp
// skips the adds where none of its lanes hits.
//
// K15 replaces tools/probe_xpose.py::make_kernel (probe_xpose.py:107).
// Each step visits row (7 (k & 127)) % 120 of tab (the tool's stack[k %
// 128], stack[i] = (7 i) % 120): 8 Moller-Trumbore tests without the tmin
// test, best = min(best, nearest accepted t).  The modes compute the same
// function and must agree bit for bit; they differ in how a row's 72
// values reach every lane (the TPU's transpose and outer product has no
// meaning on Hopper):
//   EXTRACT  every thread loads each record itself: two 16-byte loads and
//            one 4-byte load, 24 uniform loads a step (L1 hits)
//   XPOSE    each warp loads the 128-float row once, coalesced (a float4
//            per lane), and broadcasts each value with __shfl_sync
// t = tq * (1 / det) of a record is computed only on the lanes that
// accept it (probe_common.cuh::tri_hit_no_tmin); a warp where none does
// skips the reciprocal, as ~88% of them do a record on the tool's inputs.
// What bounds it: ~465 float operations per lane per visit on the SMs the
// tile fills.  Design: no lane reads another (best is per lane, the row a
// step a constant of k), so the tile splits over c = rows / 8 plain
// blocks (tools/probe_xpose.py::launch_geometry: 4 at 32 rows), one an SM
// (GUARD_SMEM bytes of untouched dynamic shared memory a block, as K16's),
// XPOSE_L = 1 lane a thread (of 1, 2 and 4, none of which spills, 1 was
// the fastest in both modes: 32 warps an SM hide the test's dependent
// chain best; PERF.md, K15), and each thread computes the step's row
// itself: no shared table, no barrier.
#include <cstdint>

#include "probe_tile.cuh"

namespace {

enum BMode { EXTRACT, BCAST16 };
enum XMode { XEXTRACT, XPOSE };
constexpr int NVAL = 13;
constexpr int PEND_DONE = 1 << 30;
constexpr int INT_BIG = 0x7fffffff;  // the int32 min's identity
constexpr int BCAST_L = 8;  // lanes a thread
constexpr int BCAST_MAX_BLOCK_ROWS = 16;
constexpr int BCAST_THREADS = BCAST_MAX_BLOCK_ROWS * 128 / BCAST_L;
static_assert(BCAST_THREADS / 32 * 4 <= probe::TILE_SLOTS,
              "K14: a cluster of 4 posts more partials than the slots hold");

// the NVAL values of record i
template <int kMode>
__device__ __forceinline__ void record(const float* __restrict__ tab,
                                       const float* __restrict__ ttab, int i,
                                       float (&val)[NVAL]) {
  if constexpr (kMode == EXTRACT) {
    const float* r = tab + 16 * i;  // 64-byte aligned (tab 16-byte aligned)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(r) + c);
      val[4 * c] = q.x, val[4 * c + 1] = q.y, val[4 * c + 2] = q.z;
      val[4 * c + 3] = q.w;
    }
    val[12] = __ldg(r + 12);
  } else {
#pragma unroll
    for (int v = 0; v < NVAL; ++v)
      val[v] = __ldg(ttab + ((i >> 7) * 16 + v) * 128 + (i & 127));
  }
}

// The grid is one cluster: block b holds lanes [b n L, (b + 1) n L) of the
// tile, lane j of thread t at e0 + j n.  kCluster: more than one block.
template <int kMode, bool kCluster>
__global__ void __launch_bounds__(BCAST_THREADS)
    broadcast_kernel(const float* __restrict__ tab,
                     const float* __restrict__ ttab,
                     const int* __restrict__ pend_in,
                     float* __restrict__ out, int steps) {
  constexpr int L = BCAST_L;
  __shared__ float slots[probe::TILE_RED_FLOATS];
  __shared__ unsigned long long bars[2];
  const int n = blockDim.x;
  const int e0 = blockIdx.x * n * L + threadIdx.x;
  int pend[L], m[1] = {INT_BIG};
  float acc[NVAL][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    pend[j] = pend_in[e0 + j * n];
    m[0] = min(m[0], pend[j]);
#pragma unroll
    for (int v = 0; v < NVAL; ++v) acc[v][j] = 0.0f;
  }
  probe::TileRed red{slots, bars, 0};
  if constexpr (kCluster) probe::tile_cluster_init(red);
  probe::tile_reduce<1, false, kCluster>(m, red);
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const int cand = m[0];
    float val[NVAL];
    record<kMode>(tab, ttab, cand & 1023, val);
    bool hit[L];
    m[0] = INT_BIG;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      hit[j] = pend[j] == cand;
      pend[j] = hit[j] ? PEND_DONE : pend[j];
      m[0] = min(m[0], pend[j]);
    }
    // the next step's min goes out before this step's adds (the adds do
    // not feed it), and is taken after them
    const bool more = k + 1 < steps;
    if (more) probe::tile_post<1, false, kCluster>(m, red);
#pragma unroll
    for (int j = 0; j < L; ++j) {
#pragma unroll
      for (int v = 0; v < NVAL; ++v)
        acc[v][j] = hit[j] ? acc[v][j] + val[v] : acc[v][j];
    }
    if (more) probe::tile_take<1, false, kCluster>(m, red);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float s = acc[0][j];
#pragma unroll
    for (int v = 1; v < NVAL; ++v) s = s + acc[v][j];
    out[e0 + j * n] = s + static_cast<float>(pend[j]);
  }
}

// one cluster of `cluster` blocks of rows / cluster * 128 / BCAST_L
// threads
template <int kMode>
cudaError_t launch_broadcast(const float* tab, const float* ttab,
                             const int* pend, float* out, int rows,
                             int cluster, int steps, cudaStream_t s) {
  const auto kernel = cluster > 1 ? broadcast_kernel<kMode, true>
                                  : broadcast_kernel<kMode, false>;
  return probe::launch_cluster(kernel, cluster, cluster,
                               rows / cluster * 128 / BCAST_L, 0, s, tab,
                               ttab, pend, out, steps);
}

constexpr int XPOSE_L = 1;  // lanes a thread
constexpr int XPOSE_BLOCK_ROWS = 8;
constexpr int XPOSE_THREADS = XPOSE_BLOCK_ROWS * 128 / XPOSE_L;
constexpr int GUARD_SMEM = 120 * 1024;

// Block b holds lanes b * n * L .. (b + 1) * n * L - 1 of the tile (n =
// blockDim.x; lane j of thread t: + t + j * n); planes: (6, lanes)
template <int kMode>
__global__ void __launch_bounds__(XPOSE_THREADS, 1)
    xpose_kernel(const float* __restrict__ tab,
                 const float* __restrict__ planes, float* __restrict__ out,
                 int steps, int lanes) {
  constexpr int L = XPOSE_L;
  const int n = blockDim.x, lane = threadIdx.x & 31;
  const int e0 = blockIdx.x * n * L + threadIdx.x;
  float o[L][6], best[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int c = 0; c < 6; ++c) o[j][c] = planes[c * lanes + e0 + j * n];
    best[j] = 1e9f;
  }
  for (int k = 0; k < steps; ++k) {
    const float* row = tab + ((k & 127) * 7 % 120) * 128;
    float4 q{};
    if constexpr (kMode == XPOSE)
      q = __ldg(reinterpret_cast<const float4*>(row) + lane);
    float gt[L];
#pragma unroll
    for (int j = 0; j < L; ++j) gt[j] = CUDART_INF_F;
#pragma unroll
    for (int rec = 0; rec < 8; ++rec) {
      float v[9];
      if constexpr (kMode == XPOSE) {
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          const int idx = 16 * rec + c;
          const float w = (idx & 3) == 0   ? q.x
                          : (idx & 3) == 1 ? q.y
                          : (idx & 3) == 2 ? q.z
                                           : q.w;
          v[c] = __shfl_sync(0xffffffffu, w, idx >> 2);
        }
      } else {
        const float* r = row + 16 * rec;
        const float4 a = __ldg(reinterpret_cast<const float4*>(r));
        const float4 b = __ldg(reinterpret_cast<const float4*>(r + 4));
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
        v[8] = __ldg(r + 8);
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float tq, det;
        if (probe::tri_hit_no_tmin(v, o[j][0], o[j][1], o[j][2], o[j][3],
                                   o[j][4], o[j][5], best[j], tq, det)) {
          // the plain version's tq * where(det != 0, 1 / det, 0), det != 0
          const float tt = probe::mul(tq, 1.0f / det);
          if (tt < gt[j]) gt[j] = tt;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) best[j] = fminf(best[j], gt[j]);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) out[e0 + j * n] = best[j];
}

template <int kMode>
int launch_xpose(const float* tab, const float* planes, float* out,
                 int blocks, int block_rows, int lanes, int steps,
                 cudaStream_t s) {
  const auto kern = xpose_kernel<kMode>;
  // once a mode: the residency guard is above the 48 KB that a launch may
  // take without opting in
  static cudaError_t optin = cudaErrorNotReady;
  if (optin == cudaErrorNotReady)
    optin = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GUARD_SMEM);
  if (optin != cudaSuccess) return static_cast<int>(optin);
  kern<<<blocks, block_rows * 128 / XPOSE_L, GUARD_SMEM, s>>>(
      tab, planes, out, steps, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K14.  mode: index into rtrt_tpu_torch/tools/probe_broadcast.py::MODES;
// tab, ttab: (128, 128) f32, tab 16-byte aligned (its records are read by
// float4); pend: (rows, 128) int32; rows: a multiple of 8 up to 64;
// cluster: 1, 2 or 4 blocks, each of rows / cluster rows (at most
// BCAST_MAX_BLOCK_ROWS: tools/probe_broadcast.py::launch_geometry)
extern "C" int rtrt_probe_broadcast(int mode, const float* tab,
                                    const float* ttab, const int* pend,
                                    float* out, int rows, int cluster,
                                    int steps, void* stream) {
  if ((cluster != 1 && cluster != 2 && cluster != 4) || rows <= 0 ||
      rows % cluster || rows / cluster > BCAST_MAX_BLOCK_ROWS ||
      rows / cluster * 128 % (32 * BCAST_L) ||
      reinterpret_cast<uintptr_t>(tab) % 16)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == EXTRACT)
    return static_cast<int>(launch_broadcast<EXTRACT>(
        tab, ttab, pend, out, rows, cluster, steps, s));
  if (mode == BCAST16)
    return static_cast<int>(launch_broadcast<BCAST16>(
        tab, ttab, pend, out, rows, cluster, steps, s));
  return cudaErrorInvalidValue;
}

// K15.  mode: index into rtrt_tpu_torch/tools/probe_xpose.py::MODES;
// planes: (6, rows, 128) ox oy oz dx dy dz; rows: a multiple of 8 up to
// 32; blocks, block_rows: tools/probe_xpose.py::launch_geometry(rows)
// (blocks x block_rows = rows, block_rows at most 8 and a multiple of
// 32 x XPOSE_L / 128)
extern "C" int rtrt_probe_xpose(int mode, const float* tab,
                                const float* planes, float* out, int rows,
                                int steps, int blocks, int block_rows,
                                void* stream) {
  if (blocks < 1 || block_rows < 1 || block_rows > XPOSE_BLOCK_ROWS ||
      blocks * block_rows != rows || block_rows * 128 % (32 * XPOSE_L))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == XEXTRACT)
    return launch_xpose<XEXTRACT>(tab, planes, out, blocks, block_rows,
                                  rows * 128, steps, s);
  if (mode == XPOSE)
    return launch_xpose<XPOSE>(tab, planes, out, blocks, block_rows,
                               rows * 128, steps, s);
  return cudaErrorInvalidValue;
}
