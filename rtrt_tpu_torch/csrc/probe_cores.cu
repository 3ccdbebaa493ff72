// K8 / K9: the full traversal step (pop, prune, leaf or internal visit,
// sorted pushes) over a synthetic tree, one thread-block cluster per ray
// tile.
//
// Replaces: tools/probe_cores.py::make_kernel, launched on one tile (K8,
// pallas_call at probe_cores.py:218) and on a grid of tiles with (4608,
// 128) tables staged HBM -> VMEM at grid step 0 (K9, pallas_call at
// probe_cores.py:248).  Every step pops (entry, entry distance) from a
// 256-deep scalar stack shared by the tile; if the distance is below the
// tile's bound it visits
//   a leaf (entry bit 1024): the 8 triangle records of ttab row
//     (entry & 1023) / 8, running best and hit slot per lane, bound = the
//     tile-wide max of the best;
//   an internal node: 4 slab tests against the boxes of ntab row
//     entry & 511, each child's tile-wide min entry distance, the
//     5-comparator sort of (distance, child entry), predicated pushes of
//     the 3 farthest children, a count of the farthest child's drops.
// The stack never runs below 64 entries.  Modes (a template parameter):
//   both      leaf or internal by the entry's bit
//   leafonly  every visit is a leaf visit
//   intonly   every visit is an internal visit
//   depcond   both, with the loop also ending on an empty stack or a bound
//             of -1e30 (data-dependent trip count)
// out = best + hit slot + bound + drops; visits[2 * tile] = leaf visits,
// visits[2 * tile + 1] = internal visits (for the operation count).
//
// What bounds it on the H100: float issue of the visit on the SMs of the
// tile's cluster (a leaf visit is ~8 x 61 operations per lane, an internal
// visit ~27 per lane and child) plus the wait of each tile-wide
// reduction; records are uniform loads that hit L1.
//
// Design: the tile is split over a thread-block cluster of c
// blocks of at most 16 rows, one an SM (c = 1 up to 16 rows, 2 up to 32:
// tools/probe_cores.py::launch_geometry), 4 lanes a thread, at most 512
// threads a block, so that a thread may hold 128 registers.  On one SM
// the tile does not fit: 1,024 threads of 64 registers spilled 36-220 B
// in the modes with a leaf visit (the hit slot and the inverse directions
// beside K7's state), and 512 threads of 8 lanes fit without a spill but
// ran the leaf visit 8% slower than the parent (16 warps hide less
// latency; PERF.md, K8).  The leaf visit is K7's (probe_visit.cuh:
// 16-byte record loads), with the hit slot kept beside best; the internal
// visit reads the 28-float node record as seven 16-byte loads, consumed
// child by child.  Each tile-wide max or min (the four child minima in
// one call) is probe_tile.cuh's one-wait reduction: st.async into every
// block's slots and one mbarrier wait on a cluster, __syncthreads in a
// lone block.  Every thread of the cluster computes the same sort and
// stack pointer from the same reduced values, so every branch on them is
// uniform, and the pushes need no block barrier: each warp keeps its own
// copy of the stack in dynamic shared memory (16 warps x 256 x 8 B = 32
// KiB), lane 0 writes the warp's copy and __syncwarp publishes it to the
// warp's next pop.  K9 is the same kernel on a grid of tiles, one cluster
// each: the tables (4.7 MB) stay in global memory, read through L1 and
// the 50 MB L2 (the TPU's VMEM staging is layout, not function), and each
// tile refills its own stack, so the clusters are independent.
#include "probe_visit.cuh"

namespace {

constexpr int L = 4;  // lanes per thread
constexpr int STACK = 256;
constexpr int MAX_BLOCK_ROWS = 16;
constexpr int MAX_THREADS = MAX_BLOCK_ROWS * 128 / L;
constexpr int MAX_WARPS = MAX_THREADS / 32;
// dynamic shared memory: the per-warp stacks, entries [MAX_WARPS][STACK]
// int then distances [MAX_WARPS][STACK] float
constexpr int SMEM = 2 * MAX_WARPS * STACK * 4;

enum Mode { BOTH, LEAFONLY, INTONLY, DEPCOND, NMODES };

struct Cand {
  float t;
  int e;
};

__device__ __forceinline__ void cswap(Cand& a, Cand& b) {
  if (a.t > b.t) {
    const Cand c = a;
    a = b;
    b = c;
  }
}

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

struct Inv {
  float x, y, z;
};

// m = each lane's entry distance into box b where its slab test passes,
// min over the thread's lanes (inf where none)
__device__ __forceinline__ float child_min(const float (&b)[6],
                                           const probe::Ray (&r)[L],
                                           const Inv (&iv)[L],
                                           const float (&best)[L]) {
  float m = CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float tn;
    if (probe::slab(b, r[j].ox, r[j].oy, r[j].oz, iv[j].x, iv[j].y, iv[j].z,
                    best[j], tn))
      m = fminf(m, tn);
  }
  return m;
}

// kCluster: a tile of more than 16 rows, over a cluster of blocks
template <int kMode, bool kCluster>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    cores_kernel(const float* __restrict__ ntab,
                 const float* __restrict__ ttab,
                 const float* __restrict__ planes, float* __restrict__ out,
                 int* __restrict__ visits, int steps) {
  extern __shared__ int dyn[];
  __shared__ float slots[probe::TILE_RED_FLOATS];
  __shared__ unsigned long long bars[2];
  int c = 1, rank = 0;  // blocks a tile, this block's place in it
  if constexpr (kCluster) {
    const cooperative_groups::cluster_group cl =
        cooperative_groups::this_cluster();
    c = static_cast<int>(cl.num_blocks());
    rank = static_cast<int>(cl.block_rank());
  }
  // block b of the grid (block `rank` of tile b / c) holds lanes
  // [b n L, (b + 1) n L) of the (tiles, rows, 128) planes, lane j of
  // thread t at first + j n
  const int n = blockDim.x, tile = blockIdx.x / c;
  const int first = blockIdx.x * n * L + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* const stack = dyn + warp * STACK;
  float* const tstack =
      reinterpret_cast<float*>(dyn) + (MAX_WARPS + warp) * STACK;
  for (int i = lane; i < STACK; i += 32) {
    stack[i] = ((i * 13) % 512) | ((i & 1) << 10);
    tstack[i] = -1e30f;
  }
  __syncwarp();
  probe::Ray r[L];
  Inv iv[L];
  float best[L];
  int tri[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    // planes: (6, tiles, rows, 128)
    const float* p = planes + first + j * n;
    const int ps = gridDim.x * n * L;
    r[j] = probe::Ray{p[0],      p[ps],     p[2 * ps],
                      p[3 * ps], p[4 * ps], p[5 * ps]};
    iv[j] = Inv{safe_inv(r[j].dx), safe_inv(r[j].dy), safe_inv(r[j].dz)};
    best[j] = 1e9f;
    tri[j] = 0;
  }
  probe::TileRed red{slots, bars, 0};
  if constexpr (kCluster) probe::tile_cluster_init(red);
  int sp = 128, drops = 0, n_leaf = 0, n_int = 0;
  float bound = 1e9f;
#pragma unroll 1
  for (int k = 0;
       k < steps && (kMode != DEPCOND || (sp > 0 && bound > -1e30f)); ++k) {
    const int ti = max(sp - 1, 0);
    const int cur = stack[ti];
    const float topt = tstack[ti];
    sp = max(sp - 1, 0);
    if (topt < bound) {
      const bool leaf = kMode == LEAFONLY ||
                        (kMode != INTONLY && (cur & 1024) != 0);
      if (leaf) {
        ++n_leaf;
        const int base = cur & 1023;
        probe::leaf_visit<L, 8, probe::LEAF_FULL, true, true, kCluster>(
            ttab + (base >> 3) * 128, base, r, best, tri, bound, red);
      } else {
        ++n_int;
        // the node record, seven 16-byte loads consumed child by child:
        // box c is floats 6c .. 6c + 5, the child entries floats 24 .. 27
        const float4* q =
            reinterpret_cast<const float4*>(ntab + (cur & 511) * 128);
        float m[4];
        const float4 q0 = __ldg(q), q1 = __ldg(q + 1);
        m[0] = child_min({q0.x, q0.y, q0.z, q0.w, q1.x, q1.y}, r, iv, best);
        const float4 q2 = __ldg(q + 2);
        m[1] = child_min({q1.z, q1.w, q2.x, q2.y, q2.z, q2.w}, r, iv, best);
        const float4 q3 = __ldg(q + 3), q4 = __ldg(q + 4);
        m[2] = child_min({q3.x, q3.y, q3.z, q3.w, q4.x, q4.y}, r, iv, best);
        const float4 q5 = __ldg(q + 5);
        m[3] = child_min({q4.z, q4.w, q5.x, q5.y, q5.z, q5.w}, r, iv, best);
        const float4 q6 = __ldg(q + 6);
        probe::tile_reduce<4, false, kCluster>(m, red);
        // child entries: a truncating float -> int32 cast, as astype
        Cand p0{m[0], static_cast<int>(q6.x)};
        Cand p1{m[1], static_cast<int>(q6.y)};
        Cand p2{m[2], static_cast<int>(q6.z)};
        Cand p3{m[3], static_cast<int>(q6.w)};
        cswap(p0, p1);
        cswap(p2, p3);
        cswap(p0, p2);
        cswap(p1, p3);
        cswap(p1, p2);
        // predicated pushes, farthest first; a push that does not fit is
        // skipped (only the farthest child's is counted, as in the probe)
        const int c3 = (p3.t < CUDART_INF_F && sp < STACK) ? 1 : 0;
        const int c2 = (p2.t < CUDART_INF_F && sp + c3 < STACK) ? 1 : 0;
        const int c1 = (p1.t < CUDART_INF_F && sp + c3 + c2 < STACK) ? 1 : 0;
        if (lane == 0) {  // the warp's copy of the stack
          if (c3) {
            stack[sp] = p3.e;
            tstack[sp] = p3.t;
          }
          if (c2) {
            stack[sp + c3] = p2.e;
            tstack[sp + c3] = p2.t;
          }
          if (c1) {
            stack[sp + c3 + c2] = p1.e;
            tstack[sp + c3 + c2] = p1.t;
          }
        }
        drops += (p3.t < CUDART_INF_F && c3 == 0) ? 1 : 0;
        sp += c1 + c2 + c3;
        __syncwarp();  // the pushes are visible to the warp's next pop
      }
    }
    sp = max(sp, 64);  // keep the stack warm: pops never run dry
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
    out[first + j * n] = best[j] + static_cast<float>(tri[j]) + bound +
                         static_cast<float>(drops);
  if (rank == 0 && threadIdx.x == 0) {
    visits[2 * tile] = n_leaf;
    visits[2 * tile + 1] = n_int;
  }
}

// tiles clusters of `cluster` blocks of rows / cluster * 32 threads
template <int kMode>
cudaError_t launch(const float* ntab, const float* ttab, const float* planes,
                   float* out, int* visits, int rows, int cluster, int tiles,
                   int steps, cudaStream_t s) {
  const auto kernel = cluster > 1 ? cores_kernel<kMode, true>
                                  : cores_kernel<kMode, false>;
  // the per-warp stacks may pass the 48 KB a launch takes without opting
  // in: once per instantiation
  static cudaError_t optin[2] = {cudaErrorNotReady, cudaErrorNotReady};
  cudaError_t& e = optin[cluster > 1];
  if (e == cudaErrorNotReady)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  return probe::launch_cluster(kernel, tiles * cluster, cluster,
                               rows / cluster * 128 / L, SMEM, s, ntab, ttab,
                               planes, out, visits, steps);
}

using Launcher = cudaError_t (*)(const float*, const float*, const float*,
                                 float*, int*, int, int, int, int,
                                 cudaStream_t);
constexpr Launcher kLaunch[NMODES] = {launch<BOTH>, launch<LEAFONLY>,
                                      launch<INTONLY>, launch<DEPCOND>};

int run(int mode, const float* ntab, const float* ttab, const float* planes,
        float* out, int* visits, int rows, int cluster, int tiles, int steps,
        void* stream) {
  if (mode < 0 || mode >= NMODES || (cluster != 1 && cluster != 2) ||
      rows <= 0 || rows % cluster || rows / cluster > MAX_BLOCK_ROWS)
    return cudaErrorInvalidValue;
  return static_cast<int>(kLaunch[mode](ntab, ttab, planes, out, visits,
                                        rows, cluster, tiles, steps,
                                        static_cast<cudaStream_t>(stream)));
}

}  // namespace

// K8, one tile.  mode: index into rtrt_tpu_torch/tools/probe_cores.py::
// MODES; planes (6, rows, 128); rows a multiple of 8 up to 32; cluster: 1
// or 2 blocks of rows / cluster rows (at most 16: probe_cores.py::
// launch_geometry); ntab >= 512 and ttab >= 128 rows of 128 (the wrapper
// checks)
extern "C" int rtrt_probe_cores(int mode, const float* ntab,
                                const float* ttab, const float* planes,
                                float* out, int* visits, int rows,
                                int cluster, int steps, void* stream) {
  return run(mode, ntab, ttab, planes, out, visits, rows, cluster, 1, steps,
             stream);
}

// K9, a grid of `tiles` tiles, a cluster each: planes (6, tiles, rows,
// 128), out (tiles, rows, 128), visits (tiles, 2)
extern "C" int rtrt_probe_cores_grid(int mode, const float* ntab,
                                     const float* ttab, const float* planes,
                                     float* out, int* visits, int rows,
                                     int cluster, int tiles, int steps,
                                     void* stream) {
  return run(mode, ntab, ttab, planes, out, visits, rows, cluster, tiles,
             steps, stream);
}
