// K7: a replica of the traversal kernel's leaf visit, one thread block per
// ray tile.
//
// Replaces: tools/probe_leaf.py::make_kernel (pallas_call at
// probe_leaf.py:179).  Every step pops a record row index from a
// 128-entry scalar stack (filled with (i * 7) % 120), tests the tile's rays
// against the 8 triangle records of that row of `tab` (Moller-Trumbore,
// running best per lane) and takes the tile-wide max of the new best as
// the prune bound.  Modes (a template parameter each):
//   full    the whole visit, under the two data-dependent branches
//   nored   no tile-wide max (bound stays 1e9)
//   noextr  record values replaced by literals (same math)
//   nomath  records read, Moller-Trumbore replaced by a 7-product sum
//   nocond  full without the branches
//   rec2    2 records instead of 8
//   dep     the popped index depends on the previous step's bound
//   fat     the leaf visit beside an internal-visit-sized branch (4 slab
//           tests + 4 tile-wide mins; never taken: the stack holds < 120)
//   carry4  fat plus 3 planes computed from best, threaded through the
//           branches and dropped (dead, so the same code as fat here)
// out = best + bound.
//
// What bounds it on the H100: float issue of 8 x ~60 operations per lane
// per visit (__fmul_rn keeps every product out of an FMA: at most half the
// card's float32 rate, which counts an FMA as two) on the one SM that runs
// the tile, plus the barrier of one tile-wide max; the record row is read
// by every thread (an L1 hit).
//
// Design: 4 lanes per thread, rows * 32 threads (1024 at the default 32
// rows), so a thread holds 4 x 8 words of state and the record in its 64
// registers; the stack lives in shared memory; bound is the same in every
// thread after the reduction, so every branch on it is uniform.  The
// visit itself is probe_visit.cuh's, which K8 calls too: a record (9
// floats at a 16-float stride, 64-byte aligned) is two 16-byte loads and
// one scalar load from global memory (L1).  Staging the next visit's
// row in shared memory a step ahead (cp.async into a double-buffered row a
// warp, no block barrier added) measured 5% slower than these loads in
// mode full (NVIDIA H100 80GB HBM3, 700 W; PERF.md, K7), so the kernel
// does not stage.  The tile-wide max is probe_tile.cuh's
// one-barrier reduction.  The step loop is not unrolled, so its SASS is one
// step.
#include "probe_visit.cuh"

namespace {

constexpr int L = 4;  // lanes per thread

enum Mode { FULL, NORED, NOEXTR, NOMATH, NOCOND, REC2, DEP, FAT, CARRY4,
            NMODES };

using probe::Ray;

// the 8-record visit of `row` (probe_visit.cuh, K8's too): best per lane,
// bound (tile max); K7 keeps no hit slot
template <int kMode>
__device__ __forceinline__ void leaf_visit(const float* __restrict__ row,
                                           const Ray (&r)[L],
                                           float (&best)[L], float& bound,
                                           probe::TileRed& red) {
  constexpr int kForm = kMode == NOEXTR   ? probe::LEAF_LITERAL
                        : kMode == NOMATH ? probe::LEAF_NOMATH
                                          : probe::LEAF_FULL;
  int unused[L];
  probe::leaf_visit<L, kMode == REC2 ? 2 : 8, kForm, kMode != NORED, false>(
      row, 0, r, best, unused, bound, red);
}

// the internal-visit-sized branch of fat / carry4 (tools/probe_leaf.py::
// slab_like): 4 slab tests against row 0, bound = min(bound, sum of the
// 4 tile-wide minima)
__device__ __forceinline__ void slab_like(const float* __restrict__ tab,
                                          const Ray (&r)[L],
                                          const float (&best)[L],
                                          float& bound, probe::TileRed& red) {
  float m[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float lo0 = __ldg(tab + 6 * c), lo1 = __ldg(tab + 6 * c + 1);
    const float lo2 = __ldg(tab + 6 * c + 2), hi0 = __ldg(tab + 6 * c + 3);
    const float hi1 = __ldg(tab + 6 * c + 4), hi2 = __ldg(tab + 6 * c + 5);
    m[c] = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float tn = fmaxf(fmaxf((lo0 - r[j].ox) * r[j].dx,
                                   (lo1 - r[j].oy) * r[j].dy),
                             (lo2 - r[j].oz) * r[j].dz);
      const float tf = fminf(fminf((hi0 - r[j].ox) * r[j].dx,
                                   (hi1 - r[j].oy) * r[j].dy),
                             (hi2 - r[j].oz) * r[j].dz);
      if (tn <= tf && tn < best[j]) m[c] = fminf(m[c], tn);
    }
  }
  probe::tile_reduce<4, false, false>(m, red);
  bound = fminf(bound, m[0] + m[1] + m[2] + m[3]);
}

template <int kMode>
__global__ void __launch_bounds__(1024)
    leaf_kernel(const float* __restrict__ tab,
                const float* __restrict__ planes, float* __restrict__ out,
                int steps) {
  __shared__ int stack[128];
  __shared__ float slots[probe::TILE_RED_FLOATS];
  const int n = blockDim.x, lanes = n * L;
  for (int i = threadIdx.x; i < 128; i += n) stack[i] = (i * 7) % 120;
  __syncthreads();
  Ray r[L];
  float best[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float* p = planes + threadIdx.x + j * n;
    r[j] = Ray{p[0], p[lanes], p[2 * lanes], p[3 * lanes], p[4 * lanes],
               p[5 * lanes]};
    best[j] = 1e9f;
  }
  probe::TileRed red{slots, nullptr, 0};
  float bound = 1e9f;
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    // dep: the index depends on the previous visit's tile-wide max (a
    // truncating cast of |bound|, as jnp.int32)
    const int base =
        kMode == DEP ? stack[(k + static_cast<int>(fabsf(bound)) % 7) % 128]
                     : stack[k % 128];
    const float* row = tab + base * 128;
    if constexpr (kMode == NOCOND) {
      leaf_visit<kMode>(row, r, best, bound, red);
    } else if constexpr (kMode == FAT || kMode == CARRY4) {
      // carry4's three planes (best x 1.01, 1.02, 1.03) pass through the
      // branches and are dropped after them: they are dead in the function,
      // and a register carried across a uniform branch costs nothing here,
      // so carry4 compiles to fat
      if (bound > -1e30f) {
        if (base >= 120)
          slab_like(tab, r, best, bound, red);
        else
          leaf_visit<kMode>(row, r, best, bound, red);
      }
    } else {
      if (bound > -1e30f && base >= 0)
        leaf_visit<kMode>(row, r, best, bound, red);
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) out[threadIdx.x + j * n] = best[j] + bound;
}

template <int kMode>
cudaError_t launch(const float* tab, const float* planes, float* out,
                   int rows, int steps, cudaStream_t s) {
  leaf_kernel<kMode><<<1, rows * 128 / L, 0, s>>>(tab, planes, out, steps);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, const float*, float*, int,
                                 int, cudaStream_t);
constexpr Launcher kLaunch[NMODES] = {
    launch<FULL>, launch<NORED>, launch<NOEXTR>, launch<NOMATH>,
    launch<NOCOND>, launch<REC2>, launch<DEP>, launch<FAT>, launch<CARRY4>};

}  // namespace

// mode: index into rtrt_tpu_torch/tools/probe_leaf.py::MODES; planes:
// (6, rows, 128) ox oy oz dx dy dz; rows: a multiple of 8 up to 32
extern "C" int rtrt_probe_leaf(int mode, const float* tab,
                               const float* planes, float* out, int rows,
                               int steps, void* stream) {
  if (mode < 0 || mode >= NMODES) return cudaErrorInvalidValue;
  return static_cast<int>(kLaunch[mode](tab, planes, out, rows, steps,
                                        static_cast<cudaStream_t>(stream)));
}
