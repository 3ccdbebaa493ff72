// K8 / K9: the full traversal step (pop, prune, leaf or internal visit,
// sorted pushes) over a synthetic tree, one thread block per ray tile.
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
// What bounds it on the H100: float issue of the visit on the tile's one
// SM (a leaf visit is ~8 x 61 operations per lane, an internal visit ~27
// per lane and child) plus the barriers of the tile-wide reductions and of
// the stack update; records are uniform loads that hit L1.
//
// Design: 4 lanes per thread, rows * 32 threads.  The stacks live in
// shared memory; thread 0 writes them, a barrier publishes them.  Every
// thread computes the same sort and stack pointer from the same reduced
// values, so every branch on them is uniform.  K9 is the same kernel on a
// grid of blocks: the tables (4.7 MB) stay in global memory, read through
// L1 and the 50 MB L2 (the TPU's VMEM staging is layout, not function),
// and each tile refills its own stack, so the blocks are independent.
#include "probe_common.cuh"

namespace {

constexpr int L = 4;  // lanes per thread
constexpr int STACK = 256;

enum Mode { BOTH, LEAFONLY, INTONLY, DEPCOND, NMODES };

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

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

template <int kMode>
__global__ void __launch_bounds__(1024)
    cores_kernel(const float* __restrict__ ntab,
                 const float* __restrict__ ttab,
                 const float* __restrict__ planes, float* __restrict__ out,
                 int* __restrict__ visits, int steps) {
  __shared__ int stack[STACK];
  __shared__ float tstack[STACK];
  __shared__ float red[probe::RED_FLOATS];
  const int n = blockDim.x, lanes = n * L, tiles = gridDim.x;
  const int tile = blockIdx.x;
  for (int i = threadIdx.x; i < STACK; i += n) {
    stack[i] = ((i * 13) % 512) | ((i & 1) << 10);
    tstack[i] = -1e30f;
  }
  __syncthreads();
  Ray r[L];
  float best[L];
  int tri[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    // planes: (6, tiles, rows, 128)
    const float* p = planes + tile * lanes + threadIdx.x + j * n;
    const int ps = tiles * lanes;
    r[j].ox = p[0];
    r[j].oy = p[ps];
    r[j].oz = p[2 * ps];
    r[j].dx = p[3 * ps];
    r[j].dy = p[4 * ps];
    r[j].dz = p[5 * ps];
    r[j].ix = safe_inv(r[j].dx);
    r[j].iy = safe_inv(r[j].dy);
    r[j].iz = safe_inv(r[j].dz);
    best[j] = 1e9f;
    tri[j] = 0;
  }
  int sp = 128, drops = 0, n_leaf = 0, n_int = 0;
  float bound = 1e9f;
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
        const float* row = ttab + (base >> 3) * 128;
        float gt[L];
        int gi[L];
#pragma unroll
        for (int j = 0; j < L; ++j) {
          gt[j] = CUDART_INF_F;
          gi[j] = 0;
        }
#pragma unroll
        for (int rec = 0; rec < 8; ++rec) {
          float v[9];
#pragma unroll
          for (int c = 0; c < 9; ++c) v[c] = __ldg(row + 16 * rec + c);
#pragma unroll
          for (int j = 0; j < L; ++j) {
            float tt;
            const bool ok = probe::tri_hit(v, r[j].ox, r[j].oy, r[j].oz,
                                           r[j].dx, r[j].dy, r[j].dz,
                                           best[j], tt);
            if (ok && tt < gt[j]) {
              gt[j] = tt;
              gi[j] = base + rec;
            }
          }
        }
        float m[1] = {-CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const bool better = gt[j] < best[j];
          best[j] = better ? gt[j] : best[j];
          tri[j] = better ? gi[j] : tri[j];
          m[0] = fmaxf(m[0], best[j]);
        }
        probe::block_reduce<1, true>(m, red);
        bound = m[0];
      } else {
        ++n_int;
        const float* nf = ntab + (cur & 511) * 128;
        float rec[28];
#pragma unroll
        for (int c = 0; c < 28; ++c) rec[c] = __ldg(nf + c);
        float m[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          m[c] = CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < L; ++j) {
            float tn;
            if (probe::slab(rec + 6 * c, r[j].ox, r[j].oy, r[j].oz, r[j].ix,
                            r[j].iy, r[j].iz, best[j], tn))
              m[c] = fminf(m[c], tn);
          }
        }
        probe::block_reduce<4, false>(m, red);
        // child entries: a truncating float -> int32 cast, as astype
        Cand p0{m[0], static_cast<int>(rec[24])};
        Cand p1{m[1], static_cast<int>(rec[25])};
        Cand p2{m[2], static_cast<int>(rec[26])};
        Cand p3{m[3], static_cast<int>(rec[27])};
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
        if (threadIdx.x == 0) {
          if (c3) {
            stack[min(sp, STACK - 1)] = p3.e;
            tstack[min(sp, STACK - 1)] = p3.t;
          }
          if (c2) {
            stack[min(sp + c3, STACK - 1)] = p2.e;
            tstack[min(sp + c3, STACK - 1)] = p2.t;
          }
          if (c1) {
            stack[min(sp + c3 + c2, STACK - 1)] = p1.e;
            tstack[min(sp + c3 + c2, STACK - 1)] = p1.t;
          }
        }
        drops += (p3.t < CUDART_INF_F && c3 == 0) ? 1 : 0;
        sp += c1 + c2 + c3;
        __syncthreads();  // the pushes are visible to the next pop
      }
    }
    sp = max(sp, 64);  // keep the stack warm: pops never run dry
  }
  float* o = out + tile * lanes;
#pragma unroll
  for (int j = 0; j < L; ++j)
    o[threadIdx.x + j * n] = best[j] + static_cast<float>(tri[j]) + bound +
                             static_cast<float>(drops);
  if (threadIdx.x == 0) {
    visits[2 * tile] = n_leaf;
    visits[2 * tile + 1] = n_int;
  }
}

template <int kMode>
cudaError_t launch(const float* ntab, const float* ttab, const float* planes,
                   float* out, int* visits, int rows, int tiles, int steps,
                   cudaStream_t s) {
  cores_kernel<kMode><<<tiles, rows * 128 / L, 0, s>>>(ntab, ttab, planes,
                                                       out, visits, steps);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, const float*, const float*,
                                 float*, int*, int, int, int, cudaStream_t);
constexpr Launcher kLaunch[NMODES] = {launch<BOTH>, launch<LEAFONLY>,
                                      launch<INTONLY>, launch<DEPCOND>};

int run(int mode, const float* ntab, const float* ttab, const float* planes,
        float* out, int* visits, int rows, int tiles, int steps,
        void* stream) {
  if (mode < 0 || mode >= NMODES) return cudaErrorInvalidValue;
  return static_cast<int>(kLaunch[mode](ntab, ttab, planes, out, visits,
                                        rows, tiles, steps,
                                        static_cast<cudaStream_t>(stream)));
}

}  // namespace

// K8, one tile.  mode: index into rtrt_tpu_torch/tools/probe_cores.py::
// MODES; planes (6, rows, 128); rows a multiple of 8 up to 32; ntab >= 512
// and ttab >= 128 rows of 128 (the wrapper checks)
extern "C" int rtrt_probe_cores(int mode, const float* ntab,
                                const float* ttab, const float* planes,
                                float* out, int* visits, int rows, int steps,
                                void* stream) {
  return run(mode, ntab, ttab, planes, out, visits, rows, 1, steps, stream);
}

// K9, a grid of `tiles` tiles: planes (6, tiles, rows, 128), out (tiles,
// rows, 128), visits (tiles, 2)
extern "C" int rtrt_probe_cores_grid(int mode, const float* ntab,
                                     const float* ttab, const float* planes,
                                     float* out, int* visits, int rows,
                                     int tiles, int steps, void* stream) {
  return run(mode, ntab, ttab, planes, out, visits, rows, tiles, steps,
             stream);
}
