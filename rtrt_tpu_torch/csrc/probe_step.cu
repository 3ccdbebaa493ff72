// K6: the traversal-step microbenchmark, one thread-block cluster per ray
// tile.
//
// Replaces: tools/ubench_step.py::make_kernel (pallas_call at
// ubench_step.py:152).  Nine stripped-down while loops over a (rows, 128)
// tile, one per mode (a template parameter: no runtime switch in the
// measured loop):
//   loop      acc += 1 each step
//   fetch     + one record fetch: nf[j] = tab[i / 8][(j + 16 (i % 8)) % 128]
//             for i = step & 1023 (the pltpu.roll of the TPU kernel)
//   slab      + two slab tests over the tile (no reductions)
//   extract2  + two record values added to every lane
//   reduce2   + two tile-wide min reductions -> scalar branch values
//   reduce4   + four slab tests and four tile-wide reductions
//   carry4    two slab tests feeding 4 carried planes (select each step)
//   carry12   the same with 12 carried planes
//   cond12    carry12 under a branch on a fetched value
// out = ox + acc (loop .. reduce4) or best + carried plane 1.  The carry
// modes also write their other planes' final values to `state`: they never
// reach out, and without a store ptxas would delete them (and all their
// per-step work), as the first JAX version lost its work to XLA.
//
// What bounds it on the H100: the issue of rows * 128 lanes of float work
// a step (sub, mul, min/max, compare, select; __fmul_rn keeps every product
// out of an FMA, so the work issues at most at half the card's float32
// rate, which counts an FMA as two) on the SMs that hold the tile, plus one
// wait a tile-wide reduction.  The record is one 64-byte line that every
// thread reads (an L1 hit).
//
// Design: the tile is split over a thread-block cluster of c blocks, the
// smallest c of 1, 2, 4 with rows <= 16 c (ubench_step.py::
// launch_geometry, which passes c): block b takes rows / c rows, 4 lanes a
// thread, 32 threads a row, at most 512 threads, so a thread may hold 128
// registers and a 64-row tile keeps its rays, its 12 carried planes and
// two records in registers on 4 SMs (the one-block port, 8 lanes a thread
// in 64 registers, spilled in every mode with a slab test).  The record of step k is the 15
// floats at tab + 16 (k & 1023) (16 (i % 8) + 14 <= 126: no wrap), 64-byte
// aligned: four 16-byte loads, issued one step ahead.  Tile-wide minima go
// through probe_tile.cuh: shuffles, then on a cluster one st.async into
// every block's slots (distributed shared memory) that counts its bytes on
// that block's mbarrier, and one wait on the own block's mbarrier (on a lone
// block: a store and __syncthreads).  The step loop is not unrolled, so its
// SASS is one step.
#include "probe_tile.cuh"

namespace {

constexpr int L = 4;             // lanes per thread
constexpr int MAX_THREADS = 512;  // 16 rows of 128 lanes at L = 4

enum Mode { LOOP, FETCH, SLAB, EXTRACT2, REDUCE2, REDUCE4, CARRY4, CARRY12,
            COND12, NMODES };

struct Lane {
  float ox, oy, oz, ix, iy, iz;
};

// the record of step k as four 16-byte loads
__device__ __forceinline__ void fetch(const float* __restrict__ tab, int k,
                                      float4 (&q)[4]) {
  const float4* p = reinterpret_cast<const float4*>(tab + 16 * (k & 1023));
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __ldg(p + c);
}

__device__ __forceinline__ void unpack(const float4 (&q)[4],
                                       float (&nf)[15]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    nf[4 * c] = q[c].x;
    nf[4 * c + 1] = q[c].y;
    nf[4 * c + 2] = q[c].z;
    if (c < 3) nf[4 * c + 3] = q[c].w;
  }
}

// slab test of the box nf[lo .. lo + 5] (lo xyz, hi xyz) against best 1e9
__device__ __forceinline__ bool slab(const float (&nf)[15], int lo,
                                     const Lane& r, float& tn) {
  return probe::slab(nf + lo, r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, 1e9f, tn);
}

// carry4 / carry12 / cond12: best, then NC - 1 planes starting at 0, 1, 2,
// ...; out = best + the first of them, state = the others
template <int kMode>
__device__ __forceinline__ void carry(const float* __restrict__ tab,
                                      const Lane (&r)[L], int first,
                                      int lanes, float* __restrict__ out,
                                      float* __restrict__ state, int steps) {
  const int n = blockDim.x;
  constexpr int NC = kMode == CARRY4 ? 4 : 12;
  float best[L], rest[NC - 1][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    best[j] = 1e9f;
#pragma unroll
    for (int c = 0; c < NC - 1; ++c) rest[c][j] = static_cast<float>(c);
  }
  float4 q[4];
  fetch(tab, 0, q);
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    float nf[15];
    unpack(q, nf);
    fetch(tab, k + 1, q);
    if (kMode == COND12 && !(nf[0] < 1e30f)) continue;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float tl, tr;
      const bool hl = slab(nf, 0, r[j], tl);
      const bool hr = slab(nf, 6, r[j], tr);
      best[j] = hl ? fminf(best[j], tl) : best[j];
#pragma unroll
      for (int c = 0; c < NC - 1; ++c)
        rest[c][j] = hr ? rest[c][j] + tr : rest[c][j];
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    out[first + j * n] = best[j] + rest[0][j];
#pragma unroll
    for (int c = 1; c < NC - 1; ++c)
      state[(c - 1) * lanes + first + j * n] = rest[c][j];
  }
}

// kCluster: the tile-wide minima go over a cluster of more than one block
// (reduce2 / reduce4 on more than 16 rows)
template <int kMode, bool kCluster>
__global__ void __launch_bounds__(MAX_THREADS)
    step_kernel(const float* __restrict__ tab, const float* __restrict__ ox_in,
                float* __restrict__ out, float* __restrict__ state,
                int steps) {
  __shared__ float slots[probe::TILE_RED_FLOATS];
  __shared__ unsigned long long bars[2];
  // the grid is one cluster: block b holds lanes [b n L, (b + 1) n L) of
  // the tile, lane j of thread t at first + j n
  const int n = blockDim.x, lanes = gridDim.x * n * L;
  const int first = blockIdx.x * n * L + threadIdx.x;
  Lane r[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float ox = ox_in[first + j * n];
    r[j].ox = ox;
    r[j].oy = probe::mul(ox, 1.1f);
    r[j].oz = probe::mul(ox, 0.9f);
    r[j].ix = 1.0f / (r[j].ox + 2.0f);
    r[j].iy = 1.0f / (r[j].oy + 2.0f);
    r[j].iz = 1.0f / (r[j].oz + 2.0f);
  }

  if constexpr (kMode <= REDUCE4) {
    probe::TileRed red{slots, bars, 0};
    if constexpr (kCluster) probe::tile_cluster_init(red);
    float acc[L];
#pragma unroll
    for (int j = 0; j < L; ++j) acc[j] = 0.0f;
    float4 q[4];
    if constexpr (kMode != LOOP) fetch(tab, 0, q);
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {
      if constexpr (kMode == LOOP) {
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] += 1.0f;
        continue;
      }
      float nf[15];
      unpack(q, nf);
      fetch(tab, k + 1, q);
      if constexpr (kMode == FETCH) {
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] += nf[0];
        continue;
      }
      float live[L], m[4] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                             CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float tl, tr;
        const bool hl = slab(nf, 0, r[j], tl);
        const bool hr = slab(nf, 6, r[j], tr);
        live[j] = (hl ? tl : 0.0f) + (hr ? tr : 0.0f);
        if (kMode >= REDUCE2) {
          m[0] = fminf(m[0], hl ? tl : CUDART_INF_F);
          m[1] = fminf(m[1], hr ? tr : CUDART_INF_F);
        }
        if (kMode == REDUCE4) {
          float tl2, tr2;
          const bool hl2 = slab(nf, 3, r[j], tl2);
          const bool hr2 = slab(nf, 9, r[j], tr2);
          live[j] = live[j] + (hl2 ? tl2 : 0.0f) + (hr2 ? tr2 : 0.0f);
          m[2] = fminf(m[2], hl2 ? tl2 : CUDART_INF_F);
          m[3] = fminf(m[3], hr2 ? tr2 : CUDART_INF_F);
        }
      }
      if constexpr (kMode == SLAB) {
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] += live[j];
      } else if constexpr (kMode == EXTRACT2) {
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = acc[j] + live[j] + nf[0] + nf[6];
      } else {
        // acc + live needs no minimum: it runs between send and wait
        constexpr int N = kMode == REDUCE2 ? 2 : 4;
        float mn[N];
#pragma unroll
        for (int i = 0; i < N; ++i) mn[i] = m[i];
        probe::tile_post<N, false, kCluster>(mn, red);
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = acc[j] + live[j];
        probe::tile_take<N, false, kCluster>(mn, red);
        const float w1 = mn[0] < mn[1] ? 1.0f : 2.0f;
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = acc[j] + w1;
        if constexpr (kMode == REDUCE4) {
          const float w2 = mn[N - 2] < mn[N - 1] ? 1.0f : 2.0f;
#pragma unroll
          for (int j = 0; j < L; ++j) acc[j] = acc[j] + w2;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) out[first + j * n] = r[j].ox + acc[j];
  } else {
    carry<kMode>(tab, r, first, lanes, out, state, steps);
  }
}

// one cluster of `cluster` blocks of rows / cluster * 32 threads
template <int kMode>
cudaError_t launch(const float* tab, const float* ox, float* out,
                   float* state, int rows, int cluster, int steps,
                   cudaStream_t s) {
  auto kernel = step_kernel<kMode, false>;
  if constexpr (kMode == REDUCE2 || kMode == REDUCE4)
    if (cluster > 1) kernel = step_kernel<kMode, true>;
  return probe::launch_cluster(kernel, cluster, cluster,
                               rows / cluster * 128 / L, 0, s, tab, ox, out,
                               state, steps);
}

using Launcher = cudaError_t (*)(const float*, const float*, float*, float*,
                                 int, int, int, cudaStream_t);
constexpr Launcher kLaunch[NMODES] = {
    launch<LOOP>,    launch<FETCH>,  launch<SLAB>,
    launch<EXTRACT2>, launch<REDUCE2>, launch<REDUCE4>,
    launch<CARRY4>,  launch<CARRY12>, launch<COND12>};

}  // namespace

// mode: index into rtrt_tpu_torch/tools/ubench_step.py::MODES; rows: a
// multiple of 8 up to 64; cluster: 1, 2 or 4 blocks, each of rows /
// cluster rows (at most 16: ubench_step.py::launch_geometry); state: (10,
// rows, 128) scratch of the carry modes (unused otherwise)
extern "C" int rtrt_probe_step(int mode, const float* tab, const float* ox,
                               float* out, float* state, int rows,
                               int cluster, int steps, void* stream) {
  if (mode < 0 || mode >= NMODES) return cudaErrorInvalidValue;
  if ((cluster != 1 && cluster != 2 && cluster != 4) || rows <= 0 ||
      rows % cluster || rows / cluster * 128 / L > MAX_THREADS)
    return cudaErrorInvalidValue;
  return static_cast<int>(kLaunch[mode](tab, ox, out, state, rows, cluster,
                                        steps,
                                        static_cast<cudaStream_t>(stream)));
}
