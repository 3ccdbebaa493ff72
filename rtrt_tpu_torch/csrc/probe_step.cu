// K6: the traversal-step microbenchmark, one thread block per ray tile.
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
// What bounds it on the H100: one block runs on one SM, so a step costs
// the issue time of rows * 128 lanes of float work on one SM's 128 lanes
// (plus two barriers per tile-wide reduction); the record fetch is a
// uniform load that hits L1.  The tile's carried state does not fit one
// SM's 64 K registers at 64 rows (12 planes x 8192 lanes), so carry12
// spills to local memory: that cost is what the mode measures.
//
// Design: 8 lanes per thread, rows * 16 threads (1024 at the default 64
// rows).
#include "probe_common.cuh"

namespace {

constexpr int L = 8;  // lanes per thread

enum Mode { LOOP, FETCH, SLAB, EXTRACT2, REDUCE2, REDUCE4, CARRY4, CARRY12,
            COND12, NMODES };

struct Lane {
  float ox, oy, oz, ix, iy, iz;
};

// slab test of the box nf[lo .. lo + 5] (lo xyz, hi xyz) against best 1e9
__device__ __forceinline__ bool slab(const float (&nf)[15], int lo,
                                     const Lane& r, float& tn) {
  return probe::slab(nf + lo, r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, 1e9f, tn);
}

// carry4 / carry12 / cond12: best, then NC - 1 planes starting at 0, 1, 2,
// ...; out = best + the first of them, state = the others
template <int kMode>
__device__ __forceinline__ void carry(const float* __restrict__ tab,
                                      const Lane (&r)[L],
                                      float* __restrict__ out,
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
  for (int k = 0; k < steps; ++k) {
    const int i = k & 1023;
    float nf[15];
#pragma unroll
    for (int c = 0; c < 15; ++c)
      nf[c] = __ldg(tab + (i >> 3) * 128 + ((c + 16 * (i & 7)) & 127));
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
    out[threadIdx.x + j * n] = best[j] + rest[0][j];
#pragma unroll
    for (int c = 1; c < NC - 1; ++c)
      state[(c - 1) * n * L + threadIdx.x + j * n] = rest[c][j];
  }
}

template <int kMode>
__global__ void __launch_bounds__(1024)
    step_kernel(const float* __restrict__ tab, const float* __restrict__ ox_in,
                float* __restrict__ out, float* __restrict__ state,
                int steps) {
  __shared__ float red[probe::RED_FLOATS];
  const int n = blockDim.x;
  Lane r[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float ox = ox_in[threadIdx.x + j * n];
    r[j].ox = ox;
    r[j].oy = probe::mul(ox, 1.1f);
    r[j].oz = probe::mul(ox, 0.9f);
    r[j].ix = 1.0f / (r[j].ox + 2.0f);
    r[j].iy = 1.0f / (r[j].oy + 2.0f);
    r[j].iz = 1.0f / (r[j].oz + 2.0f);
  }

  if constexpr (kMode <= REDUCE4) {
    float acc[L];
#pragma unroll
    for (int j = 0; j < L; ++j) acc[j] = 0.0f;
    for (int k = 0; k < steps; ++k) {
      if constexpr (kMode == LOOP) {
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] += 1.0f;
        continue;
      }
      const int i = k & 1023;
      float nf[15];
#pragma unroll
      for (int c = 0; c < 15; ++c)
        nf[c] = __ldg(tab + (i >> 3) * 128 + ((c + 16 * (i & 7)) & 127));
      if (kMode == FETCH) {
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
      if (kMode == SLAB) {
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] += live[j];
      } else if (kMode == EXTRACT2) {
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = acc[j] + live[j] + nf[0] + nf[6];
      } else if (kMode == REDUCE2) {
        float m2[2] = {m[0], m[1]};
        probe::block_reduce<2, false>(m2, red);
        const float w = m2[0] < m2[1] ? 1.0f : 2.0f;
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = acc[j] + live[j] + w;
      } else {
        probe::block_reduce<4, false>(m, red);
        const float w1 = m[0] < m[1] ? 1.0f : 2.0f;
        const float w2 = m[2] < m[3] ? 1.0f : 2.0f;
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = acc[j] + live[j] + w1 + w2;
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) out[threadIdx.x + j * n] = r[j].ox + acc[j];
  } else {
    carry<kMode>(tab, r, out, state, steps);
  }
}

template <int kMode>
cudaError_t launch(const float* tab, const float* ox, float* out,
                   float* state, int rows, int steps, cudaStream_t s) {
  step_kernel<kMode><<<1, rows * 128 / L, 0, s>>>(tab, ox, out, state, steps);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, const float*, float*, float*,
                                 int, int, cudaStream_t);
constexpr Launcher kLaunch[NMODES] = {
    launch<LOOP>,    launch<FETCH>,  launch<SLAB>,
    launch<EXTRACT2>, launch<REDUCE2>, launch<REDUCE4>,
    launch<CARRY4>,  launch<CARRY12>, launch<COND12>};

}  // namespace

// mode: index into rtrt_tpu_torch/tools/ubench_step.py::MODES; rows: a
// multiple of 8 up to 64 (the wrapper checks); state: (10, rows, 128)
// scratch of the carry modes (unused otherwise)
extern "C" int rtrt_probe_step(int mode, const float* tab, const float* ox,
                               float* out, float* state, int rows, int steps,
                               void* stream) {
  if (mode < 0 || mode >= NMODES) return cudaErrorInvalidValue;
  return static_cast<int>(kLaunch[mode](tab, ox, out, state, rows, steps,
                                        static_cast<cudaStream_t>(stream)));
}
