// K10-K13: the 72-value consume loop of the TPU probes, one thread block per
// (rows, 128) tile, and K11's shared-memory capacity probe.
//
// Replaces:
//   K10 tools/probe_cond.py::make_kernel (pallas_call at probe_cond.py:76)
//   K11 tools/probe_smem.py::try_alloc   (probe_smem.py:34)
//   K12 tools/probe_smem.py::time_consume (probe_smem.py:85)
//   K13 tools/probe_pressure.py::make_kernel (probe_pressure.py:60)
//
// The consume (probe_cond.py:36-46, probe_smem.py:59-77,
// probe_pressure.py:34-45): step k reads 72 values (8 records of 9) and
// folds them into the tile in 24 terms a = min(a * v0 + t(v1), v2 + a);
// the next k is k + 1 + (acc[0, 0] > 1e30).  One device function, the
// variants template parameters:
//   kSrc  ROW:  value c of row (base / 8) at 16 (c / 9) + c % 9, base =
//               (7 k) % 997, read by every thread from global memory (a
//               uniform load that hits L1) — K10, K12 extract, K13;
//         FLAT: the table staged once into dynamic shared memory (64 KiB,
//               above the 48 KB default: an opt-in), value c at flat index
//               (base + 16 (c / 9) + c % 9) % 8000 — K12 smem, another
//               function than extract (the TPU probe's SMEM read)
//   kCond 0, 1 or 2 branches around the consume (K10 flat, cond, cond2):
//         if ((k & mask1) >= thresh) [if ((k & mask2) >= thresh)].  The
//         masks (1023, 511) and the threshold (0) are kernel arguments, so
//         the compiler cannot fold the always-true tests away
//   kInv  -1: t(v1) = v1 (K10, K12); 0: v1 * 0.5 (K13 without planes, one
//         product per step); n > 0: v1 * inv[(i / 3) % n], inv[p] = x *
//         fac[p] live per lane (K13).  The factors 1 + 0.01 p come from a
//         global array the loop never writes, so the planes are computed
//         once before the loop and held (registers or, past the cap, local
//         memory) rather than recomputed each step; K13 adds x to the
//         output (its sum(inv[:1])).
// acc[0, 0] belongs to thread 0's lane 0; thread 0 writes the step's flag
// to shared memory and one barrier publishes it: the Hopper form of the
// TPU's vector-to-scalar sync, every step, part of what is measured.  The
// flag alternates between two slots, so the next step's write never races
// this step's reads.
//
// What bounds them on the H100: float issue on the one SM that runs the
// tile (24 x 4 operations per lane per step, 24 x 5 with planes), the
// barrier, and the 72 uniform loads per thread per step.  Past 64
// registers a thread (1,024-thread blocks) K13's planes spill to local
// memory: that cost is what K13 measures.  Every kernel of K10-K16 says
// __launch_bounds__(1024, 1): a launch is one block, and without the
// one-block minimum ptxas gave the consume kernels 32 registers and
// spilled, aiming at two blocks an SM that never come.
//
// K11: out = x + s[0] + s[n - 1] through a dynamic shared-memory buffer
// of n floats written at 0 and n - 1 (n = 1: both writes hit s[0], the
// second wins).  A request above the card's opt-in maximum is refused by
// the CUDA runtime (cudaErrorInvalidValue, not sticky): the entry point
// returns that one case as RTRT_SMEM_REFUSED and every other error as it
// is.
#include "probe_common.cuh"

namespace {

enum Src { ROW, FLAT };
constexpr int TAB = 128 * 128;
constexpr int NO_TERM = -1;
constexpr int RTRT_SMEM_REFUSED = -1;
constexpr size_t kSmemDefault = 48 * 1024;

template <int L, int kSrc, int kInv>
__device__ __forceinline__ void consume(
    const float* __restrict__ tab, const float* stab, int base,
    float (&acc)[L], const float (&inv)[kInv > 0 ? kInv : 1][L]) {
  using probe::mul;
  const float* row = tab + (base >> 3) * 128;
#pragma unroll
  for (int i = 0; i < 72; i += 3) {
    float v[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int off = 16 * ((i + q) / 9) + (i + q) % 9;
      v[q] = kSrc == ROW ? __ldg(row + off) : stab[(base + off) % 8000];
    }
    if constexpr (kInv == NO_TERM) {
#pragma unroll
      for (int j = 0; j < L; ++j)
        acc[j] = fminf(mul(acc[j], v[0]) + v[1], v[2] + acc[j]);
    } else if constexpr (kInv == 0) {
      const float w = mul(v[1], 0.5f);
#pragma unroll
      for (int j = 0; j < L; ++j)
        acc[j] = fminf(mul(acc[j], v[0]) + w, v[2] + acc[j]);
    } else {
      const int p = (i / 3) % kInv;
#pragma unroll
      for (int j = 0; j < L; ++j)
        acc[j] = fminf(mul(acc[j], v[0]) + mul(v[1], inv[p][j]),
                       v[2] + acc[j]);
    }
  }
}

template <int L, int kSrc, int kCond, int kInv>
__global__ void __launch_bounds__(1024, 1)
    consume_kernel(const float* __restrict__ tab, const float* __restrict__ x,
                   const float* fac, float* __restrict__ out, int steps,
                   int mask1, int mask2, int thresh) {
  extern __shared__ float stab[];  // FLAT: the staged table
  __shared__ int flag[2];
  const int n = blockDim.x;
  if constexpr (kSrc == FLAT) {
    for (int i = threadIdx.x; i < TAB; i += n) stab[i] = tab[i];
  }
  constexpr int NI = kInv > 0 ? kInv : 1;
  float acc[L], inv[NI][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    acc[j] = x[threadIdx.x + j * n];
#pragma unroll
    for (int p = 0; p < NI; ++p) {
      if constexpr (kInv > 0) inv[p][j] = probe::mul(acc[j], fac[p]);
      else inv[p][j] = 0.0f;
    }
  }
  __syncthreads();
  int k = 0;
  for (int s = 0; k < steps; ++s) {
    const int base = (k * 7) % 997;
    if constexpr (kCond == 0) {
      consume<L, kSrc, kInv>(tab, stab, base, acc, inv);
    } else if constexpr (kCond == 1) {
      if ((k & mask1) >= thresh)
        consume<L, kSrc, kInv>(tab, stab, base, acc, inv);
    } else {
      if ((k & mask1) >= thresh) {
        if ((k & mask2) >= thresh)
          consume<L, kSrc, kInv>(tab, stab, base, acc, inv);
      }
    }
    if (threadIdx.x == 0) flag[s & 1] = acc[0] > 1e30f;
    __syncthreads();
    k += 1 + flag[s & 1];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int e = threadIdx.x + j * n;
    out[e] = kInv > 0 ? acc[j] + x[e] : acc[j];
  }
}

template <int L, int kSrc, int kCond, int kInv>
cudaError_t launch(const float* tab, const float* x, const float* fac,
                   float* out, int rows, int steps, int mask1, int mask2,
                   int thresh, cudaStream_t s) {
  const auto kern = consume_kernel<L, kSrc, kCond, kInv>;
  int smem = 0;
  if constexpr (kSrc == FLAT) {
    smem = TAB * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<1, rows * 128 / L, smem, s>>>(tab, x, fac, out, steps, mask1, mask2,
                                       thresh);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, const float*, const float*,
                                 float*, int, int, int, int, int,
                                 cudaStream_t);

// K10: 8 lanes a thread, rows * 16 threads
constexpr Launcher kCondLaunch[3] = {launch<8, ROW, 0, NO_TERM>,
                                     launch<8, ROW, 1, NO_TERM>,
                                     launch<8, ROW, 2, NO_TERM>};
// K12: extract is K10's flat instantiation (the same function)
constexpr Launcher kSmemLaunch[2] = {launch<8, ROW, 0, NO_TERM>,
                                     launch<8, FLAT, 0, NO_TERM>};
// K13: 1,024 threads, 1 lane a thread at 8 rows and 8 at 64
constexpr int kNInv[4] = {0, 6, 12, 20};
constexpr Launcher kPressureLaunch[2][4] = {
    {launch<1, ROW, 0, 0>, launch<1, ROW, 0, 6>, launch<1, ROW, 0, 12>,
     launch<1, ROW, 0, 20>},
    {launch<8, ROW, 0, 0>, launch<8, ROW, 0, 6>, launch<8, ROW, 0, 12>,
     launch<8, ROW, 0, 20>}};

__global__ void __launch_bounds__(1024, 1)
    alloc_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n_elems, int n_floats) {
  extern __shared__ float buf[];
  if (threadIdx.x == 0) {
    buf[0] = x[0];
    buf[n_floats - 1] = x[1];
  }
  __syncthreads();
  const float s0 = buf[0], s1 = buf[n_floats - 1];
  for (int e = threadIdx.x; e < n_elems; e += blockDim.x)
    out[e] = (x[e] + s0) + s1;
}

}  // namespace

// K10.  mode: index into rtrt_tpu_torch/tools/probe_cond.py::MODES; rows:
// a multiple of 8 up to 64 (the wrapper checks)
extern "C" int rtrt_probe_cond(int mode, const float* tab, const float* x,
                               float* out, int rows, int steps, int mask1,
                               int mask2, int thresh, void* stream) {
  if (mode < 0 || mode >= 3) return cudaErrorInvalidValue;
  return static_cast<int>(kCondLaunch[mode](
      tab, x, nullptr, out, rows, steps, mask1, mask2, thresh,
      static_cast<cudaStream_t>(stream)));
}

// K12.  mode: index into rtrt_tpu_torch/tools/probe_smem.py::MODES
extern "C" int rtrt_probe_smem_consume(int mode, const float* tab,
                                       const float* x, float* out, int rows,
                                       int steps, void* stream) {
  if (mode < 0 || mode >= 2) return cudaErrorInvalidValue;
  return static_cast<int>(kSmemLaunch[mode](
      tab, x, nullptr, out, rows, steps, 0, 0, 0,
      static_cast<cudaStream_t>(stream)));
}

// K13.  n_inv in {0, 6, 12, 20}; rows 8 or 64; fac: n_inv floats (unused
// at 0)
extern "C" int rtrt_probe_pressure(int n_inv, const float* tab,
                                   const float* x, const float* fac,
                                   float* out, int rows, int steps,
                                   void* stream) {
  int which = -1;
  for (int i = 0; i < 4; ++i)
    if (kNInv[i] == n_inv) which = i;
  if (which < 0 || (rows != 8 && rows != 64)) return cudaErrorInvalidValue;
  return static_cast<int>(kPressureLaunch[rows == 64][which](
      tab, x, fac, out, rows, steps, 0, 0, 0,
      static_cast<cudaStream_t>(stream)));
}

// K11.  x, out: (rows, 128), 1,024 threads; n_floats >= 1.  Returns 0
// when the kernel launched, RTRT_SMEM_REFUSED (-1) when the runtime
// refused the n_floats * 4 bytes of dynamic shared memory
// (cudaErrorInvalidValue from cudaFuncSetAttribute or the launch; the
// error is cleared), any other cudaError as it is.
extern "C" int rtrt_probe_smem_alloc(const float* x, float* out, int rows,
                                     int n_floats, void* stream) {
  if (n_floats < 1 || n_floats > (1 << 28)) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(n_floats) * sizeof(float);
  // up to 48 KB a block needs no opt-in (the attribute's default, which
  // only this entry point raises, and only above 48 KB)
  cudaError_t e = cudaSuccess;
  if (bytes > kSmemDefault)
    e = cudaFuncSetAttribute(alloc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e == cudaSuccess) {
    alloc_kernel<<<1, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(
        x, out, rows * 128, n_floats);
    e = cudaGetLastError();
  }
  if (e == cudaErrorInvalidValue) {
    cudaGetLastError();  // clear it: the refusal is the result
    return RTRT_SMEM_REFUSED;
  }
  return static_cast<int>(e);
}

// The largest dynamic shared memory a block may opt into on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), in bytes.
extern "C" int rtrt_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}
