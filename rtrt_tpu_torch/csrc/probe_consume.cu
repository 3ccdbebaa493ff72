// K10-K13: the 72-value consume loop of the TPU probes on a (rows, 128)
// tile, and K11's shared-memory capacity probe.
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
// the next k is k + 1 + (acc[0, 0] > 1e30).
//
// K10 and K12: one thread block per tile, 8 lanes a thread (rows * 16
// threads), one device function, the variants template parameters:
//   kSrc  ROW:  value c of row (base / 8) at 16 (c / 9) + c % 9, base =
//               (7 k) % 997, read by every thread from global memory (a
//               uniform load that hits L1) — K10, K12 extract;
//         FLAT: the table staged once into dynamic shared memory (64 KiB,
//               above the 48 KB default: an opt-in), value c at flat index
//               (base + 16 (c / 9) + c % 9) % 8000 — K12 smem, another
//               function than extract (the TPU probe's SMEM read)
//   kCond 0, 1 or 2 branches around the consume (K10 flat, cond, cond2):
//         if ((k & mask1) >= thresh) [if ((k & mask2) >= thresh)].  The
//         masks (1023, 511) and the threshold (0) are kernel arguments, so
//         the compiler cannot fold the always-true tests away
//   kInv  NO_TERM: t(v1) = v1.  The template's other branches (0: v1 *
//         0.5; n > 0: v1 * inv[(i / 3) % n]) have no instantiation: K13
//         runs its own kernel, below
// acc[0, 0] belongs to thread 0's lane 0; thread 0 writes the step's flag
// to shared memory and one barrier publishes it: the Hopper form of the
// TPU's vector-to-scalar sync, every step, part of what is measured.  The
// flag alternates between two slots, so the next step's write never races
// this step's reads.  What bounds them on the H100: float issue on the one
// SM that runs the tile (24 x 4 operations per lane per step), the
// barrier, and the 72 uniform loads per thread per step.  They say
// __launch_bounds__(1024, 1): without the one-block minimum ptxas gave
// them 32 registers and spilled, aiming at two blocks an SM that never
// come.
//
// K13 (`pressure_kernel`): t(v1) = v1 * 0.5 without planes (one product
// per term), v1 * inv[(i / 3) % n] with n = n_inv > 0 planes inv[p] = x *
// fac[p], the factors 1 + 0.01 p from a global array the loop never
// writes, so the planes are computed once before the loop and held in
// registers; the output adds x (sum(inv[:1])) when n_inv > 0.  What bounds
// it: 24 x 5 operations per lane per step (24 x 4 without planes).
// Design: k depends on element (0, 0)'s accumulator alone, whose inputs
// (x[0, 0], the factors, the table) are read-only.  So the tile splits
// over c = rows / 16 plain blocks (tools/probe_pressure.py::
// launch_geometry: 4 at 64 rows, 1 of 8 rows at 8), one an SM, and each
// block computes element (0, 0) itself: warp 0 carries it as a shadow
// lane besides its own, with the same __fmul_rn products in the same
// order, so its flag is bit for bit the one of the thread that holds
// element (0, 0), and no flag crosses an SM.  Warp 0 runs its own copy of
// the step loop, the shadow in the same unrolled terms as its lanes;
// thread 0 writes the flag into shared memory (two slots, as above) and
// one barrier a step publishes it.  (A shadow in a 17th warp puts 5 warps
// on one SM sub-partition, whose 16K registers then cap every thread at
// 96: the planes spill.  A shadow stepped apart from warp 0's lanes ran
// its dependent chain alone while the other warps waited: PERF.md, K13.)
// PRESSURE_L lanes a thread: 16 rows a block of 512 threads, 80 planes
// and 4 accumulators a thread at 20 planes under 128 registers (PERF.md,
// K13: the lanes swept).  A record's 9 values arrive by two 16-byte loads
// and one 4-byte load: 24 loads a step, not 72.  One block an SM: each
// launch asks for GUARD_SMEM bytes of dynamic shared memory that it never
// touches (as K16, csrc/probe_bf16.cu); the rest of the SM's 256 KB of L1
// and shared memory still holds the 64 KB table.
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
// K13
constexpr int PRESSURE_L = 4;  // lanes a thread
constexpr int PRESSURE_MAX_BLOCK_ROWS = 16;
constexpr int PRESSURE_THREADS = PRESSURE_MAX_BLOCK_ROWS * 128 / PRESSURE_L;
constexpr int GUARD_SMEM = 120 * 1024;
constexpr int kNInv[4] = {0, 6, 12, 20};

// The barrier that ends a step, called from K13's two loops (warp 0's and
// the other warps'): PTX bar.sync from two code paths, each taken by whole
// warps
__device__ __forceinline__ void step_barrier() {
  asm volatile("bar.sync 0;" ::: "memory");
}

// One step of K13 on a thread's L lanes and, in warp 0 (kShadow), on the
// shadow lane besides them, in the same unrolled terms, so that the
// shadow's chain interleaves with the lanes' chains: the row's 8 records
// by two 16-byte loads and one 4-byte load each; term 3 r + q takes values
// 3 q .. 3 q + 2 of record r, in consume()'s order.  The shadow's planes
// are read from shared memory at each use (volatile: not held in
// registers beside the lanes' planes).
template <int kInv, bool kShadow>
__device__ __forceinline__ void pressure_step(
    const float* __restrict__ row, float (&acc)[PRESSURE_L], float& shadow,
    const float (&inv)[kInv > 0 ? kInv : 1][PRESSURE_L],
    const volatile float* shadow_plane) {
  using probe::mul;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + 16 * r));
    const float4 b =
        __ldg(reinterpret_cast<const float4*>(row + 16 * r + 4));
    const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                        __ldg(row + 16 * r + 8)};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float v0 = v[3 * q], v1 = v[3 * q + 1], v2 = v[3 * q + 2];
      if constexpr (kInv == 0) {
        const float w = mul(v1, 0.5f);
#pragma unroll
        for (int j = 0; j < PRESSURE_L; ++j)
          acc[j] = fminf(mul(acc[j], v0) + w, v2 + acc[j]);
        if constexpr (kShadow)
          shadow = fminf(mul(shadow, v0) + w, v2 + shadow);
      } else {
        const int p = (3 * r + q) % kInv;
#pragma unroll
        for (int j = 0; j < PRESSURE_L; ++j)
          acc[j] = fminf(mul(acc[j], v0) + mul(v1, inv[p][j]), v2 + acc[j]);
        if constexpr (kShadow)
          shadow = fminf(mul(shadow, v0) + mul(v1, shadow_plane[p]),
                         v2 + shadow);
      }
    }
  }
}

// The step loop of one warp.  Each step ends at the block barrier after
// which every thread reads the step's flag.  The empty asm statements keep
// the lanes' terms of a step before its barrier in the compiler's order:
// terms moved past it would leave warp 0's shadow chain to run alone at
// the end of the step while the other warps wait.
template <int kInv, bool kShadow>
__device__ __forceinline__ void pressure_loop(
    const float* __restrict__ tab, int steps, float (&acc)[PRESSURE_L],
    float& shadow, const float (&inv)[kInv > 0 ? kInv : 1][PRESSURE_L],
    const volatile float* shadow_plane, int* flag) {
  int k = 0;
  for (int s = 0; k < steps; ++s) {
    pressure_step<kInv, kShadow>(tab + (((k * 7) % 997) >> 3) * 128, acc,
                                 shadow, inv, shadow_plane);
    if (kShadow && threadIdx.x == 0) flag[s & 1] = shadow > 1e30f;
#pragma unroll
    for (int j = 0; j < PRESSURE_L; ++j) asm volatile("" ::"f"(acc[j]));
    step_barrier();
    k += 1 + flag[s & 1];
  }
}

// Block b holds lanes b * n * L .. (b + 1) * n * L - 1 of the tile (n =
// blockDim.x; lane j of thread t: + t + j * n).  Warp 0 also carries the
// shadow: element (0, 0) as one more lane, its planes in shared memory
// (the same products, computed once).
template <int kInv>
__global__ void __launch_bounds__(PRESSURE_THREADS, 1)
    pressure_kernel(const float* __restrict__ tab,
                    const float* __restrict__ x, const float* fac,
                    float* __restrict__ out, int steps) {
  using probe::mul;
  constexpr int L = PRESSURE_L, NI = kInv > 0 ? kInv : 1;
  __shared__ int flag[2];
  __shared__ float shadow_plane[NI];
  const int n = blockDim.x;
  const int e0 = blockIdx.x * n * L + threadIdx.x;
  float acc[L], inv[NI][L], shadow = x[0];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    acc[j] = x[e0 + j * n];
#pragma unroll
    for (int p = 0; p < NI; ++p) {
      // an identity shuffle: the plane is the product, but ptxas cannot
      // recompute a shuffle in the loop, so the planes stay held (else it
      // may recompute them from x and the factors every step to save
      // registers: 80 products a thread at 20 planes)
      if constexpr (kInv > 0)
        inv[p][j] = __shfl_sync(0xffffffffu, mul(acc[j], fac[p]),
                                threadIdx.x & 31);
      else
        inv[p][j] = 0.0f;
    }
  }
  if constexpr (kInv > 0) {
    if (threadIdx.x < kInv)
      shadow_plane[threadIdx.x] = mul(shadow, fac[threadIdx.x]);
  }
  __syncthreads();
  if (threadIdx.x < 32)
    pressure_loop<kInv, true>(tab, steps, acc, shadow, inv, shadow_plane,
                              flag);
  else
    pressure_loop<kInv, false>(tab, steps, acc, shadow, inv, shadow_plane,
                               flag);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int e = e0 + j * n;
    out[e] = kInv > 0 ? acc[j] + x[e] : acc[j];
  }
}

template <int kInv>
cudaError_t launch_pressure(const float* tab, const float* x,
                            const float* fac, float* out, int blocks,
                            int block_rows, int steps, cudaStream_t s) {
  const auto kern = pressure_kernel<kInv>;
  // once an instantiation: the residency guard is above the 48 KB that a
  // launch may take without opting in
  static cudaError_t optin = cudaErrorNotReady;
  if (optin == cudaErrorNotReady)
    optin = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GUARD_SMEM);
  if (optin != cudaSuccess) return optin;
  kern<<<blocks, block_rows * 128 / PRESSURE_L, GUARD_SMEM, s>>>(
      tab, x, fac, out, steps);
  return cudaGetLastError();
}

using PressureLauncher = cudaError_t (*)(const float*, const float*,
                                         const float*, float*, int, int, int,
                                         cudaStream_t);
constexpr PressureLauncher kPressureLaunch[4] = {
    launch_pressure<0>, launch_pressure<6>, launch_pressure<12>,
    launch_pressure<20>};

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
// at 0); blocks, block_rows: tools/probe_pressure.py::launch_geometry(rows)
// (blocks x block_rows = rows, block_rows at most 16 and a multiple of
// 32 x PRESSURE_L / 128: whole warps)
extern "C" int rtrt_probe_pressure(int n_inv, const float* tab,
                                   const float* x, const float* fac,
                                   float* out, int rows, int steps,
                                   int blocks, int block_rows,
                                   void* stream) {
  int which = -1;
  for (int i = 0; i < 4; ++i)
    if (kNInv[i] == n_inv) which = i;
  if (which < 0 || (rows != 8 && rows != 64) || blocks < 1 ||
      block_rows < 1 || block_rows > PRESSURE_MAX_BLOCK_ROWS ||
      blocks * block_rows != rows || block_rows * 128 % (32 * PRESSURE_L))
    return cudaErrorInvalidValue;
  return static_cast<int>(kPressureLaunch[which](
      tab, x, fac, out, blocks, block_rows, steps,
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
