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
// K10 and K12 (`free_consume_kernel<kSrc, kCond>`, t(v1) = v1): one
// kernel, the variants template parameters:
//   kSrc  ROW:  value c of row (base / 8) at 16 (c / 9) + c % 9, base =
//               (7 k) % 997, from global memory (uniform loads that hit
//               L1): a record's 9 values by two 16-byte loads and one
//               4-byte load, 24 loads a step — K10, K12 extract;
//         FLAT: the table staged once into dynamic shared memory (64 KiB)
//               by bulk asynchronous copies completing on an mbarrier,
//               value c at flat index (base + 16 (c / 9) + c % 9) % 8000,
//               72 broadcast reads a step — K12 smem, another function
//               than extract (the TPU probe's SMEM read).  base + 16 r + v
//               <= 996 + 120 < 8000, so the modulo is the identity on every
//               step and the kernel reads stab[base + off] without it
//               (static_assert below)
//   kCond 0, 1 or 2 branches around the consume (K10 flat, cond, cond2):
//         if ((k & mask1) >= thresh) [if ((k & mask2) >= thresh)].  The
//         masks (1023, 511) and the threshold (0) are kernel arguments, so
//         the compiler cannot fold the always-true tests away; the tests
//         depend on k alone, so every branch is warp-uniform
// What bounds them on the H100: float issue, 24 x 4 operations per lane
// per step (mul, add, add, min: the products through __fmul_rn, so no
// FMA forms and perfect issue reaches at most half the float32 bound).
// Design: k depends on element (0, 0)'s accumulator alone, whose inputs
// (x[0, 0] and the table) are read-only.  So the tile splits over c =
// ceil(rows / 16) plain blocks of ceil(rows / c) rows (tools/
// probe_cond.py::launch_geometry: 4 at 64 rows, 1 at 8; the last block
// masks the lanes past the tile), one an SM, and every thread steps
// element (0, 0) itself as one more lane (the shadow) in the same
// unrolled terms as its CONSUME_L lanes, with the same __fmul_rn products
// in the same order: its flag is bit for bit the one of the thread that
// holds element (0, 0).  No flag crosses a warp: no shared flag, no
// barrier in the step loop, and the warps run free (the shadow costs
// 1 / CONSUME_L more float issue).  CONSUME_L = 16 lanes a thread: 4 warps
// an SM at 16 rows a block, one a sub-partition, each with 17 independent
// chains (of 4, 8 and 16 lanes, none of which spills, 16 was the fastest
// in every mode on an NVIDIA H100 80GB HBM3 at 700 W: PERF.md, K10).  The
// next step's row is loaded while this step's terms run, record by
// record, on the guess that the flag is 0 (k + 1); where it comes out 1
// the row of k + 2 is loaded again.  The values are the same either way,
// so the result stays exact.  (In FLAT ptxas moves the shared-memory
// reads behind the flag, each into the next step's terms: their latency
// is short.)  One block an SM: each launch asks for GUARD_SMEM bytes of
// dynamic shared memory (as K16, csrc/probe_bf16.cu), the FLAT table in
// its first 64 KiB.
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
// thread 0 writes the flag into shared memory (two slots: the next step's
// write never races this step's reads) and
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
// is.  What bounds it: x read and out written once (bytes), far below a
// launch's own latency.  Design: a grid of c = rows / 8 blocks
// (ALLOC_BLOCK_ROWS rows, 256 threads, one float4 load and one float4
// store a thread; x 16-byte aligned), each asking for the n-float buffer:
// the runtime grants dynamic shared memory a block, so the edge is the
// one-block launch's, and at the opt-in maximum each block has its SM to
// itself.  Thread 0 of each block writes buf[0] and buf[n - 1], one
// barrier, then every thread reads both.
#include <cstdint>

#include "probe_common.cuh"

namespace {

enum Src { ROW, FLAT };
constexpr int TAB = 128 * 128;
constexpr int RTRT_SMEM_REFUSED = -1;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr int GUARD_SMEM = 120 * 1024;

// K10 / K12
constexpr int CONSUME_L = 16;  // lanes a thread
constexpr int CONSUME_MAX_BLOCK_ROWS = 16;
constexpr int CONSUME_THREADS = CONSUME_MAX_BLOCK_ROWS * 128 / CONSUME_L;
constexpr int RECORDS = 8, RECORD = 9;  // a step: 8 records of 9 values
// The staged read's flat index base + 16 r + v: base = (7 k) % 997 <=
// 996, 16 r + v <= 16 x 7 + 8 = 120; below 8000, so the function's
// % 8000 never wraps and the kernel drops it
constexpr int BASE_MAX = 996, OFF_MAX = 16 * (RECORDS - 1) + RECORD - 1;
static_assert(BASE_MAX + OFF_MAX < 8000, "the staged read would wrap");
constexpr int STAGE_CHUNK = 16 * 1024;  // bytes a bulk copy
static_assert(TAB * 4 % STAGE_CHUNK == 0 && TAB * 4 <= GUARD_SMEM,
              "the table fills whole chunks inside the guard");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The whole table into stab by bulk asynchronous copies (the TMA's
// unit), which thread 0 issues and waits for on an mbarrier; the block
// barrier after it is the kernel's only one.  tab: 16-byte aligned (the
// wrapper checks).
__device__ __forceinline__ void stage_table(const float* __restrict__ tab,
                                            float* stab) {
  __shared__ __align__(8) unsigned long long bar;
  if (threadIdx.x == 0) {
    const unsigned b = smem_addr(&bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "{\n.reg .b64 st;\n"
        "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
            b),
        "r"(TAB * 4)
        : "memory");
#pragma unroll
    for (int c = 0; c < TAB * 4 / STAGE_CHUNK; ++c)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(stab) + c * STAGE_CHUNK),
          "l"(reinterpret_cast<uintptr_t>(tab + c * (STAGE_CHUNK / 4))),
          "r"(STAGE_CHUNK), "r"(b)
          : "memory");
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" ::"r"(b),
        "r"(0u)
        : "memory");
  }
  __syncthreads();
}

// Record r (values 16 r .. 16 r + 8 of the step's row) of the step at
// `base` into v.
template <int kSrc>
__device__ __forceinline__ void load_record(const float* __restrict__ tab,
                                            const float* stab, int base,
                                            int r, float (&v)[RECORD]) {
  if constexpr (kSrc == ROW) {
    const float* p = tab + (base >> 3) * 128 + 16 * r;
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    v[8] = __ldg(p + 8);
  } else {
    const float* p = stab + base + 16 * r;  // no % 8000: BASE_MAX above
#pragma unroll
    for (int q = 0; q < RECORD; ++q) v[q] = p[q];
  }
}

// One step on a thread's lanes and the shadow: record r's 3 terms (term q
// takes values 3 q .. 3 q + 2, in the function's order), then record r of
// the row at `next` into the same registers.  kOn false: the loads only
// (a cond mode's branch that skips the consume).
template <int kSrc, bool kOn>
__device__ __forceinline__ void consume_step(
    const float* __restrict__ tab, const float* stab, int next,
    float (&v)[RECORDS][RECORD], float (&acc)[CONSUME_L], float& shadow) {
  using probe::mul;
#pragma unroll
  for (int r = 0; r < RECORDS; ++r) {
    if constexpr (kOn) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float v0 = v[r][3 * q], v1 = v[r][3 * q + 1],
                    v2 = v[r][3 * q + 2];
#pragma unroll
        for (int j = 0; j < CONSUME_L; ++j)
          acc[j] = fminf(mul(acc[j], v0) + v1, v2 + acc[j]);
        shadow = fminf(mul(shadow, v0) + v1, v2 + shadow);
      }
    }
    load_record<kSrc>(tab, stab, next, r, v[r]);
  }
}

// Block b holds lanes b * n * L .. (b + 1) * n * L - 1 of the tile (n =
// blockDim.x, whole warps; lane j of thread t: + t + j * n); a lane at or
// past `lanes` computes on 0 and stores nothing.  Every thread carries the
// shadow, element (0, 0), and derives k from it.
template <int kSrc, int kCond>
__global__ void __launch_bounds__(CONSUME_THREADS, 1)
    free_consume_kernel(const float* __restrict__ tab,
                        const float* __restrict__ x, float* __restrict__ out,
                        int lanes, int steps, int mask1, int mask2,
                        int thresh) {
  extern __shared__ float4 smem[];
  float* stab = reinterpret_cast<float*>(smem);  // FLAT: the staged table
  if constexpr (kSrc == FLAT) stage_table(tab, stab);
  constexpr int L = CONSUME_L;
  const int n = blockDim.x;
  const int e0 = blockIdx.x * n * L + threadIdx.x;
  float acc[L], shadow = x[0], v[RECORDS][RECORD];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int e = e0 + j * n;
    acc[j] = e < lanes ? x[e] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < RECORDS; ++r) load_record<kSrc>(tab, stab, 0, r, v[r]);
  int k = 0;
#pragma unroll 1
  while (k < steps) {
    const int next = ((k + 1) * 7) % 997;  // the guess: the flag is 0
    if constexpr (kCond == 0) {
      consume_step<kSrc, true>(tab, stab, next, v, acc, shadow);
    } else if constexpr (kCond == 1) {
      if ((k & mask1) >= thresh)
        consume_step<kSrc, true>(tab, stab, next, v, acc, shadow);
      else
        consume_step<kSrc, false>(tab, stab, next, v, acc, shadow);
    } else {
      if ((k & mask1) >= thresh) {
        if ((k & mask2) >= thresh)
          consume_step<kSrc, true>(tab, stab, next, v, acc, shadow);
        else
          consume_step<kSrc, false>(tab, stab, next, v, acc, shadow);
      } else {
        consume_step<kSrc, false>(tab, stab, next, v, acc, shadow);
      }
    }
    if (shadow > 1e30f) {  // the flag: k + 2, whose row is loaded again
      k += 2;
      const int base = (k * 7) % 997;
#pragma unroll
      for (int r = 0; r < RECORDS; ++r)
        load_record<kSrc>(tab, stab, base, r, v[r]);
    } else {
      k += 1;
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int e = e0 + j * n;
    if (e < lanes) out[e] = acc[j];
  }
}

template <int kSrc, int kCond>
cudaError_t launch_consume(const float* tab, const float* x, float* out,
                           int rows, int steps, int mask1, int mask2,
                           int thresh, int blocks, int block_rows,
                           cudaStream_t s) {
  const auto kern = free_consume_kernel<kSrc, kCond>;
  // once an instantiation: the residency guard is above the 48 KB that a
  // launch may take without opting in
  static cudaError_t optin = cudaErrorNotReady;
  if (optin == cudaErrorNotReady)
    optin = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GUARD_SMEM);
  if (optin != cudaSuccess) return optin;
  // whole warps: block_rows x 128 / L threads, rounded up to 32
  const int threads =
      (block_rows * 128 + 32 * CONSUME_L - 1) / (32 * CONSUME_L) * 32;
  kern<<<blocks, threads, GUARD_SMEM, s>>>(tab, x, out, rows * 128, steps,
                                           mask1, mask2, thresh);
  return cudaGetLastError();
}

using ConsumeLauncher = cudaError_t (*)(const float*, const float*, float*,
                                        int, int, int, int, int, int, int,
                                        cudaStream_t);

// K10: flat, cond, cond2
constexpr ConsumeLauncher kCondLaunch[3] = {launch_consume<ROW, 0>,
                                            launch_consume<ROW, 1>,
                                            launch_consume<ROW, 2>};
// K12: extract is K10's flat instantiation (the same function), smem
constexpr ConsumeLauncher kSmemLaunch[2] = {launch_consume<ROW, 0>,
                                            launch_consume<FLAT, 0>};

// K13
constexpr int PRESSURE_L = 4;  // lanes a thread
constexpr int PRESSURE_MAX_BLOCK_ROWS = 16;
constexpr int PRESSURE_THREADS = PRESSURE_MAX_BLOCK_ROWS * 128 / PRESSURE_L;
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

constexpr int ALLOC_BLOCK_ROWS = 8;
constexpr int ALLOC_THREADS = ALLOC_BLOCK_ROWS * 128 / 4;  // a float4 each

__global__ void __launch_bounds__(ALLOC_THREADS)
    alloc_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n_floats) {
  extern __shared__ float buf[];
  if (threadIdx.x == 0) {
    buf[0] = x[0];
    buf[n_floats - 1] = x[1];
  }
  __syncthreads();
  const float s0 = buf[0], s1 = buf[n_floats - 1];
  const int e = blockIdx.x * ALLOC_THREADS + threadIdx.x;
  float4 q = __ldg(reinterpret_cast<const float4*>(x) + e);
  q.x = (q.x + s0) + s1;
  q.y = (q.y + s0) + s1;
  q.z = (q.z + s0) + s1;
  q.w = (q.w + s0) + s1;
  reinterpret_cast<float4*>(out)[e] = q;
}

}  // namespace

namespace {

// The launch geometry and the table's alignment that K10 and K12 take:
// blocks, block_rows from tools/probe_cond.py::launch_geometry(rows)
// (block_rows at most 16, blocks x block_rows >= rows), tab 16-byte
// aligned (its records are read by float4, the FLAT table staged by bulk
// copies)
bool consume_args_ok(const float* tab, int rows, int blocks,
                     int block_rows) {
  return rows >= 1 && blocks >= 1 && block_rows >= 1 &&
         block_rows <= CONSUME_MAX_BLOCK_ROWS && blocks * block_rows >= rows &&
         reinterpret_cast<uintptr_t>(tab) % 16 == 0;
}

}  // namespace

// K10.  mode: index into rtrt_tpu_torch/tools/probe_cond.py::MODES; rows:
// a multiple of 8 up to 64 (the wrapper checks)
extern "C" int rtrt_probe_cond(int mode, const float* tab, const float* x,
                               float* out, int rows, int steps, int mask1,
                               int mask2, int thresh, int blocks,
                               int block_rows, void* stream) {
  if (mode < 0 || mode >= 3 || !consume_args_ok(tab, rows, blocks,
                                                block_rows))
    return cudaErrorInvalidValue;
  return static_cast<int>(kCondLaunch[mode](
      tab, x, out, rows, steps, mask1, mask2, thresh, blocks, block_rows,
      static_cast<cudaStream_t>(stream)));
}

// K12.  mode: index into rtrt_tpu_torch/tools/probe_smem.py::MODES; the
// rest as K10's
extern "C" int rtrt_probe_smem_consume(int mode, const float* tab,
                                       const float* x, float* out, int rows,
                                       int steps, int blocks, int block_rows,
                                       void* stream) {
  if (mode < 0 || mode >= 2 || !consume_args_ok(tab, rows, blocks,
                                                block_rows))
    return cudaErrorInvalidValue;
  return static_cast<int>(kSmemLaunch[mode](
      tab, x, out, rows, steps, 0, 0, 0, blocks, block_rows,
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

// K11.  x, out: (rows, 128), 16-byte aligned; rows: a multiple of
// ALLOC_BLOCK_ROWS up to 64 (rows / ALLOC_BLOCK_ROWS blocks); n_floats >=
// 1.  Returns 0 when the kernel launched, RTRT_SMEM_REFUSED (-1) when the
// runtime refused the n_floats * 4 bytes of dynamic shared memory a block
// (cudaErrorInvalidValue from cudaFuncSetAttribute or the launch; the
// error is cleared), any other cudaError as it is (cudaErrorInvalidValue
// itself for arguments it does not take).
extern "C" int rtrt_probe_smem_alloc(const float* x, float* out, int rows,
                                     int n_floats, void* stream) {
  if (n_floats < 1 || n_floats > (1 << 28) || rows < ALLOC_BLOCK_ROWS ||
      rows > 64 || rows % ALLOC_BLOCK_ROWS ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(n_floats) * sizeof(float);
  // up to 48 KB a block needs no opt-in (the attribute's default, which
  // only this entry point raises, and only above 48 KB)
  cudaError_t e = cudaSuccess;
  if (bytes > kSmemDefault)
    e = cudaFuncSetAttribute(alloc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e == cudaSuccess) {
    alloc_kernel<<<rows / ALLOC_BLOCK_ROWS, ALLOC_THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(x, out, n_floats);
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
