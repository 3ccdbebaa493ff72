// K16: vector math in bf16 against float32, the (rows, 128) tile split
// over c blocks on c SMs.
//
// Replaces: tools/probe_bf16.py::make_kernel (pallas_call at
// probe_bf16.py:65).  Eight independent serial chains per lane, c_i = x +
// i in the working type, each step c = min(max((c * one + 0.5) - c * 0.5,
// -3), 3) with one = the type's rounding of 1.0000001 (a kernel argument,
// so that c * one is not folded away); out = float(((c0 + c1) + ...) +
// c7), the sum in the working type.  Modes (the kernel):
//   chains_f32   float32 chains, products through __fmul_rn (no
//                contraction)
//   chains_bf16  the same chains on __nv_bfloat162 pairs (lanes 2p and
//                2p + 1 of a thread share a register), every operation
//                rounded to bf16 by the native bf16x2 instructions; the
//                *_rn intrinsics are never contracted into fma.rn.bf16x2.
//                Half the registers hold a plane: the question the TPU
//                probe asked.
// What bounds it on the H100: 48 operations per lane per step (6 per
// chain) on the SMs the tile fills, at the float32 rate or twice it
// through packed bf16x2 issue.
//
// Design: a lane's chains never meet another lane's: no
// reduction, no stack, no shared scalar.  So the tile need not sit on one
// SM, where its float32 state (64 x 128 lanes x 8 chains x 4 B = 256 KiB,
// the whole register file) spilled and the bf16 / f32 ratio measured the
// spill.  The launch is a grid of c = ceil(rows / 16) plain blocks of
// ceil(rows / c) rows each (tools/probe_bf16.py::launch_geometry; the
// last block masks the lanes past the tile), L = 2 lanes a thread (of 2, 4
// and 8, none of which spills, 2 was the fastest in both modes on an
// NVIDIA H100 80GB HBM3 at 700 W by 0.2-2.7%: PERF.md, K16).  Both modes
// fill the same c SMs, so their ratio compares issue rates only.  One
// block an SM: each launch asks for GUARD_SMEM bytes of dynamic shared
// memory that it never touches, more than half of an SM's 228 KB, so no
// second block of the grid can share an SM with the first (the smaller
// thread counts would otherwise let the scheduler pair them).
#include <cuda_bf16.h>

#include "probe_common.cuh"

namespace {

constexpr int CHAINS = 8;
constexpr int MAX_BLOCK_ROWS = 16;
constexpr int MAX_BLOCK_LANES = MAX_BLOCK_ROWS * 128;
constexpr int GUARD_SMEM = 120 * 1024;
constexpr int L = 2;  // lanes a thread; in the bf16 mode one bf16x2 pair
constexpr int THREADS = MAX_BLOCK_LANES / L;

__global__ void __launch_bounds__(THREADS, 1)
    chains_f32(const float* __restrict__ x, float* __restrict__ out,
               float one, int steps, int lanes) {
  using probe::mul;
  const int n = blockDim.x;
  const int e0 = blockIdx.x * n * L + threadIdx.x;  // lane j: e0 + j * n
  float c[CHAINS][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int e = e0 + j * n;
    const float xv = e < lanes ? x[e] : 0.0f;
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) c[i][j] = xv + static_cast<float>(i);
  }
  for (int k = 0; k < steps; ++k) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float t = (mul(c[i][j], one) + 0.5f) - mul(c[i][j], 0.5f);
        c[i][j] = fminf(fmaxf(t, -3.0f), 3.0f);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float acc = c[0][j];
#pragma unroll
    for (int i = 1; i < CHAINS; ++i) acc = acc + c[i][j];
    const int e = e0 + j * n;
    if (e < lanes) out[e] = acc;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    chains_bf16(const float* __restrict__ x, float* __restrict__ out,
                float one_f, int steps, int lanes) {
  constexpr int P = L / 2;  // bf16x2 pairs a chain
  const int n = blockDim.x;
  const int e0 = blockIdx.x * n * L + threadIdx.x;
  const __nv_bfloat162 one = __float2bfloat162_rn(one_f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 lo = __float2bfloat162_rn(-3.0f);
  const __nv_bfloat162 hi = __float2bfloat162_rn(3.0f);
  __nv_bfloat162 c[CHAINS][P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int a = e0 + 2 * p * n, b = a + n;
    const __nv_bfloat162 xv = __floats2bfloat162_rn(
        a < lanes ? x[a] : 0.0f, b < lanes ? x[b] : 0.0f);
#pragma unroll
    for (int i = 0; i < CHAINS; ++i)
      c[i][p] = __hadd2_rn(xv, __float2bfloat162_rn(static_cast<float>(i)));
  }
  for (int k = 0; k < steps; ++k) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const __nv_bfloat162 t = __hsub2_rn(
            __hadd2_rn(__hmul2_rn(c[i][p], one), half),
            __hmul2_rn(c[i][p], half));
        c[i][p] = __hmin2(__hmax2(t, lo), hi);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    __nv_bfloat162 acc = c[0][p];
#pragma unroll
    for (int i = 1; i < CHAINS; ++i) acc = __hadd2_rn(acc, c[i][p]);
    const int a = e0 + 2 * p * n, b = a + n;
    if (a < lanes) out[a] = __low2float(acc);
    if (b < lanes) out[b] = __high2float(acc);
  }
}

int launch(bool bf16, const float* x, float* out, float one, int blocks,
           int block_rows, int lanes, int steps, cudaStream_t s) {
  const auto k = bf16 ? chains_bf16 : chains_f32;
  // once a kernel: the residency guard is above the 48 KB that a launch
  // may take without opting in
  static cudaError_t optin[2] = {cudaErrorNotReady, cudaErrorNotReady};
  if (optin[bf16] == cudaErrorNotReady)
    optin[bf16] = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, GUARD_SMEM);
  if (optin[bf16] != cudaSuccess) return static_cast<int>(optin[bf16]);
  k<<<blocks, block_rows * 128 / L, GUARD_SMEM, s>>>(x, out, one, steps,
                                                     lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K16.  bf16: 0 for float32 chains, 1 for bf16; x, out: (rows, 128) f32;
// one: 1.0000001f (rounded to bf16 in the bf16 mode); blocks, block_rows:
// tools/probe_bf16.py::launch_geometry(rows) (block_rows at most 16,
// blocks x block_rows >= rows)
extern "C" int rtrt_probe_bf16(int bf16, const float* x, float* out,
                               float one, int rows, int steps, int blocks,
                               int block_rows, void* stream) {
  if ((bf16 != 0 && bf16 != 1) || blocks < 1 || block_rows < 1 ||
      block_rows > MAX_BLOCK_ROWS || blocks * block_rows < rows)
    return cudaErrorInvalidValue;
  return launch(bf16, x, out, one, blocks, block_rows, rows * 128, steps,
                static_cast<cudaStream_t>(stream));
}
