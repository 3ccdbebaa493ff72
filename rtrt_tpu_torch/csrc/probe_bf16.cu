// K16: vector math in bf16 against float32, one thread block per
// (rows, 128) tile.
//
// Replaces: tools/probe_bf16.py::make_kernel (pallas_call at
// probe_bf16.py:65).  Eight independent serial chains per lane, c_i = x +
// i in the working type, each step c = min(max((c * one + 0.5) - c * 0.5,
// -3), 3) with one = the type's rounding of 1.0000001 (a kernel argument,
// so that c * one is not folded away); out = float(((c0 + c1) + ...) +
// c7), the sum in the working type.  Modes (a template parameter):
//   F32   float32 chains, products through __fmul_rn (no contraction)
//   BF16  the same chains on __nv_bfloat162 pairs (lanes 2p and 2p + 1 of a
//         thread share a register), every operation rounded to bf16 by
//         the native bf16x2 instructions; the *_rn intrinsics are never
//         contracted into fma.rn.bf16x2.  Half the registers hold a plane:
//         the question the TPU probe asked.
// What bounds it on the H100: 48 operations per lane per step (6 per
// chain) on the one SM, at the float32 rate or twice it through packed
// bf16x2 issue.  8 chains x 8 lanes of float32 are 64 values a thread,
// the whole 64-register budget of a 1,024-thread block, so F32 also pays
// for what does not fit; BF16 holds 32.
#include <cuda_bf16.h>

#include "probe_common.cuh"

namespace {

constexpr int L = 8;  // lanes per thread
constexpr int CHAINS = 8;

__global__ void __launch_bounds__(1024, 1)
    chains_f32(const float* __restrict__ x, float* __restrict__ out,
               float one, int steps) {
  using probe::mul;
  const int n = blockDim.x;
  float c[CHAINS][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float xv = x[threadIdx.x + j * n];
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
    out[threadIdx.x + j * n] = acc;
  }
}

__global__ void __launch_bounds__(1024, 1)
    chains_bf16(const float* __restrict__ x, float* __restrict__ out,
                float one_f, int steps) {
  constexpr int P = L / 2;  // bf16x2 pairs per chain
  const int n = blockDim.x;
  const __nv_bfloat162 one = __float2bfloat162_rn(one_f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 lo = __float2bfloat162_rn(-3.0f);
  const __nv_bfloat162 hi = __float2bfloat162_rn(3.0f);
  __nv_bfloat162 c[CHAINS][P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat162 xv = __floats2bfloat162_rn(
        x[threadIdx.x + 2 * p * n], x[threadIdx.x + (2 * p + 1) * n]);
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
    out[threadIdx.x + 2 * p * n] = __low2float(acc);
    out[threadIdx.x + (2 * p + 1) * n] = __high2float(acc);
  }
}

}  // namespace

// K16.  bf16: 0 for float32 chains, 1 for bf16; x, out: (rows, 128) f32;
// one: 1.0000001f (rounded to bf16 in the bf16 mode); rows: a multiple of
// 8 up to 64 (8 lanes a thread, rows * 16 threads)
extern "C" int rtrt_probe_bf16(int bf16, const float* x, float* out,
                               float one, int rows, int steps,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16 == 0)
    chains_f32<<<1, rows * 16, 0, s>>>(x, out, one, steps);
  else if (bf16 == 1)
    chains_bf16<<<1, rows * 16, 0, s>>>(x, out, one, steps);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
