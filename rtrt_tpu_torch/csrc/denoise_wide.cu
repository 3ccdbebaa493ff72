// K4 joint-bilateral a-trous pass of the SVGF denoiser: (2r+1)^2 taps at a
// stride, each weighted by Gaussian x normal^sigma_n x depth x material,
// with an optional frame-alternating half kernel.
//
// Replaces: rtrt_tpu/denoise/spatial.py::_wide_kernel (launched by
// _wide_pass_pallas).  Math follows the XLA tap-accumulation form
// spatial.py::_edge_aware_pass, which the JAX frame runs off the TPU and
// which tests/test_denoise_post.py holds the Pallas kernel to.  The same
// kernel carries the 7x7 half-kernel pass (radius 3, stride 1), which the
// JAX package kept on XLA for a TPU reason only: four launches per frame
// (7x7, then strides 3, 6, 12).
//
// What bounds it on the H100: per pixel it must read 8 words (colour 3,
// normal 3, depth, material) and write 3 (44 B, 91 MB per 1080p pass,
// ~27 us at 3.35 TB/s); the 25 taps of each frame pass are ~20 float
// operations each (~1.1 G per 1080p pass, ~16 us at 67 TFLOP/s).  So it is
// a byte-bound function whose first form was bound by instructions: per
// tap an accurate powf (sigma_n = 64) and expf, eight scalar loads from
// three arrays of 12-byte pixels, and products kept unfused.
//
// Design:
//   * One block per 32x8 tile of a stride sub-lattice.  The pixels that
//     share (x mod s, y mod s) form a sub-image on which a stride-s pass is
//     a stride-1 pass.  The block stages its (32+2r)x(8+2r) window of that
//     sub-image into shared memory once, as two float4 planes (normal xyz +
//     depth; colour rgb + material bits), and reads every tap from there:
//     one 16-byte shared load per plane a tap, conflict-free.  Window cells
//     are fetched at CLAMPED IMAGE coordinates, min(max(x + dx s, 0), w-1)
//     as ops/stencil.py::shifted clamps, so a tap clamped at the border
//     reads the pixel the plain version reads, even where that pixel
//     belongs to another residue class.  Sub-images are ragged at the right
//     and bottom edges; their missing pixels are masked.  The block index
//     runs over residues fastest, so that the blocks in flight together
//     read neighbouring pixels and share their sectors in L2.
//   * Cheaper weights.  The per-tap weights are computed in three unrolled
//     passes over the taps: normal cosines and the Gaussian x depth weight,
//     then the power of all cosines at once, then material, colour and sums.
//     For an integer sigma_n (the default 64) the power is binary
//     exponentiation with the exponent's bits in the outer loop, so its
//     control is shared by every tap (64: six squarings a tap); otherwise
//     exp2f(sigma_n log2f(x)).  The depth weight is __expf, and nvcc
//     contracts products and sums into FMA.
//   * Occupancy: __launch_bounds__(256, 4) holds a lane to 64 registers
//     (ptxas chose 82 unbounded: 3 blocks an SM), spilling 48 B in the
//     25-tap instantiations; at 5 blocks (48 registers) it spills ~370 B
//     and measured 1.7x slower (PERF.md section 6).
//   * What still bounds it: the strided passes' staging.  A window cell of
//     the stride-12 sub-lattice reads 32 useful bytes from four sectors of
//     four arrays, so the stride-12 pass is ~2x the 7x7 pass.
//   * A-priori error against the plain version (accurate powf / expf,
//     every product and sum rounded): x^64 by six squarings is within 63
//     half-ulps (~4e-6 relative) of x^64 of the rounded x, and one ulp of a
//     contracted cosine moves x^64 by ~64 ulps (~4e-6); __expf is within
//     2 + 1.17 |x| ulps (a depth weight of e^-1 to ~2e-7); FMA contraction
//     changes each sum by an ulp.  So the weights agree to ~1e-5 relative
//     and the output, their normalised sum, within the tolerance of
//     chip_smoke.py and tests/test_torch_kernels_gpu.py: rtol 1e-4 + atol
//     1e-5 on >= 99.9% of pixels and rtol 1e-3 + atol 1e-4 on all.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW = 32;
constexpr int BH = 8;
constexpr int MAX_TAPS = 49;
constexpr int MIN_BLOCKS = 4;  // blocks of 256 threads an SM: <= 64 registers

struct Taps {
  float g[MAX_TAPS];  // gaussian_weights(radius), float32, dy outer
};

// HALF: 0 every tap; 1 + parity: the half kernel, which keeps tap k when
// k is the centre or (k + parity) is even
template <int R, int HALF>
__host__ __device__ constexpr bool keep(int k) {
  return HALF == 0 || k == (2 * R + 1) * (2 * R + 1) / 2 ||
         ((k + HALF - 1) & 1) == 0;
}
template <int R, int HALF>
__host__ __device__ constexpr int n_taps() {
  int n = 0;
  for (int k = 0; k < (2 * R + 1) * (2 * R + 1); ++k) n += keep<R, HALF>(k);
  return n;
}

template <int R, int HALF>
__global__ void __launch_bounds__(BW * BH, MIN_BLOCKS)
    denoise_wide_kernel(const float* __restrict__ color,
                        const float* __restrict__ normal,
                        const float* __restrict__ depth,
                        const int* __restrict__ mat, int h, int w, Taps taps,
                        int stride, int tiles_x, float sigma_n, int n_int,
                        float sigma_d, float m_miss, float* __restrict__ out) {
  constexpr int SW = BW + 2 * R;
  constexpr int CELLS = SW * (BH + 2 * R);
  constexpr int T = n_taps<R, HALF>();
  __shared__ float4 s_nd[CELLS];  // normal xyz, depth
  __shared__ float4 s_cm[CELLS];  // colour rgb, material id bits

  // block -> (residue class, tile of its sub-image), residues fastest
  const int classes = stride * stride;
  const int res = blockIdx.x % classes;
  const int tile = blockIdx.x / classes;
  const int rx = res % stride, ry = res / stride;
  const int X0 = (tile % tiles_x) * BW, Y0 = (tile / tiles_x) * BH;

  for (int c = threadIdx.y * BW + threadIdx.x; c < CELLS; c += BW * BH) {
    const int cx = c % SW, cy = c / SW;
    const int ix = min(max(rx + (X0 + cx - R) * stride, 0), w - 1);
    const int iy = min(max(ry + (Y0 + cy - R) * stride, 0), h - 1);
    const size_t i = (size_t)iy * w + ix;
    s_nd[c] = make_float4(__ldg(normal + 3 * i), __ldg(normal + 3 * i + 1),
                          __ldg(normal + 3 * i + 2), __ldg(depth + i));
    s_cm[c] = make_float4(__ldg(color + 3 * i), __ldg(color + 3 * i + 1),
                          __ldg(color + 3 * i + 2),
                          __int_as_float(__ldg(mat + i)));
  }
  __syncthreads();

  const int x = rx + (X0 + threadIdx.x) * stride;
  const int y = ry + (Y0 + threadIdx.y) * stride;
  if (x >= w || y >= h) return;  // the ragged edge of the sub-image
  const int cc = (threadIdx.y + R) * SW + threadIdx.x + R;
  const float4 nd0 = s_nd[cc];
  const float4 cm0 = s_cm[cc];
  const int m0 = __float_as_int(cm0.w);
  const bool fin0 = isfinite(nd0.w);
  const float safe_d = fin0 ? nd0.w : 0.0f;
  const float inv_sig = 1.0f / (sigma_d * fmaxf(safe_d, 1.0f) + 1e-6f);

  // 1. cosines, and Gaussian x depth weights
  float cosn[T], wt[T];
  int j = 0;
#pragma unroll
  for (int k = 0; k < (2 * R + 1) * (2 * R + 1); ++k) {
    if (keep<R, HALF>(k)) {
      const int off = (k / (2 * R + 1) - R) * SW + (k % (2 * R + 1) - R);
      const float4 nd = s_nd[cc + off];
      cosn[j] = fmaxf(nd.x * nd0.x + nd.y * nd0.y + nd.z * nd0.z, 0.0f);
      const bool fin_t = isfinite(nd.w);
      const float dz = ((fin_t ? nd.w : 0.0f) - safe_d) * inv_sig;
      wt[j] = fin_t == fin0 ? taps.g[k] * __expf(-dz * dz) : 0.0f;
      ++j;
    }
  }
  // 2. wt *= cosn^sigma_n, over all taps at once
  if (n_int >= 0) {
    for (int e = n_int;;) {
      if (e & 1) {
#pragma unroll
        for (int t = 0; t < T; ++t) wt[t] *= cosn[t];
      }
      e >>= 1;
      if (e == 0) break;
#pragma unroll
      for (int t = 0; t < T; ++t) cosn[t] *= cosn[t];
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) wt[t] *= exp2f(sigma_n * log2f(cosn[t]));
  }
  // 3. material weight, weighted colour sums (taps in the plain order)
  float wsum = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
  j = 0;
#pragma unroll
  for (int k = 0; k < (2 * R + 1) * (2 * R + 1); ++k) {
    if (keep<R, HALF>(k)) {
      const int off = (k / (2 * R + 1) - R) * SW + (k % (2 * R + 1) - R);
      const float4 cm = s_cm[cc + off];
      const float wk = __float_as_int(cm.w) == m0 ? wt[j] : wt[j] * m_miss;
      wsum += wk;
      ax += cm.x * wk;
      ay += cm.y * wk;
      az += cm.z * wk;
      ++j;
    }
  }
  float* o = out + ((size_t)y * w + x) * 3;
  if (wsum > 1e-6f) {  // else fall back to the centre
    const float den = fmaxf(wsum, 1e-6f);
    o[0] = ax / den;
    o[1] = ay / den;
    o[2] = az / den;
  } else {
    o[0] = cm0.x;
    o[1] = cm0.y;
    o[2] = cm0.z;
  }
}

template <int R, int HALF>
void launch(dim3 grid, cudaStream_t s, const float* color,
            const float* normal, const float* depth, const int* mat, int h,
            int w, const Taps& taps, int stride, int tiles_x, float sigma_n,
            int n_int, float sigma_d, float m_miss, float* out) {
  denoise_wide_kernel<R, HALF><<<grid, dim3(BW, BH), 0, s>>>(
      color, normal, depth, mat, h, w, taps, stride, tiles_x, sigma_n, n_int,
      sigma_d, m_miss, out);
}

}  // namespace

// g_host: (2*radius+1)^2 float32 tap weights in host memory (copied into
// the launch's parameters).  radius 2 or 3.
extern "C" int rtrt_denoise_wide(const float* color, const float* normal,
                                 const float* depth, const int* mat, int h,
                                 int w, const float* g_host, int radius,
                                 int stride, int half_taps, int parity,
                                 float sigma_n, float sigma_d, float sigma_m,
                                 float* out, void* stream) {
  if ((radius != 2 && radius != 3) || stride < 1)
    return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  Taps taps;
  const int n = (2 * radius + 1) * (2 * radius + 1);
  for (int k = 0; k < MAX_TAPS; ++k) taps.g[k] = k < n ? g_host[k] : 0.0f;
  const float m_miss = fmaxf(1.0f - sigma_m, 0.0f);
  // an integral exponent takes binary exponentiation
  const int n_int = (sigma_n >= 0.0f && sigma_n <= 1048576.0f &&
                     floorf(sigma_n) == sigma_n)
                        ? (int)sigma_n
                        : -1;
  // tiles of the largest sub-image (residue 0), ceil(w / s) x ceil(h / s)
  const int tiles_x = ((w + stride - 1) / stride + BW - 1) / BW;
  const int tiles_y = ((h + stride - 1) / stride + BH - 1) / BH;
  const long long blocks = (long long)tiles_x * tiles_y * stride * stride;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  using Launch = void (*)(dim3, cudaStream_t, const float*, const float*,
                          const float*, const int*, int, int, const Taps&,
                          int, int, float, int, float, float, float*);
  static const Launch kernels[2][3] = {
      {launch<2, 0>, launch<2, 1>, launch<2, 2>},
      {launch<3, 0>, launch<3, 1>, launch<3, 2>}};
  const int half = half_taps ? 1 + (parity & 1) : 0;
  kernels[radius - 2][half](grid, static_cast<cudaStream_t>(stream), color,
                            normal, depth, mat, h, w, taps, stride, tiles_x,
                            sigma_n, n_int, sigma_d, m_miss, out);
  return static_cast<int>(cudaGetLastError());
}
