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
// What bounds it on the H100: per pixel it reads 8 words (colour 3,
// normal 3, depth, material) and writes 3 (44 B, 91 MB per 1080p pass,
// ~27 us at 3.35 TB/s); the 25 or 49 taps cost a powf (sigma_n = 64) and an
// expf each plus ~25 other float operations, ~1.5-2.9 G operations per
// 1080p pass (~25-45 us at 67 TFLOP/s float32).  Tap reads mostly hit L1/L2:
// neighbouring threads read neighbouring taps.
//
// Simple design: one thread per output pixel, 32x8 pixels per block, tap
// coordinates clamped to the image (the edge clamp of stencil.shifted).
// Tap order (dy outer, dx inner) and operand order are the XLA form's, and
// the sums use __fadd_rn / __fmul_rn so that nvcc does not contract them
// into FMAs: the weights and sums round as the plain version's do.  powf
// and expf are the accurate library functions (no --use_fast_math).  The
// TPU kernel's windowed DMA with a 48-pixel halo does not carry over;
// shared-memory tiles and a packed per-pixel G-buffer record are for a
// later PR.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW = 32;
constexpr int BH = 8;
constexpr int MAX_TAPS = 49;

struct Taps {
  float g[MAX_TAPS];  // gaussian_weights(radius), float32, dy outer
};

template <int R>
__global__ void __launch_bounds__(BW * BH)
    denoise_wide_kernel(const float* __restrict__ color,
                        const float* __restrict__ normal,
                        const float* __restrict__ depth,
                        const int* __restrict__ mat, int h, int w, Taps taps,
                        int stride, int half_taps, int parity, float sigma_n,
                        float sigma_d, float m_miss, float* __restrict__ out) {
  const int x = blockIdx.x * BW + threadIdx.x;
  const int y = blockIdx.y * BH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t i = (size_t)y * w + x;
  const float c0x = color[i * 3 + 0], c0y = color[i * 3 + 1],
              c0z = color[i * 3 + 2];
  const float n0x = normal[i * 3 + 0], n0y = normal[i * 3 + 1],
              n0z = normal[i * 3 + 2];
  const float d0 = depth[i];
  const int m0 = mat[i];
  const bool fin0 = isfinite(d0);
  const float safe_d = fin0 ? d0 : 0.0f;
  const float inv_sig =
      1.0f / __fadd_rn(__fmul_rn(sigma_d, fmaxf(safe_d, 1.0f)), 1e-6f);
  constexpr int K_HALF = (2 * R + 1) * (2 * R + 1) / 2;

  float wsum = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
  int k = -1;
  for (int dy = -R; dy <= R; ++dy) {
    const int ty = min(max(y + dy * stride, 0), h - 1);
    for (int dx = -R; dx <= R; ++dx) {
      ++k;
      // a half-kernel tap of zero weight adds nothing to either sum
      if (half_taps && k != K_HALF && ((k + parity) & 1)) continue;
      const int tx = min(max(x + dx * stride, 0), w - 1);
      const size_t t = (size_t)ty * w + tx;
      const float ndot = __fadd_rn(
          __fadd_rn(__fmul_rn(normal[t * 3 + 0], n0x),
                    __fmul_rn(normal[t * 3 + 1], n0y)),
          __fmul_rn(normal[t * 3 + 2], n0z));
      const float n_w = powf(fmaxf(ndot, 0.0f), sigma_n);
      const float d_t = depth[t];
      const bool fin_t = isfinite(d_t);
      const float dz = __fmul_rn(__fsub_rn(fin_t ? d_t : 0.0f, safe_d),
                                 inv_sig);
      float d_w = expf(__fmul_rn(-dz, dz));
      if (fin_t != fin0) d_w = 0.0f;
      const float m_w = (mat[t] == m0) ? 1.0f : m_miss;
      const float wt =
          __fmul_rn(__fmul_rn(__fmul_rn(taps.g[k], n_w), d_w), m_w);
      wsum = __fadd_rn(wsum, wt);
      ax = __fadd_rn(ax, __fmul_rn(color[t * 3 + 0], wt));
      ay = __fadd_rn(ay, __fmul_rn(color[t * 3 + 1], wt));
      az = __fadd_rn(az, __fmul_rn(color[t * 3 + 2], wt));
    }
  }
  float* o = out + i * 3;
  if (wsum > 1e-6f) {  // else fall back to the centre
    const float den = fmaxf(wsum, 1e-6f);
    o[0] = __fdiv_rn(ax, den);
    o[1] = __fdiv_rn(ay, den);
    o[2] = __fdiv_rn(az, den);
  } else {
    o[0] = c0x;
    o[1] = c0y;
    o[2] = c0z;
  }
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
  if (radius != 2 && radius != 3) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  Taps taps;
  const int n = (2 * radius + 1) * (2 * radius + 1);
  for (int k = 0; k < MAX_TAPS; ++k) taps.g[k] = k < n ? g_host[k] : 0.0f;
  const float m_miss = fmaxf(1.0f - sigma_m, 0.0f);
  dim3 block(BW, BH);
  dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (radius == 2)
    denoise_wide_kernel<2><<<grid, block, 0, s>>>(
        color, normal, depth, mat, h, w, taps, stride, half_taps, parity,
        sigma_n, sigma_d, m_miss, out);
  else
    denoise_wide_kernel<3><<<grid, block, 0, s>>>(
        color, normal, depth, mat, h, w, taps, stride, half_taps, parity,
        sigma_n, sigma_d, m_miss, out);
  return static_cast<int>(cudaGetLastError());
}
