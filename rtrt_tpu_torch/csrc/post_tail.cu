// K3 post tail: exposure x tone map + gamma, 3x3 sharpen clamped to the
// neighbourhood, blue-noise dither, u8 quantize — one pass over the frame.
//
// Replaces: rtrt_tpu/post/tail.py::_tail_kernel (launched by
// post_tail_pallas; used when the output size equals the render size,
// rtrt_tpu/post/pipeline.py:59).  Math follows the XLA ops of
// post/pipeline.py:70-95 (tonemap.py, sharpen.py, the dither block).
//
// What bounds it on the H100: memory traffic is 12 B read + 3 B written per
// pixel (~31 MB at 1080p, ~10 us at 3.35 TB/s); the tone map (a powf per
// channel) of each pixel is the arithmetic.  Recomputing the tone map for
// all 9 taps would make it 9x the arithmetic.
//
// Simple design: 32x8 output pixels per block; the block tone-maps its
// (8+2)x(32+2) window once into shared memory (edges clamp, as the edge
// padding of the TPU kernel and of the XLA shifted-stack stencil), syncs,
// then each thread sharpens, dithers and quantizes its pixel.  The frame
// parameters [ev, tone map index, gamma, sharpen amount, dither shift] stay
// on the device (no host sync per frame).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BW = 32;
constexpr int BH = 8;

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float hable(float x) {
  const float a = 0.15f, b = 0.50f;
  const float cb = (float)(0.10 * 0.50), de = (float)(0.20 * 0.02);
  const float df = (float)(0.20 * 0.30), e_f = (float)(0.02 / 0.30);
  return ((x * (a * x + cb) + de) / (x * (a * x + b) + df)) - e_f;
}

// tonemap.py::tonemap on one pixel (the selected operator), then gamma
__device__ __forceinline__ void tonemap(float c[3], int op, float inv_gamma) {
  float o[3];
  if (op == 0) {  // Reinhard extended, white = 4
    float lum = c[0] * 0.2126f + c[1] * 0.7152f + c[2] * 0.0722f;
    float num = lum * (1.0f + lum / 16.0f);
    float mapped = num / (1.0f + lum);
    float rs = mapped / fmaxf(lum, 1e-6f);
    for (int k = 0; k < 3; ++k) o[k] = clamp01(c[k] * rs);
  } else if (op == 1) {  // ACES fitted (Hill)
    const float mi[3][3] = {{0.59719f, 0.35458f, 0.04823f},
                            {0.07600f, 0.90834f, 0.01566f},
                            {0.02840f, 0.13383f, 0.83777f}};
    const float mo[3][3] = {{1.60475f, -0.53108f, -0.07367f},
                            {-0.10208f, 1.10813f, -0.00605f},
                            {-0.00327f, -0.07276f, 1.07602f}};
    float v[3];
    for (int r = 0; r < 3; ++r) {
      float x = mi[r][0] * c[0] + mi[r][1] * c[1] + mi[r][2] * c[2];
      float a = x * (x + 0.0245786f) - 0.000090537f;
      float b = x * (0.983729f * x + 0.4329510f) + 0.238081f;
      v[r] = a / b;
    }
    for (int r = 0; r < 3; ++r)
      o[r] = clamp01(mo[r][0] * v[0] + mo[r][1] * v[1] + mo[r][2] * v[2]);
  } else if (op == 2) {  // ACES approx (Narkowicz)
    for (int k = 0; k < 3; ++k) {
      float x = c[k] * 0.6f;
      o[k] = clamp01((x * (2.51f * x + 0.03f)) /
                     (x * (2.43f * x + 0.59f) + 0.14f));
    }
  } else {  // Uncharted2 (Hable), white = 11.2
    float hw = hable(11.2f);
    for (int k = 0; k < 3; ++k) o[k] = clamp01(hable(c[k] * 2.0f) / hw);
  }
  for (int k = 0; k < 3; ++k) c[k] = powf(clamp01(o[k]), inv_gamma);
}

__global__ void __launch_bounds__(BW * BH)
    post_tail_kernel(const float* __restrict__ color, int h, int w,
                     const float* __restrict__ params,
                     const float* __restrict__ mask, int do_sharpen,
                     int do_dither, uint8_t* __restrict__ out) {
  __shared__ float tile[BH + 2][BW + 2][3];
  const float ev = params[0];
  const int op = (int)rintf(params[1]);
  const float inv_gamma = 1.0f / params[2];
  const float amount = params[3];
  const float fshift = params[4];
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * BH;
  const int tid = threadIdx.y * BW + threadIdx.x;
  for (int k = tid; k < (BH + 2) * (BW + 2); k += BW * BH) {
    int ty = k / (BW + 2), tx = k % (BW + 2);
    int gy = min(max(y0 + ty - 1, 0), h - 1);
    int gx = min(max(x0 + tx - 1, 0), w - 1);
    const float* src = color + ((size_t)gy * w + gx) * 3;
    float c[3] = {src[0] * ev, src[1] * ev, src[2] * ev};
    tonemap(c, op < 0 ? 3 : op, inv_gamma);
    tile[ty][tx][0] = c[0];
    tile[ty][tx][1] = c[1];
    tile[ty][tx][2] = c[2];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  float noise = 0.0f;
  if (do_dither) {
    float m = mask[(y % 64) * 64 + (x % 64)] + fshift;
    noise = (m - floorf(m)) - 0.5f;
  }
  uint8_t* dst = out + ((size_t)y * w + x) * 3;
  for (int ch = 0; ch < 3; ++ch) {
    float c0 = tile[threadIdx.y + 1][threadIdx.x + 1][ch];
    float v = c0;
    if (do_sharpen) {
      float acc = 0.0f, nmin = CUDART_INF_F, nmax = -CUDART_INF_F;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) {
          float t = tile[threadIdx.y + dy][threadIdx.x + dx][ch];
          acc += t;
          nmin = fminf(nmin, t);
          nmax = fmaxf(nmax, t);
        }
      float sharp = c0 + (c0 - acc / 9.0f) * (2.0f * amount);
      v = fminf(fmaxf(sharp, nmin), nmax);
    }
    if (do_dither) v = v + noise / 255.0f;
    dst[ch] = (uint8_t)fminf(fmaxf(v * 255.0f + 0.5f, 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" int rtrt_post_tail(const float* color, int h, int w,
                              const float* params, const float* mask,
                              int do_sharpen, int do_dither, uint8_t* out,
                              void* stream) {
  if (h > 0 && w > 0) {
    dim3 block(BW, BH);
    dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH);
    post_tail_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        color, h, w, params, mask, do_sharpen, do_dither, out);
  }
  return static_cast<int>(cudaGetLastError());
}
