// K3 post tail: exposure x tone map + gamma, 3x3 sharpen clamped to the
// neighbourhood, blue-noise dither, u8 quantize — one pass over the frame.
//
// Replaces: rtrt_tpu/post/tail.py::_tail_kernel (launched by
// post_tail_pallas; used when the output size equals the render size,
// rtrt_tpu/post/pipeline.py:59).  Math follows the XLA ops of
// post/pipeline.py:70-95 (tonemap.py, sharpen.py, the dither block).
//
// What bounds it on the H100: memory traffic is 12 B read + 3 B written per
// pixel (~31 MB at 1080p, ~9.3 us at 3.35 TB/s), but the instructions it
// issues bound it first unless each is cheap: a tone map is ~60 operations
// with fast intrinsics and ~200 with accurate powf and IEEE divisions, and
// the 3x3 sharpen, dither and quantize add ~70 a pixel.
//
// Design (the first port's 32x8 tiles read 55 us, ~400 issued
// instructions a pixel):
//   * 64x16 output pixels a block, 4 pixels a thread (a warp is two tile
//     rows): the block tone-maps its 66x18 window once into shared memory,
//     1.16 tone maps a pixel (the 32x8 tile tone-mapped 1.33).  256
//     threads at <= 64 registers leave 4 blocks an SM; 128x16 (512
//     threads, 1.14) and 64x32 (1.10) tiles measured ~12% slower, 128x8
//     as fast (PERF.md).
//   * Vector staging: a thread loads 4 pixels (12 floats) as 3 aligned
//     16-byte loads where the row is 4-pixel aligned (w % 4 == 0) and the
//     tile lies inside the image; elsewhere (ragged right tile, odd widths)
//     per-pixel loads at clamped coordinates.  The window is 324 items
//     (288 groups, 36 halo pixels) for 256 threads: a thread issues the
//     loads of both its items before it tone-maps either.  Window rows are
//     clamped to the image, as the edge padding of the TPU kernel and of
//     the XLA shifted-stack stencil.  The window's interior sits 16-byte aligned in
//     shared memory, so each thread stores its 4 tone-mapped pixels as 3
//     float4, and reads the 6 samples of a window row around its 4 pixels
//     as 5 float4 (conflict-free: 48-byte lane stride).
//   * Fast intrinsics: gamma as exp2f(inv_gamma * __log2f(x)) on x in
//     [0, 1] (0 maps to 0, 1 to 1), __fdividef where the denominator is
//     bounded away from 0 and below 2^126 (ACES fitted b >= 0.19, the
//     Narkowicz fit's >= 0.10, Reinhard's 1 + lum and max(lum, 1e-6)); the
//     Hable denominator has real roots, so its division stays IEEE.  The
//     result is held to the u8 tolerance (within 1, equal on >= 99.9% of
//     pixels), not to bit equality.
//   * Separable sharpen: each window row's horizontal 3-sum, min and max
//     of a pixel, then the three rows combined.
//   * Packed stores: the 12 bytes of a thread's 4 pixels as 3 aligned
//     32-bit stores; byte stores only on the ragged right edge or where
//     w % 4 != 0.
// The frame parameters [ev, tone map index, gamma, sharpen amount, dither
// shift] stay on the device (no host sync per frame).
//
// Pre-mapped instantiation (MAPPED = true): where the render size is below
// the screen size, the JAX frame runs no fused tail: it tone-maps at
// render size, upscales to the screen by Catmull-Rom and clamps to [0, 1],
// then sharpens, dithers and quantizes at screen size
// (rtrt_tpu/post/pipeline.py:70-95, XLA ops).  The port keeps the tone map
// and the upscale as torch ops and runs the screen-size steps here: the
// window is staged from the LDR image as it is (no ev, no tone map);
// sharpen, dither, quantize and the 16-byte staging are the same code.
// Bound: the same 12 B read + 3 B written per pixel; ~110 operations a
// pixel (the sharpen's sums, minima and maxima ~29 a channel, dither and
// quantize ~6), so bytes bound it.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;              // tile width, pixels
constexpr int TH = 16;              // tile height
constexpr int GW = TW / 4;          // 4-pixel groups a row
constexpr int THREADS = GW * TH;    // 256
constexpr int WR = TH + 2;          // window rows
// window row in shared memory: pixel 3 holds the left halo, 4..TW+3 the
// interior (float offset 12: 16-byte aligned), TW+4 the right halo
constexpr int PITCH = TW + 8;
constexpr int PITCH4 = PITCH * 3 / 4;   // float4 a row
static_assert(PITCH * 3 % 4 == 0, "rows of whole float4");
// staging items (4-pixel groups, then halo pixels) and a thread's share
constexpr int ITEMS = WR * GW + 2 * WR;
constexpr int PASSES = (ITEMS + THREADS - 1) / THREADS;

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
__device__ __forceinline__ void tonemap(float* c, int op, float inv_gamma) {
  float o[3];
  if (op == 0) {  // Reinhard extended, white = 4
    const float lum = c[0] * 0.2126f + c[1] * 0.7152f + c[2] * 0.0722f;
    const float num = lum * (1.0f + lum * (1.0f / 16.0f));
    const float rs =
        __fdividef(__fdividef(num, 1.0f + lum), fmaxf(lum, 1e-6f));
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = clamp01(c[k] * rs);
  } else if (op == 1) {  // ACES fitted (Hill)
    const float mi[3][3] = {{0.59719f, 0.35458f, 0.04823f},
                            {0.07600f, 0.90834f, 0.01566f},
                            {0.02840f, 0.13383f, 0.83777f}};
    const float mo[3][3] = {{1.60475f, -0.53108f, -0.07367f},
                            {-0.10208f, 1.10813f, -0.00605f},
                            {-0.00327f, -0.07276f, 1.07602f}};
    float v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float x = mi[r][0] * c[0] + mi[r][1] * c[1] + mi[r][2] * c[2];
      const float a = x * (x + 0.0245786f) - 0.000090537f;
      const float b = x * (0.983729f * x + 0.4329510f) + 0.238081f;
      v[r] = __fdividef(a, b);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
      o[r] = clamp01(mo[r][0] * v[0] + mo[r][1] * v[1] + mo[r][2] * v[2]);
  } else if (op == 2) {  // ACES approx (Narkowicz)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = c[k] * 0.6f;
      o[k] = clamp01(__fdividef(x * (2.51f * x + 0.03f),
                                x * (2.43f * x + 0.59f) + 0.14f));
    }
  } else {  // Uncharted2 (Hable), white = 11.2
    const float hw = hable(11.2f);
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = clamp01(hable(c[k] * 2.0f) / hw);
  }
  // o is in [0, 1]: log2 is -inf at 0, so 0 maps to 0 and 1 to 1
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = exp2f(inv_gamma * __log2f(o[k]));
}

__device__ __forceinline__ uint32_t pack4(const uint8_t* b) {
  return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
         ((uint32_t)b[3] << 24);
}

// 32 warps an SM at <= 64 registers (ptxas spills ~32 B).  MAPPED: the
// input is the LDR image already (no exposure, no tone map)
template <bool MAPPED>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
    post_tail_kernel(const float* __restrict__ color, int h, int w,
                     const float* __restrict__ params,
                     const float* __restrict__ mask, int do_sharpen,
                     int do_dither, int aligned, uint8_t* __restrict__ out) {
  __shared__ float4 win[WR * PITCH4];
  [[maybe_unused]] const float ev = params[0];
  // 0, 1, 2; anything else Hable
  [[maybe_unused]] const int op = (int)rintf(params[1]);
  [[maybe_unused]] const float inv_gamma = 1.0f / params[2];
  const float amount2 = 2.0f * params[3];
  const float fshift = params[4];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  // 16-byte loads need 4-pixel aligned rows (and 32-bit stores too)
  const bool rows4 = aligned && (w % 4 == 0);
  const bool vec = rows4 && (x0 + TW <= w);

  // 1. the window: WR rows of GW 4-pixel groups, then the 2 halo pixels of
  // each row, tone-mapped once.  A thread's items are k = tid + j THREADS;
  // all their loads are issued before the first tone map, so that the block
  // waits for memory once
  float c[PASSES][12];
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    const int k = tid + j * THREADS;
    if (k < WR * GW) {
      const int r = k / GW, g = k % GW;
      const float* row =
          color + (size_t)min(max(y0 + r - 1, 0), h - 1) * w * 3;
      const int gx = x0 + 4 * g;
      if (vec) {
        const float4* src = reinterpret_cast<const float4*>(row + gx * 3);
        const float4 a = __ldg(src), b = __ldg(src + 1), d = __ldg(src + 2);
        c[j][0] = a.x; c[j][1] = a.y; c[j][2] = a.z; c[j][3] = a.w;
        c[j][4] = b.x; c[j][5] = b.y; c[j][6] = b.z; c[j][7] = b.w;
        c[j][8] = d.x; c[j][9] = d.y; c[j][10] = d.z; c[j][11] = d.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* p = row + min(gx + i, w - 1) * 3;
          c[j][3 * i] = __ldg(p);
          c[j][3 * i + 1] = __ldg(p + 1);
          c[j][3 * i + 2] = __ldg(p + 2);
        }
      }
    } else if (k < ITEMS) {
      const int q = k - WR * GW, r = q >> 1;
      const int gx = (q & 1) ? min(x0 + TW, w - 1) : max(x0 - 1, 0);
      const float* p =
          color + ((size_t)min(max(y0 + r - 1, 0), h - 1) * w + gx) * 3;
      c[j][0] = __ldg(p);
      c[j][1] = __ldg(p + 1);
      c[j][2] = __ldg(p + 2);
    }
  }
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    const int k = tid + j * THREADS;
    if (k < WR * GW) {
      const int r = k / GW, g = k % GW;
      if constexpr (!MAPPED) {
#pragma unroll
        for (int i = 0; i < 12; ++i) c[j][i] *= ev;
#pragma unroll
        for (int i = 0; i < 4; ++i) tonemap(c[j] + 3 * i, op, inv_gamma);
      }
      float4* dst = win + r * PITCH4 + 3 + 3 * g;
      dst[0] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
      dst[1] = make_float4(c[j][4], c[j][5], c[j][6], c[j][7]);
      dst[2] = make_float4(c[j][8], c[j][9], c[j][10], c[j][11]);
    } else if (k < ITEMS) {
      const int q = k - WR * GW, r = q >> 1;
      if constexpr (!MAPPED) {
#pragma unroll
        for (int i = 0; i < 3; ++i) c[j][i] *= ev;
        tonemap(c[j], op, inv_gamma);
      }
      float* dst = reinterpret_cast<float*>(win + r * PITCH4) +
                   ((q & 1) ? TW + 4 : 3) * 3;
      dst[0] = c[j][0];
      dst[1] = c[j][1];
      dst[2] = c[j][2];
    }
  }
  __syncthreads();

  // 2. sharpen, dither, quantize the thread's 4 pixels
  const int g = tid % GW, ty = tid / GW;
  const int y = y0 + ty, x = x0 + 4 * g;
  if (y >= h || x >= w) return;
  // s[1 + 3 i + ch]: sample i (pixels x - 1 .. x + 4) of a window row, from
  // 5 float4 starting 16-byte aligned one float before it
  float acc[12], mn[12], mx[12], ctr[12];
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    const int wrow = ty + (rr == 2 ? 1 : rr * 2);  // rows 0, 2, then 1
    const float4* src = win + wrow * PITCH4 + 2 + 3 * g;
    float s[20];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float4 v = src[q];
      s[4 * q] = v.x; s[4 * q + 1] = v.y; s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) {  // pixel k / 3, channel k % 3
      const float a = s[1 + k], b = s[4 + k], c = s[7 + k];
      const float hs = a + b + c;
      const float hn = fminf(fminf(a, b), c), hx = fmaxf(fmaxf(a, b), c);
      if (rr == 0) {
        acc[k] = hs; mn[k] = hn; mx[k] = hx;
      } else {
        acc[k] += hs; mn[k] = fminf(mn[k], hn); mx[k] = fmaxf(mx[k], hx);
      }
      if (rr == 2) ctr[k] = b;
    }
  }
  // the 4 pixels' mask values: x % 64 is a multiple of 4, so they are
  // consecutive in the mask's row
  float m4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (do_dither) {
    const float* mrow = mask + (y % 64) * 64 + (x % 64);
    if (aligned) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(mrow));
      m4[0] = v.x; m4[1] = v.y; m4[2] = v.z; m4[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) m4[i] = __ldg(mrow + i);
    }
  }
  uint8_t b[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    float v = ctr[k];
    if (do_sharpen) {
      const float sharp = v + (v - acc[k] * (1.0f / 9.0f)) * amount2;
      v = fminf(fmaxf(sharp, mn[k]), mx[k]);
    }
    if (do_dither) {
      const float m = m4[k / 3] + fshift;
      v += ((m - floorf(m)) - 0.5f) * (1.0f / 255.0f);
    }
    b[k] = (uint8_t)fminf(fmaxf(v * 255.0f + 0.5f, 0.0f), 255.0f);
  }
  uint8_t* dst = out + ((size_t)y * w + x) * 3;
  if (rows4 && x + 4 <= w) {
    uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
    d32[0] = pack4(b);
    d32[1] = pack4(b + 4);
    d32[2] = pack4(b + 8);
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k)
      if (x + k / 3 < w) dst[k] = b[k];
  }
}

}  // namespace

// mapped: 0 tone-maps `color` (linear radiance), 1 takes it as the LDR
// image (the pre-mapped instantiation)
extern "C" int rtrt_post_tail(const float* color, int h, int w,
                              const float* params, const float* mask,
                              int do_sharpen, int do_dither, int mapped,
                              uint8_t* out, void* stream) {
  if (h > 0 && w > 0) {
    const int aligned = reinterpret_cast<uintptr_t>(color) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(mask) % 16 == 0;
    dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
    auto kernel = mapped ? post_tail_kernel<true> : post_tail_kernel<false>;
    kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        color, h, w, params, mask, do_sharpen, do_dither, aligned, out);
  }
  return static_cast<int>(cudaGetLastError());
}
