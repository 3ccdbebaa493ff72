// K5 history reprojection of the SVGF denoiser: the history set resampled
// at uv + motion, per pixel.
//
// Replaces: rtrt_tpu/denoise/reproject.py::_reproject_kernel (launched by
// reproject_tile_shift).  It computes reproject.py::reproject_gather, the
// function the tile-shift kernel is pinned to on every lane it resolves
// (tests/test_reproject.py) and the one the JAX frame runs off the TPU:
//   * colour and colour2: 16 Catmull-Rom taps (a = -1/2, taps -1..2 around
//     floor(p), indices clamped), (wy * wx) * img summed ky outer, kx inner;
//   * depth, count, material id: nearest, rintf (round half to even, as
//     jnp.round / torch.round; roundf would round half away from zero);
//   * ok = 0 <= yh <= h-1 and 0 <= xh <= w-1.
// The tile-shift kernel's extra ok=False where a lane's motion leaves its
// tile's window (its 32x128 tile mean +-3 px) comes from the TPU's windowed
// DMA and is not carried over.
//
// What bounds it on the H100: bytes.  Per pixel it reads 8 bfloat16
// history planes, the int32 material id and 2 float32 motion components
// (28 B) and writes 9 float32 planes and 1 byte of ok (37 B): 135 MB per
// 1080p frame, ~40 us at 3.35 TB/s.  The arithmetic (16 taps x 6 channels)
// is a few hundred float operations per pixel.
//
// Simple design: one thread per pixel, 32x8 pixels per block.  It reads
// the bfloat16 history directly and widens it in registers (exact), so it
// reads half the bytes of a widened copy; the template also takes float32
// history (FeatureFlags.half_history off).  Taps of neighbouring threads
// are neighbouring addresses for smooth motion.  __fadd_rn / __fmul_rn keep
// nvcc from contracting the position and weight arithmetic into FMAs: a
// contracted y + motion * h can move a sample across a rounding boundary
// of floor / rint, and the nearest planes must equal the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW = 32;
constexpr int BH = 8;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 1-D Catmull-Rom weight (a = -1/2), in the order of _w_catmull_rom
__device__ __forceinline__ float w_cr(float d) {
  const float t = fabsf(d);
  if (t <= 1.0f)
    return __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, t), 2.5f), t), t),
        1.0f);
  if (t < 2.0f)
    return __fadd_rn(
        __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, t), 2.5f),
                                      t),
                            4.0f),
                  t),
        2.0f);
  return 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(BW * BH)
    reproject_kernel(const T* __restrict__ color, const T* __restrict__ color2,
                     const T* __restrict__ depth, const T* __restrict__ count,
                     const int* __restrict__ mat,
                     const float* __restrict__ motion, int h, int w,
                     float* __restrict__ o_color, float* __restrict__ o_color2,
                     float* __restrict__ o_depth, float* __restrict__ o_count,
                     int* __restrict__ o_mat, uint8_t* __restrict__ o_ok) {
  const int x = blockIdx.x * BW + threadIdx.x;
  const int y = blockIdx.y * BH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t i = (size_t)y * w + x;
  const float yh = __fadd_rn((float)y, __fmul_rn(motion[i * 2 + 1], (float)h));
  const float xh = __fadd_rn((float)x, __fmul_rn(motion[i * 2 + 0], (float)w));
  const float y0f = floorf(yh), x0f = floorf(xh);
  const float fy = __fsub_rn(yh, y0f), fx = __fsub_rn(xh, x0f);
  const int y0i = (int)y0f, x0i = (int)x0f;

  float wx[4];
  int xi[4];
  for (int kx = 0; kx < 4; ++kx) {
    wx[kx] = w_cr(__fsub_rn(fx, (float)(kx - 1)));
    xi[kx] = min(max(x0i + kx - 1, 0), w - 1);
  }
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ky = 0; ky < 4; ++ky) {
    const float wy = w_cr(__fsub_rn(fy, (float)(ky - 1)));
    const size_t row = (size_t)min(max(y0i + ky - 1, 0), h - 1) * w;
    for (int kx = 0; kx < 4; ++kx) {
      const float wt = __fmul_rn(wy, wx[kx]);
      const size_t t = (row + xi[kx]) * 3;
      for (int c = 0; c < 3; ++c) {
        a[c] = __fadd_rn(a[c], __fmul_rn(wt, widen(color[t + c])));
        a[3 + c] = __fadd_rn(a[3 + c], __fmul_rn(wt, widen(color2[t + c])));
      }
    }
  }
  for (int c = 0; c < 3; ++c) {
    o_color[i * 3 + c] = a[c];
    o_color2[i * 3 + c] = a[3 + c];
  }
  const int ny = min(max((int)rintf(yh), 0), h - 1);
  const int nx = min(max((int)rintf(xh), 0), w - 1);
  const size_t n = (size_t)ny * w + nx;
  o_depth[i] = widen(depth[n]);
  o_count[i] = widen(count[n]);
  o_mat[i] = mat[n];
  o_ok[i] = (yh >= 0.0f) && (yh <= (float)h - 1.0f) && (xh >= 0.0f) &&
            (xh <= (float)w - 1.0f);
}

template <typename T>
void launch(const void* color, const void* color2, const void* depth,
            const void* count, const int* mat, const float* motion, int h,
            int w, float* o_color, float* o_color2, float* o_depth,
            float* o_count, int* o_mat, uint8_t* o_ok, cudaStream_t s) {
  dim3 block(BW, BH);
  dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH);
  reproject_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(color), static_cast<const T*>(color2),
      static_cast<const T*>(depth), static_cast<const T*>(count), mat, motion,
      h, w, o_color, o_color2, o_depth, o_count, o_mat, o_ok);
}

}  // namespace

// History planes are bfloat16 when is_bf16, else float32; o_ok is a bool
// (one byte) plane.
extern "C" int rtrt_reproject(const void* color, const void* color2,
                              const void* depth, const void* count,
                              const int* mat, const float* motion, int h,
                              int w, int is_bf16, float* o_color,
                              float* o_color2, float* o_depth, float* o_count,
                              int* o_mat, uint8_t* o_ok, void* stream) {
  if (h > 0 && w > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch<__nv_bfloat16>(color, color2, depth, count, mat, motion, h, w,
                            o_color, o_color2, o_depth, o_count, o_mat, o_ok,
                            s);
    else
      launch<float>(color, color2, depth, count, mat, motion, h, w, o_color,
                    o_color2, o_depth, o_count, o_mat, o_ok, s);
  }
  return static_cast<int>(cudaGetLastError());
}
