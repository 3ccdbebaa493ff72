// K5 history reprojection of the SVGF denoiser: the history set resampled
// at uv + motion, per pixel.
//
// Replaces: rtrt_tpu/denoise/reproject.py::_reproject_kernel (launched by
// reproject_tile_shift).  It computes reproject.py::reproject_gather, the
// function the tile-shift kernel is pinned to on every lane it resolves
// (tests/test_reproject.py) and the one the JAX frame runs off the TPU:
//   * colour and colour2: 16 Catmull-Rom taps (a = -1/2, taps -1..2 around
//     floor(p), indices clamped), (wy * wx) * img summed ky outer, kx inner;
//     or, in the bilinear instantiation (RTRT_HISTORY_FILTER=bilinear,
//     reproject.py:44-70 and 286-301), the 4 taps 0..1 with weights
//     max(0, 1 - |d|), in the same order;
//   * depth, count, material id: nearest, rintf (round half to even, as
//     jnp.round / torch.round; roundf would round half away from zero);
//   * ok = 0 <= yh <= h-1 and 0 <= xh <= w-1.
// The tile-shift kernel's extra ok=False where a lane's motion leaves its
// tile's window (its 32x128 tile mean +-3 px) comes from the TPU's windowed
// DMA and is not carried over.
//
// Instantiations: history dtype {bf16, f32} x filter {Catmull-Rom,
// bilinear}.  The bilinear one is the same thread a pixel with 4 taps in
// place of 16: the same bytes, about a quarter of the tap operations.
//
// The band instantiation (row0, rows), in both filters: the history planes
// are the whole (h, w) image, the motion and the outputs (rows, w), and
// output row r is image row y = row0 + r.  A rank of the row-sharded frame
// (parallel/frame_spmd.py) reprojects its own rows from the whole history
// (the motion can point anywhere).  Every pixel's arithmetic takes the
// image row y, so a band's rows equal the same rows of the full launch bit
// for bit, and row0 = 0, rows = h is the full launch.
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
//
// The taps accumulate by fmaf, one rounding a tap and channel instead of
// two (within the colour tolerance; 4% faster on the H100, PERF.md).
//
// Staging the taps in shared memory measured slower on the H100 (PERF.md):
// a block reducing its pixels' taps to a box and staging it (one 16-byte
// shared load a tap instead of six 2-byte global loads) read 0.082 ms on
// the 1080p camera pan against 0.073 without, 0.087-0.093 as persistent
// blocks that stage the next tile while computing this one.  The taps'
// global loads hit L1; the staging adds a dependent load and block
// barriers, and fewer warps fit an SM.
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

constexpr int CATMULL_ROM = 0;  // HISTORY_FILTERS order, reproject.py
constexpr int BILINEAR = 1;

// 1-D bilinear weight max(0, 1 - |d|), as _w_bilinear
__device__ __forceinline__ float w_bl(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
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

template <typename T, int FILTER>
__global__ void __launch_bounds__(BW * BH)
    reproject_kernel(const T* __restrict__ color, const T* __restrict__ color2,
                     const T* __restrict__ depth, const T* __restrict__ count,
                     const int* __restrict__ mat,
                     const float* __restrict__ motion, int h, int w,
                     int row0, int rows, float* __restrict__ o_color,
                     float* __restrict__ o_color2, float* __restrict__ o_depth,
                     float* __restrict__ o_count, int* __restrict__ o_mat,
                     uint8_t* __restrict__ o_ok) {
  const int x = blockIdx.x * BW + threadIdx.x;
  const int r = blockIdx.y * BH + threadIdx.y;  // output row
  if (x >= w || r >= rows) return;
  const int y = row0 + r;                       // image row
  const size_t i = (size_t)r * w + x;
  const float yh = __fadd_rn((float)y, __fmul_rn(motion[i * 2 + 1], (float)h));
  const float xh = __fadd_rn((float)x, __fmul_rn(motion[i * 2 + 0], (float)w));
  const float y0f = floorf(yh), x0f = floorf(xh);
  const float fy = __fsub_rn(yh, y0f), fx = __fsub_rn(xh, x0f);
  const int y0i = (int)y0f, x0i = (int)x0f;

  // taps k0 .. k0 + NT - 1 around the floor
  constexpr int NT = FILTER == BILINEAR ? 2 : 4;
  constexpr int k0 = FILTER == BILINEAR ? 0 : -1;
  float wx[NT];
  int xi[NT];
  for (int kx = 0; kx < NT; ++kx) {
    const float d = __fsub_rn(fx, (float)(kx + k0));
    wx[kx] = FILTER == BILINEAR ? w_bl(d) : w_cr(d);
    xi[kx] = min(max(x0i + kx + k0, 0), w - 1);
  }
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ky = 0; ky < NT; ++ky) {
    const float d = __fsub_rn(fy, (float)(ky + k0));
    const float wy = FILTER == BILINEAR ? w_bl(d) : w_cr(d);
    const size_t row = (size_t)min(max(y0i + ky + k0, 0), h - 1) * w;
    for (int kx = 0; kx < NT; ++kx) {
      const float wt = __fmul_rn(wy, wx[kx]);
      const size_t t = (row + xi[kx]) * 3;
      for (int c = 0; c < 3; ++c) {
        a[c] = fmaf(wt, widen(color[t + c]), a[c]);
        a[3 + c] = fmaf(wt, widen(color2[t + c]), a[3 + c]);
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

template <typename T, int FILTER>
void launch(const void* color, const void* color2, const void* depth,
            const void* count, const int* mat, const float* motion, int h,
            int w, int row0, int rows, float* o_color, float* o_color2,
            float* o_depth, float* o_count, int* o_mat, uint8_t* o_ok,
            cudaStream_t s) {
  dim3 block(BW, BH);
  dim3 grid((w + BW - 1) / BW, (rows + BH - 1) / BH);
  reproject_kernel<T, FILTER><<<grid, block, 0, s>>>(
      static_cast<const T*>(color), static_cast<const T*>(color2),
      static_cast<const T*>(depth), static_cast<const T*>(count), mat, motion,
      h, w, row0, rows, o_color, o_color2, o_depth, o_count, o_mat, o_ok);
}

}  // namespace

// History planes are (h, w), bfloat16 when is_bf16, else float32; motion
// and the outputs are (rows, w), output row r at image row row0 + r (row0
// = 0, rows = h: the whole image).  filter is 0 (Catmull-Rom) or 1
// (bilinear); another filter, or rows that leave [0, h), is refused
// (cudaErrorInvalidValue) before anything launches; o_ok is a bool (one
// byte) plane.
extern "C" int rtrt_reproject(const void* color, const void* color2,
                              const void* depth, const void* count,
                              const int* mat, const float* motion, int h,
                              int w, int row0, int rows, int is_bf16,
                              int filter, float* o_color, float* o_color2,
                              float* o_depth, float* o_count, int* o_mat,
                              uint8_t* o_ok, void* stream) {
  if ((filter != CATMULL_ROM && filter != BILINEAR) || row0 < 0 ||
      rows < 0 || row0 + rows > h)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && w > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTRT_K5(T, F)                                                        \
  launch<T, F>(color, color2, depth, count, mat, motion, h, w, row0, rows,  \
               o_color, o_color2, o_depth, o_count, o_mat, o_ok, s)
    if (is_bf16 && filter == BILINEAR)
      RTRT_K5(__nv_bfloat16, BILINEAR);
    else if (is_bf16)
      RTRT_K5(__nv_bfloat16, CATMULL_ROM);
    else if (filter == BILINEAR)
      RTRT_K5(float, BILINEAR);
    else
      RTRT_K5(float, CATMULL_ROM);
#undef RTRT_K5
  }
  return static_cast<int>(cudaGetLastError());
}
