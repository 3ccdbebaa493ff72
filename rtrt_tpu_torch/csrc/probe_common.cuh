// Shared pieces of the probes K6-K9 (probe_step.cu, probe_leaf.cu,
// probe_cores.cu) and K10-K16 (probe_consume.cu, probe_record.cu,
// probe_bf16.cu).
//
// A probe runs its (rows, 128) ray tile on ONE thread block where its
// outputs depend on tile-wide state that the block exchanges every step (a
// tile-wide max (K7)), on one thread-block cluster of a few blocks where
// that state is a min or a stack (K6, K8 / K9, K14, with probe_tile.cuh's
// reduction), or on a grid of plain blocks where no lane waits for another
// block (K11, K15, K16) or every block can compute the one scalar it
// waits for itself (K10, K12, K13).  A thread carries L lanes (a
// compile-time count); lane j of thread t is element t + j * blockDim.x
// of its block's part of the tile.  Where the tile shares a scalar (bound, stack pointer,
// popped entry, step flag), every thread holds the same value, so every
// branch on it is uniform.
//
// Arithmetic: products go through __fmul_rn so that nvcc never contracts
// a product and a sum into one FMA; each operation then rounds as the
// plain PyTorch version's does, and kernel and plain version agree bit for
// bit.  No fast math.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace probe {

constexpr float RAY_TMIN = 1e-4f;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

template <int N, bool kMax>
__device__ __forceinline__ void warp_reduce(float (&v)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[n], off);
      v[n] = kMax ? fmaxf(v[n], o) : fminf(v[n], o);
    }
  }
}

// redux for int32 (K14's tile-wide min of pend): exact at any magnitude
template <int N, bool kMax>
__device__ __forceinline__ void warp_reduce(int (&v)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    v[n] = kMax ? __reduce_max_sync(0xffffffffu, v[n])
                : __reduce_min_sync(0xffffffffu, v[n]);
}

// Slab test of one ray (origin o, inverse direction i) against the box
// [lo xyz | hi xyz] at b, as the probes' slab(): entry distance in tn.
__device__ __forceinline__ bool slab(const float* b, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float best, float& tn) {
  const float n0 = ((ix < 0.0f ? b[3] : b[0]) - ox) * ix;
  const float n1 = ((iy < 0.0f ? b[4] : b[1]) - oy) * iy;
  const float n2 = ((iz < 0.0f ? b[5] : b[2]) - oz) * iz;
  const float f0 = ((ix < 0.0f ? b[0] : b[3]) - ox) * ix;
  const float f1 = ((iy < 0.0f ? b[1] : b[4]) - oy) * iy;
  const float f2 = ((iz < 0.0f ? b[2] : b[5]) - oz) * iz;
  tn = fmaxf(fmaxf(n0, n1), n2);
  const float tf = fminf(fminf(f0, f1), f2);
  return (tn <= tf) && (tf > RAY_TMIN) && (tn < best);
}

// One triangle record [v0 | e1 | e2] against one ray: Moller-Trumbore with
// the division-free accept of tools/probe_leaf.py::tri_hit (and
// probe_cores.py::tri_hit, the same code); t in t.
__device__ __forceinline__ bool tri_hit(const float (&v)[9], float ox,
                                        float oy, float oz, float dx,
                                        float dy, float dz, float best,
                                        float& t) {
  const float v0x = v[0], v0y = v[1], v0z = v[2];
  const float e1x = v[3], e1y = v[4], e1z = v[5];
  const float e2x = v[6], e2y = v[7], e2z = v[8];
  const float px = ox - v0x, py = oy - v0y, pz = oz - v0z;
  const float hx = mul(dy, e2z) - mul(dz, e2y);
  const float hy = mul(dz, e2x) - mul(dx, e2z);
  const float hz = mul(dx, e2y) - mul(dy, e2x);
  const float det = mul(e1x, hx) + mul(e1y, hy) + mul(e1z, hz);
  const float uq = mul(px, hx) + mul(py, hy) + mul(pz, hz);
  const float qx = mul(py, e1z) - mul(pz, e1y);
  const float qy = mul(pz, e1x) - mul(px, e1z);
  const float qz = mul(px, e1y) - mul(py, e1x);
  const float vq = mul(dx, qx) + mul(dy, qy) + mul(dz, qz);
  const float tq = mul(e2x, qx) + mul(e2y, qy) + mul(e2z, qz);
  const float adet = fabsf(det);
  const float sg = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  const float u_s = mul(uq, sg), v_s = mul(vq, sg), t_s = mul(tq, sg);
  const bool ok = (det != 0.0f) && (u_s >= 0.0f) && (v_s >= 0.0f) &&
                  (u_s + v_s <= adet) && (t_s > mul(RAY_TMIN, adet)) &&
                  (t_s < mul(best, adet));
  const float inv = det != 0.0f ? 1.0f / det : 0.0f;
  t = mul(tq, inv);
  return ok;
}

// tri_hit without the t_s > RAY_TMIN * adet test, in the form of
// tools/probe_xpose.py's visit (probe_xpose.py:55-78): the sum of u and v
// is taken before its sign product.  Returns the accept test and the
// numerator tq and det of t = tq * (1 / det), which the caller computes
// only where it accepts (det != 0 there): K15's lanes accept a record
// rarely, and a warp skips the correctly rounded reciprocal where none of
// its lanes does.
__device__ __forceinline__ bool tri_hit_no_tmin(const float (&v)[9],
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float best, float& tq,
                                                float& det) {
  const float v0x = v[0], v0y = v[1], v0z = v[2];
  const float e1x = v[3], e1y = v[4], e1z = v[5];
  const float e2x = v[6], e2y = v[7], e2z = v[8];
  const float px = ox - v0x, py = oy - v0y, pz = oz - v0z;
  const float hx = mul(dy, e2z) - mul(dz, e2y);
  const float hy = mul(dz, e2x) - mul(dx, e2z);
  const float hz = mul(dx, e2y) - mul(dy, e2x);
  det = mul(e1x, hx) + mul(e1y, hy) + mul(e1z, hz);
  const float uq = mul(px, hx) + mul(py, hy) + mul(pz, hz);
  const float qx = mul(py, e1z) - mul(pz, e1y);
  const float qy = mul(pz, e1x) - mul(px, e1z);
  const float qz = mul(px, e1y) - mul(py, e1x);
  const float vq = mul(dx, qx) + mul(dy, qy) + mul(dz, qz);
  tq = mul(e2x, qx) + mul(e2y, qy) + mul(e2z, qz);
  const float adet = fabsf(det);
  const float sg = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  return (det != 0.0f) && (mul(uq, sg) >= 0.0f) && (mul(vq, sg) >= 0.0f) &&
         (mul(uq + vq, sg) <= adet) && (mul(tq, sg) < mul(best, adet));
}

}  // namespace probe
