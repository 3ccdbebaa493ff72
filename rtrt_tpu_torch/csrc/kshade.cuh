// Per-thread shading library of the megakernel (K2): the CUDA form of
// rtrt_tpu_torch/render/kshade.py, itself the port of
// rtrt_tpu/render/kshade.py.  Every function mirrors its torch twin
// operation for operation: the counter-based RNG (PCG hash + Owen-scrambled
// Sobol, native uint32_t math, bit-exact), the component-form BSDFs
// (Lambert, mirror, Fresnel glass, GGX with VNDF sampling), sun and
// sphere-light NEE with the power heuristic, material-row select, normal
// orientation, the procedural soil texture and the Fourier-fitted textures
// (render/ftex.py).
//
// Differences from the torch form are per-thread control flow only: where
// the vector form computes every lobe and selects by material type, this
// form computes the selected lobe.  Arithmetic stays IEEE float32 (no fast
// math); nvcc's FMA contraction gives ulp-level drift.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rtrt {

constexpr double PI_D = 3.141592653589793;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float INV_PI_F = 0.3183098861837907f;
constexpr float INV_2POW24 = 5.960464477539063e-08f;
constexpr int MAT_LAMBERT = 0;
constexpr int MAT_MIRROR = 1;
constexpr int MAT_GLASS = 2;
constexpr int MAT_GGX = 3;
constexpr int MAT_EMISSIVE = 4;
constexpr int MAT_ROW = 16;
constexpr int LIGHT_ROW = 8;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return V3{x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float vlum(V3 a) {
  return a.x * 0.2126f + a.y * 0.7152f + a.z * 0.0722f;
}
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
// 1/sqrt with IEEE sqrt and division (rsqrtf is approximate)
__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}
__device__ __forceinline__ V3 vnormalize(V3 a) {
  float n2 = vdot(a, a);
  float inv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  return a * inv;
}
__device__ __forceinline__ V3 reflect_c(V3 d, V3 n) {
  float k = 2.0f * vdot(d, n);
  return d - n * k;
}

// ---------------------------------------------------------------------------
// RNG
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t hash_pcg(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return hash_pcg(a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2)));
}
__device__ __forceinline__ uint32_t sobol_dim1(uint32_t index) {
  uint32_t r = 0u, v = 0x80000000u;
  for (int k = 0; k < 32; ++k) {
    if ((index >> k) & 1u) r ^= v;
    v ^= v >> 1;
  }
  return r;
}
__device__ __forceinline__ uint32_t owen_scramble(uint32_t x, uint32_t seed) {
  x = __brev(x) + seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return __brev(x);
}
__device__ __forceinline__ float to_unit_float(uint32_t u) {
  return (float)(int)(u >> 8) * INV_2POW24;
}
__device__ __forceinline__ void rand2(uint32_t pix, uint32_t frame,
                                      uint32_t dim, float& u1, float& u2) {
  uint32_t seed = hash_combine(pix, dim * 0x9E3779B9u);
  uint32_t sh = owen_scramble(frame, hash_combine(seed, 0x4D595DF4u));
  uint32_t x = owen_scramble(__brev(sh), hash_combine(seed, 0x968B6B5Au));
  uint32_t y = owen_scramble(sobol_dim1(sh), hash_combine(seed, 0x6E62F19Bu));
  u1 = to_unit_float(x);
  u2 = to_unit_float(y);
}
// The blue-noise pair of a pixel is the shared sequence rand2(0, frame, dim)
// rotated by the pixel's mask offsets and the dim's shift (sx, sy).  All but
// the rotation depends on (frame, dim) only, so a launch computes it once
// per dim into a table (render/kshade.py::sampler_table is its torch twin):
// slot b * SAMPLER_SEGS + s holds (u1, u2, sx, sy) of dim sampler_dim(b, s).
// The megakernel draws dims 2 + 2s (BSDF), 64 + 2s (light), 128 + 2s
// (shadow-or-scatter choice) and 192 + 2s (sphere-light pick), s < 5:
// SAMPLER_SEGS is the most segments a launch traces (its `segments`).
constexpr int SAMPLER_SEGS = 5;
constexpr int SAMPLER_SLOTS = 4 * SAMPLER_SEGS;
__device__ __forceinline__ uint32_t sampler_dim(int base, int seg) {
  return (base == 0 ? 2u : 64u * (uint32_t)base) + 2u * (uint32_t)seg;
}
__device__ __forceinline__ float4 sampler_entry(uint32_t frame,
                                                uint32_t dim) {
  float4 e;
  rand2(0u, frame, dim, e.x, e.y);
  e.z = to_unit_float(hash_pcg(dim ^ 0xA511E9B3u));
  e.w = to_unit_float(hash_pcg(dim ^ 0x63D83595u));
  return e;
}
// the per-pixel part: Cranley-Patterson rotation by (bnx, bny) + (sx, sy)
__device__ __forceinline__ void bn_rotate(float4 e, float bnx, float bny,
                                          float& u, float& v) {
  float ox = bnx + e.z, oy = bny + e.w;
  u = e.x + (ox - floorf(ox));
  v = e.y + (oy - floorf(oy));
  u = u - floorf(u);
  v = v - floorf(v);
}

// per-pixel sampler: blue-noise rotation of the launch's table (in shared
// memory), or per-pixel Sobol
struct Sampler {
  uint32_t pix, frame;
  float bnx, bny;
  bool use_bn;
  const float4* table;
  // the pair of dim sampler_dim(base, seg)
  __device__ __forceinline__ void get(int base, int seg, float& u1,
                                      float& u2) const {
    if (use_bn)
      bn_rotate(table[base * SAMPLER_SEGS + seg], bnx, bny, u1, u2);
    else
      rand2(pix, frame, sampler_dim(base, seg), u1, u2);
  }
};

// ---------------------------------------------------------------------------
// warps
// ---------------------------------------------------------------------------

__device__ __forceinline__ void concentric_disk(float u1, float u2, float& px,
                                                float& py) {
  float ox = 2.0f * u1 - 1.0f;
  float oy = 2.0f * u2 - 1.0f;
  bool zero = (ox == 0.0f) && (oy == 0.0f);
  bool use_x = fabsf(ox) > fabsf(oy);
  float r = use_x ? ox : oy;
  float theta =
      use_x ? (float)(PI_D / 4.0) * (oy / (ox == 0.0f ? 1.0f : ox))
            : (float)(PI_D / 2.0) -
                  (float)(PI_D / 4.0) * (ox / (oy == 0.0f ? 1.0f : oy));
  px = zero ? 0.0f : r * cosf(theta);
  py = zero ? 0.0f : r * sinf(theta);
}
__device__ __forceinline__ V3 uniform_cone(float u1, float u2, float cmax) {
  float cos_t = (1.0f - u1) + u1 * cmax;
  float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  float phi = TWO_PI_F * u2;
  return v3(cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
}
__device__ __forceinline__ float power_heuristic(float f, float g) {
  return (f + g > 0.0f) ? (f * f) / fmaxf(f * f + g * g, 1e-20f) : 0.0f;
}
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
  float s = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (s + n.z);
  float bb = n.x * n.y * a;
  t = v3(1.0f + s * n.x * n.x * a, s * bb, -s * n.x);
  b = v3(bb, s + n.y * n.y * a, -n.y);
}
__device__ __forceinline__ V3 local_to_world(V3 l, V3 n) {
  V3 t, b;
  onb(n, t, b);
  return t * l.x + b * l.y + n * l.z;
}

// ---------------------------------------------------------------------------
// BSDF
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
  cos_i = clampf(cos_i, 0.0f, 1.0f);
  float sin2_t = (1.0f - cos_i * cos_i) / fmaxf(eta * eta, 1e-8f);
  if (sin2_t >= 1.0f) return 1.0f;
  float cos_t = sqrtf(fmaxf(0.0f, 1.0f - sin2_t));
  float r_par = (eta * cos_i - cos_t) / fmaxf(eta * cos_i + cos_t, 1e-8f);
  float r_perp = (cos_i - eta * cos_t) / fmaxf(cos_i + eta * cos_t, 1e-8f);
  return clampf(0.5f * (r_par * r_par + r_perp * r_perp), 0.0f, 1.0f);
}
__device__ __forceinline__ float ggx_d(float n_dot_h, float alpha) {
  float a2 = alpha * alpha;
  float d = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
  return a2 / fmaxf(PI_F * d * d, 1e-8f);
}
__device__ __forceinline__ float smith_g1(float n_dot_v, float alpha) {
  float a2 = alpha * alpha;
  float denom =
      n_dot_v + sqrtf(fmaxf(a2 + (1.0f - a2) * n_dot_v * n_dot_v, 0.0f));
  return 2.0f * n_dot_v / fmaxf(denom, 1e-8f);
}
__device__ __forceinline__ V3 fresnel_schlick(float cos_theta, V3 f0) {
  float m = clampf(1.0f - cos_theta, 0.0f, 1.0f);
  float m5 = m * m * m * m * m;
  return v3(f0.x + (1.0f - f0.x) * m5, f0.y + (1.0f - f0.y) * m5,
            f0.z + (1.0f - f0.z) * m5);
}
__device__ __forceinline__ V3 ggx_sample_h(V3 n, V3 wo, float u1, float u2,
                                           float alpha) {
  V3 t, b;
  onb(n, t, b);
  float vx = vdot(wo, t), vy = vdot(wo, b);
  float vz = fmaxf(vdot(wo, n), 1e-6f);
  float vhx = alpha * vx, vhy = alpha * vy, vhz = vz;
  float inv_len = rsqrt_ieee(fmaxf(vhx * vhx + vhy * vhy + vhz * vhz, 1e-20f));
  vhx *= inv_len;
  vhy *= inv_len;
  vhz *= inv_len;
  float lensq = vhx * vhx + vhy * vhy;
  float invl = rsqrt_ieee(fmaxf(lensq, 1e-20f));
  bool ok = lensq > 1e-12f;
  float t1x = ok ? -vhy * invl : 1.0f;
  float t1y = ok ? vhx * invl : 0.0f;
  float t2x = -vhz * t1y;
  float t2y = vhz * t1x;
  float t2z = vhx * t1y - vhy * t1x;
  float r = sqrtf(u1);
  float phi = (float)(2.0 * PI_D) * u2;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float s = 0.5f * (1.0f + vhz);
  p2 = (1.0f - s) * sqrtf(fmaxf(0.0f, 1.0f - p1 * p1)) + s * p2;
  float p3 = sqrtf(fmaxf(0.0f, 1.0f - p1 * p1 - p2 * p2));
  float nhx = p1 * t1x + p2 * t2x + p3 * vhx;
  float nhy = p1 * t1y + p2 * t2y + p3 * vhy;
  float nhz = p2 * t2z + p3 * vhz;
  float hx = alpha * nhx, hy = alpha * nhy, hz = fmaxf(nhz, 1e-6f);
  float inv_h = rsqrt_ieee(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
  hx *= inv_h;
  hy *= inv_h;
  hz *= inv_h;
  return t * hx + b * hy + n * hz;
}
// GGX f and VNDF pdf of wi; returns false (f = 0, pdf = 0) when invalid
__device__ __forceinline__ void ggx_eval(V3 n, V3 wo, V3 wi, V3 albedo, V3 f0,
                                         float alpha, V3& f, float& pdf) {
  V3 h = vnormalize(wo + wi);
  float n_dot_v = fmaxf(vdot(n, wo), 0.0f);
  float n_dot_l = fmaxf(vdot(n, wi), 0.0f);
  float n_dot_h = fmaxf(vdot(n, h), 0.0f);
  float v_dot_h = fmaxf(vdot(wo, h), 0.0f);
  float d = ggx_d(n_dot_h, alpha);
  float g = smith_g1(n_dot_v, alpha) * smith_g1(n_dot_l, alpha);
  V3 f_spec = fresnel_schlick(v_dot_h, f0);
  float scale = d * g / fmaxf(4.0f * n_dot_v * n_dot_l, 1e-6f);
  bool valid = (n_dot_l > 0.0f) && (n_dot_v > 0.0f);
  f = valid ? (f_spec * albedo) * scale : v3(0.0f, 0.0f, 0.0f);
  pdf = valid ? smith_g1(n_dot_v, alpha) * d / fmaxf(4.0f * n_dot_v, 1e-6f)
              : 0.0f;
}

struct BsdfSample {
  V3 wi, weight;
  float pdf;
  bool is_delta;
};

__device__ __forceinline__ BsdfSample sample_bsdf(int mtype, V3 albedo,
                                                  float rough, float ior,
                                                  V3 f0, V3 n, V3 wo,
                                                  bool inside, float u1,
                                                  float u2) {
  BsdfSample s;
  V3 wi;
  if (mtype == MAT_LAMBERT) {
    float dx, dy;
    concentric_disk(u1, u2, dx, dy);
    float z = sqrtf(fmaxf(0.0f, 1.0f - dx * dx - dy * dy));
    wi = local_to_world(v3(dx, dy, z), n);
    s.weight = albedo;
    s.pdf = fmaxf(vdot(n, wi), 0.0f) * INV_PI_F;
  } else if (mtype == MAT_MIRROR) {
    wi = reflect_c(-wo, n);
    s.weight = albedo;
    s.pdf = 1.0f;
  } else if (mtype == MAT_GLASS) {
    float eta = inside ? ior : 1.0f / ior;
    float cos_i = fmaxf(vdot(wo, n), 0.0f);
    float fr = fresnel_dielectric(cos_i, 1.0f / fmaxf(eta, 1e-6f));
    V3 d = -wo;
    float ci = -vdot(d, n);
    float sin2_t = eta * eta * fmaxf(0.0f, 1.0f - ci * ci);
    bool tir = sin2_t >= 1.0f;
    float cos_t = sqrtf(fmaxf(0.0f, 1.0f - sin2_t));
    V3 refr = d * eta + n * (eta * ci - cos_t);
    V3 refl = reflect_c(d, n);
    V3 refr_dir = tir ? refl : refr;
    wi = ((u1 < fr) || tir) ? reflect_c(-wo, n) : refr_dir;
    s.weight = albedo;
    s.pdf = 1.0f;
  } else {
    float alpha = fmaxf(rough * rough, 1e-4f);
    V3 h = ggx_sample_h(n, wo, u1, u2, alpha);
    wi = reflect_c(-wo, h);
    V3 f;
    float pdf;
    ggx_eval(n, wo, wi, albedo, f0, alpha, f, pdf);
    float cos_g = fmaxf(vdot(n, wi), 0.0f);
    s.weight = pdf > 1e-7f ? f * (cos_g / fmaxf(pdf, 1e-7f))
                           : v3(0.0f, 0.0f, 0.0f);
    s.pdf = mtype == MAT_GGX ? pdf : 1.0f;
  }
  s.wi = vnormalize(wi);
  s.is_delta = (mtype == MAT_MIRROR) || (mtype == MAT_GLASS);
  return s;
}

__device__ __forceinline__ void eval_bsdf(int mtype, V3 albedo, float rough,
                                          V3 f0, V3 n, V3 wo, V3 wi, V3& f,
                                          float& pdf) {
  float cos_l = fmaxf(vdot(n, wi), 0.0f);
  f = v3(0.0f, 0.0f, 0.0f);
  pdf = 0.0f;
  if (!(cos_l > 0.0f)) return;
  if (mtype == MAT_LAMBERT) {
    f = albedo * INV_PI_F;
    pdf = cos_l * INV_PI_F;
  } else if (mtype == MAT_GGX) {
    ggx_eval(n, wo, wi, albedo, f0, fmaxf(rough * rough, 1e-4f), f, pdf);
  }
}

// ---------------------------------------------------------------------------
// sun NEE (constants host-folded in float64, passed in)
// ---------------------------------------------------------------------------

struct SunC {
  V3 dir, t, b, trans;
  float intensity;
  float cos_max, sin2_max, disk_omega, disk_pdf;
};

__device__ __forceinline__ V3 sun_disk_radiance(const SunC& sun, V3 d) {
  float cos_g = vdot(d, sun.dir);
  if (!(cos_g > sun.cos_max)) return v3(0.0f, 0.0f, 0.0f);
  float sin2 = fmaxf(1.0f - cos_g * cos_g, 0.0f);
  float mu = sqrtf(fmaxf(1.0f - sin2 / sun.sin2_max, 0.0f));
  float limb = 1.0f - 0.6f * (1.0f - mu);
  float s = (sun.intensity / sun.disk_omega) * limb;
  return sun.trans * s;
}
__device__ __forceinline__ void sample_sun(const SunC& sun, float u1, float u2,
                                           V3& wi, V3& rad, float& pdf) {
  V3 l = uniform_cone(u1, u2, sun.cos_max);
  wi = vnormalize(sun.t * l.x + sun.b * l.y + sun.dir * l.z);
  rad = sun.dir.y > -0.05f ? sun_disk_radiance(sun, wi)
                           : v3(0.0f, 0.0f, 0.0f);
  pdf = sun.disk_pdf;
}

// ---------------------------------------------------------------------------
// procedural soil texture
// ---------------------------------------------------------------------------

__device__ __forceinline__ float hash3(int ix, int iy, int iz, uint32_t seed) {
  uint32_t h = (((uint32_t)ix * 0x8DA6B343u) ^ ((uint32_t)iy * 0xD8163841u) ^
                ((uint32_t)iz * 0xCB1AB31Fu)) + seed;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return (float)(int)(h >> 8) * INV_2POW24;
}
__device__ __forceinline__ float value_noise3(float px, float py, float pz,
                                              uint32_t seed) {
  float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  int ix = (int)fx, iy = (int)fy, iz = (int)fz;
  float rx = px - fx, ry = py - fy, rz = pz - fz;
  float wx = rx * rx * rx * (rx * (rx * 6.0f - 15.0f) + 10.0f);
  float wy = ry * ry * ry * (ry * (ry * 6.0f - 15.0f) + 10.0f);
  float wz = rz * rz * rz * (rz * (rz * 6.0f - 15.0f) + 10.0f);
  float c000 = hash3(ix, iy, iz, seed), c100 = hash3(ix + 1, iy, iz, seed);
  float c010 = hash3(ix, iy + 1, iz, seed);
  float c110 = hash3(ix + 1, iy + 1, iz, seed);
  float c001 = hash3(ix, iy, iz + 1, seed);
  float c101 = hash3(ix + 1, iy, iz + 1, seed);
  float c011 = hash3(ix, iy + 1, iz + 1, seed);
  float c111 = hash3(ix + 1, iy + 1, iz + 1, seed);
  float x00 = c000 + (c100 - c000) * wx;
  float x10 = c010 + (c110 - c010) * wx;
  float x01 = c001 + (c101 - c001) * wx;
  float x11 = c011 + (c111 - c011) * wx;
  float y0 = x00 + (x10 - x00) * wy;
  float y1 = x01 + (x11 - x01) * wy;
  return y0 + (y1 - y0) * wz;
}
__device__ __forceinline__ float fbm3(float px, float py, float pz, float cw,
                                      int octaves, float base_freq,
                                      uint32_t seed) {
  float total = 0.0f, norm = 0.0f, amp = 1.0f, freq = base_freq;
  for (int k = 0; k < octaves; ++k) {
    float fade = clampf(1.0f - cw * freq * 1.5f, 0.0f, 1.0f);
    float n = value_noise3(px * freq, py * freq, pz * freq, seed + k * 131);
    total = total + amp * (0.5f + (n - 0.5f) * fade);
    norm += amp;
    amp *= 0.5f;
    freq *= 2.0f;
  }
  return total / norm;
}
__device__ __forceinline__ void soil_shading(V3 pos, V3 ns, float cone_width,
                                             V3& alb_out, float& rough,
                                             V3& n_out) {
  const float ws = 0.35f;
  float px = pos.x * ws, py = pos.y * ws, pz = pos.z * ws;
  float cw = cone_width * ws;
  float h = fbm3(px, py, pz, cw, 4, 1.0f, 101u);
  float detail = fbm3(px, py, pz, cw, 3, 6.0f, 202u);
  float t = clampf(h * 1.4f - 0.2f, 0.0f, 1.0f);
  V3 alb = v3(0.23f, 0.15f, 0.09f) * (1.0f - t) + v3(0.42f, 0.30f, 0.18f) * t;
  float t2 = clampf(detail * 1.2f - 0.3f, 0.0f, 1.0f);
  alb = alb * (1.0f - 0.4f * t2) + v3(0.55f, 0.47f, 0.35f) * (0.4f * t2);
  float ao = clampf(0.55f + 0.45f * h, 0.0f, 1.0f);
  rough = clampf(0.55f + 0.4f * detail + 0.15f * (1.0f - h), 0.05f, 1.0f);
  float bump_fade = clampf(1.0f - cw * 8.0f, 0.0f, 1.0f);
  float bx = fbm3(px + 17.17f, py + 17.17f, pz + 17.17f, cw, 2, 5.0f, 303u);
  float by = fbm3(px + 29.29f, py + 29.29f, pz + 29.29f, cw, 2, 5.0f, 404u);
  float bz = fbm3(px + 43.43f, py + 43.43f, pz + 43.43f, cw, 2, 5.0f, 505u);
  V3 bump = v3(bx - 0.5f, by - 0.5f, bz - 0.5f);
  n_out = vnormalize(ns + bump * (0.8f * bump_fade));
  alb_out = alb * ao;
}

// ---------------------------------------------------------------------------
// Fourier-fitted textures (render/ftex.py::ftex_shading_c)
// ---------------------------------------------------------------------------

// the fit's coefficient table (render/ftex.py::pack_ftex, whose FTEX_*
// constants these must equal): a row a texture (albedo + AO, normal +
// roughness), FTEX_HEAD floats (4 channel means, the world scale: texture
// tiles a world unit) then FTEX_ATOM floats for each of the fit's
// FTEX_ATOMS atoms (2 pi fx, 2 pi fy, -2 pi^2 |f|^2, 0, the cosine term's 4
// weights, the sine term's 4)
constexpr int FTEX_ATOMS = 24;
constexpr int FTEX_HEAD = 8;
constexpr int FTEX_ATOM = 12;
constexpr int FTEX_ROW = FTEX_HEAD + FTEX_ATOMS * FTEX_ATOM;

// The table lives in constant memory, copied on the stream before each
// launch that shades from it (megakernel.cu).  The lanes of a warp that
// shade a textured hit walk the same atom at the same step, so every read
// is one broadcast, and the coefficients hold no registers.
__constant__ float c_ftex[2][FTEX_ROW];

// One texture's triplanar series at a hit: out = (wx c_x + wy c_y + wz c_z)
// inv, where c_p is the series at plane p's coordinates (u[p], v[p]) with
// the Gaussian LOD exp(-2 pi^2 |f|^2 s2).  An atom's LOD factor serves its
// three planes, and its cosine and sine terms share one sincosf of their
// angle, formed without FMA contraction as the plain version forms it: the
// cosine term's argument is the plain version's bit for bit; the sine term
// is sin(angle) where the plain version takes cos(angle + (-pi/2)), whose
// sum rounds once more (half an ulp of the angle).  sincosf stays accurate
// at the hundreds of radians of the terrain's far hits.
__device__ __forceinline__ void ftex_triplanar(int tex, const float u[3],
                                               const float v[3], float s2,
                                               float wx, float wy, float wz,
                                               float inv, float out[4]) {
  const float* row = c_ftex[tex];
  float acc[3][4];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] = row[c];
#pragma unroll 1
  for (int k = 0; k < FTEX_ATOMS; ++k) {
    const float* a = row + FTEX_HEAD + FTEX_ATOM * k;
    const float att = expf(a[2] * s2);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float ang =
          __fadd_rn(__fmul_rn(a[0], u[p]), __fmul_rn(a[1], v[p]));
      float sn, cs;
      sincosf(ang, &sn, &cs);
      const float ct = cs * att, st = sn * att;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[p][c] = fmaf(a[8 + c], st, fmaf(a[4 + c], ct, acc[p][c]));
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out[c] = (wx * acc[0][c] + wy * acc[1][c] + wz * acc[2][c]) * inv;
}

// the textured material from the fit: soil_shading's interface
__device__ __forceinline__ void ftex_shading(V3 pos, V3 ns, float cone_width,
                                             V3& alb_out, float& rough,
                                             V3& n_out) {
  const float ws = c_ftex[0][4];  // texture tiles per world unit
  const float ax = fabsf(ns.x), ay = fabsf(ns.y), az = fabsf(ns.z);
  const float wx = ax * ax * ax * ax, wy = ay * ay * ay * ay,
              wz = az * az * az * az;
  const float inv = 1.0f / fmaxf(wx + wy + wz, 1e-8f);
  const float sigma = fmaxf(cone_width, 0.0f) * (ws * 0.5f);
  const float s2 = sigma * sigma;
  // the planes' coordinates: x (y, z), y (x, z), z (x, y)
  const float u[3] = {pos.y * ws, pos.x * ws, pos.x * ws};
  const float v[3] = {pos.z * ws, pos.z * ws, pos.y * ws};
  float a[4], nr[4];
  ftex_triplanar(0, u, v, s2, wx, wy, wz, inv, a);
  ftex_triplanar(1, u, v, s2, wx, wy, wz, inv, nr);
  const float ao = clampf(a[3], 0.0f, 1.0f);
  alb_out = v3(clampf(a[0], 0.0f, 1.0f) * ao, clampf(a[1], 0.0f, 1.0f) * ao,
               clampf(a[2], 0.0f, 1.0f) * ao);
  rough = clampf(nr[3], 0.05f, 1.0f);
  // the texture normal is y-up local: into the surface frame
  V3 t, b;
  onb(ns, t, b);
  n_out = vnormalize(t * nr[0] + b * nr[2] + ns * fmaxf(nr[1], 0.2f));
}

// ---------------------------------------------------------------------------
// materials, normals, sphere lights
// ---------------------------------------------------------------------------

struct Material {
  int mtype;
  V3 albedo, emission, f0;
  float rough, ior;
  bool textured;
};

__device__ __forceinline__ Material material_select(const float* rows,
                                                    int n_mat, int m) {
  Material r;
  if (m < 0 || m >= n_mat) {
    r.mtype = 0;
    r.albedo = r.emission = r.f0 = v3(0.0f, 0.0f, 0.0f);
    r.rough = 0.0f;
    r.ior = 1.0f;
    r.textured = false;
    return r;
  }
  const float* p = rows + m * MAT_ROW;
  r.mtype = (int)p[0];
  r.albedo = v3(p[1], p[2], p[3]);
  r.emission = v3(p[4], p[5], p[6]);
  r.rough = p[7];
  r.ior = p[8];
  r.f0 = v3(p[9], p[10], p[11]);
  r.textured = p[12] != 0.0f;
  return r;
}

__device__ __forceinline__ void orient_normals(V3 ns_raw, V3 ng_raw, V3 wo,
                                               V3& ns, V3& ng) {
  ng = vnormalize(ng_raw);
  ns = vnormalize(ns_raw);
  float flip = sgn(vdot(ng, wo));
  if (flip == 0.0f) flip = 1.0f;
  ng = ng * flip;
  ns = ns * sgn(vdot(ns, ng));
  if (!(vdot(ns, wo) > 0.0f)) ns = ng;
}

__device__ __forceinline__ bool ray_sphere(V3 org, V3 d, V3 c, float radius,
                                           float& t) {
  V3 oc = org - c;
  float b = vdot(oc, d);
  float cc = vdot(oc, oc) - radius * radius;
  float disc = b * b - cc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t0 = -b - sq, t1 = -b + sq;
  t = t0 > 1e-4f ? t0 : t1;
  bool hit = (disc >= 0.0f) && (t > 1e-4f);
  if (!hit) t = CUDART_INF_F;
  return hit;
}
__device__ __forceinline__ float uniform_cone_pdf(float cmax) {
  return 1.0f / (TWO_PI_F * fmaxf(1.0f - cmax, 1e-8f));
}
__device__ __forceinline__ float sphere_lights_pdf(const float* rows,
                                                   int n_lights, V3 org,
                                                   V3 d) {
  float pdf = 0.0f;
  for (int li = 0; li < n_lights; ++li) {
    const float* r = rows + li * LIGHT_ROW;
    V3 to_c = v3(r[0], r[1], r[2]) - org;
    float d2 = fmaxf(vdot(to_c, to_c), 1e-8f);
    float sin2 = clampf(r[3] * r[3] / d2, 0.0f, 0.9999f);
    float cos_max = sqrtf(1.0f - sin2);
    float inv_dist = rsqrt_ieee(d2);
    float cosg = vdot(d, to_c * inv_dist);
    pdf = pdf + (cosg > cos_max ? uniform_cone_pdf(cos_max) / n_lights : 0.0f);
  }
  return pdf;
}
__device__ __forceinline__ void sample_sphere_light(const float* rows, int li,
                                                    V3 p, float u1, float u2,
                                                    V3& wi, V3& em,
                                                    float& pdf,
                                                    float& dist_out) {
  const float* r = rows + li * LIGHT_ROW;
  V3 c = v3(r[0], r[1], r[2]);
  float radius = r[3];
  em = v3(r[4], r[5], r[6]);
  V3 to_c = c - p;
  float d2 = fmaxf(vdot(to_c, to_c), 1e-8f);
  float dist = sqrtf(d2);
  V3 axis = to_c * (1.0f / dist);
  float sin2_max = clampf(radius * radius / d2, 0.0f, 0.9999f);
  float cos_max = sqrtf(1.0f - sin2_max);
  V3 l = uniform_cone(u1, u2, cos_max);
  wi = vnormalize(local_to_world(l, axis));
  pdf = uniform_cone_pdf(cos_max);
  float hd = dist * l.z -
             sqrtf(fmaxf(radius * radius - d2 * (1.0f - l.z * l.z), 0.0f));
  dist_out = fmaxf(hd, 0.0f);
}

}  // namespace rtrt
