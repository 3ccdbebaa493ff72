// K2 megakernel: the whole 5-segment bounce program of a pixel in one thread.
//
// Replaces: rtrt_tpu/render/megakernel.py::_mega_kernel (launched by
// megakernel_trace, wrapped by path_trace_mega).
//
// What bounds it on the H100: the traversal (dependent node/triangle loads,
// see traverse.cuh) five times per pixel, plus register pressure — the path
// state (~40 floats) stays live across each traversal.  Shading is a few
// hundred FLOPs per bounce; the procedural soil texture (~9 noise octaves of
// 8 hashed corners each) is the largest shading term.
//
// Simple design: one thread per pixel, 128-thread blocks over the flat image
// index.  Each segment computes the ray's t_cap (the light distance for a
// pending shadow ray, inf otherwise), traverses with K1's device function
// (traverse.cuh; any-hit for shadow rays), resolves the hit's
// attributes by a direct gather, and runs shade_segment.  The TPU kernel's
// VMEM table staging, state parking, 32-row strips, per-tile segment skips
// and i1/i32 mask round trips are TPU artifacts and are not carried over;
// a finished path simply skips its remaining segments.  Output: 18 planes
// (18, N): radiance 3, albedo 3, normal 3, depth, mat id, esc_dir 3,
// esc_beta 3, esc_pdf (-1 = delta).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "kshade.cuh"
#include "traverse.cuh"

namespace {

using rtrt::V3;
using rtrt::v3;

constexpr int SEGMENTS = 5;

struct MegaParams {
  const float* nodes;
  const float* tris;
  const float* nrm;
  const float* ng;
  const int* mat;
  const float* mat_rows;
  int n_mat;
  const float* light_rows;
  int n_lights;
  const float* sun_vec;
  float cos_max, sin2_max, disk_omega, disk_pdf;
  uint32_t frame;
  const float* org;
  const float* dir;
  const float* cone;
  const int* pix;
  const float* bn;
  int use_bn, use_proctex, n;
  float* out;
  int* overflow;
};

struct PathState {
  V3 org, dir, beta, radiance, pending, esc_dir, esc_beta, albedo, normal;
  float shadow_tmax, prev_pdf, cone, esc_pdf, depth;
  int mat_id;
  bool done, is_shadow, prev_delta, inside, esc_delta, got_primary;
};

// one bounce of shading (render/megakernel.py::shade_segment, per lane)
__device__ void shade_segment(PathState& st, const rtrt::TraceHit& hit,
                              int hmat, V3 hns, V3 hng,
                              const MegaParams& p, const rtrt::SunC& sun,
                              const rtrt::Sampler& rng, int seg,
                              bool is_last) {
  if (st.done) return;
  const float ht = hit.t;
  const bool found = hit.tri >= 0;

  // shadow-ray resolution
  const bool sh = st.is_shadow;
  if (sh && !found) st.radiance = st.radiance + st.pending;
  bool done = sh;

  // analytic sphere-light hits of scatter rays
  if (p.n_lights > 0) {
    float lt = CUDART_INF_F;
    V3 lem = v3(0.0f, 0.0f, 0.0f);
    for (int li = 0; li < p.n_lights; ++li) {
      const float* r = p.light_rows + li * rtrt::LIGHT_ROW;
      float tl;
      bool hl = rtrt::ray_sphere(st.org, st.dir, v3(r[0], r[1], r[2]), r[3],
                                 tl);
      if (hl && tl < lt) {
        lt = tl;
        lem = v3(r[4], r[5], r[6]);
      }
    }
    bool lhit = !sh && (lt < ht);
    float lpdf = rtrt::sphere_lights_pdf(p.light_rows, p.n_lights, st.org,
                                         st.dir);
    float w_l = st.prev_delta ? 1.0f
                              : rtrt::power_heuristic(st.prev_pdf,
                                                      0.5f * lpdf);
    if (lhit) st.radiance = st.radiance + (st.beta * lem) * w_l;
    done = done || lhit;
  }

  // escaped scatter rays: defer the environment to finish_gbuffer
  const bool esc = !sh && !found;
  if (esc) {
    st.esc_dir = st.dir;
    st.esc_beta = st.beta;
    st.esc_pdf = st.prev_pdf;
    st.esc_delta = st.prev_delta;
  }
  done = done || esc;
  const bool live = found && !sh && !done;
  st.done = done || (is_last && live);
  if (!live || is_last) {
    st.is_shadow = false;
    return;
  }

  // surface interaction
  const V3 wo = -st.dir;
  const float ts = rtrt::clampf(ht, 0.0f, 1e8f);
  const V3 pos = st.org + st.dir * ts;
  const float cone_w = st.cone * ts;
  V3 ns, ng;
  rtrt::orient_normals(hns, hng, wo, ns, ng);
  rtrt::Material m = rtrt::material_select(p.mat_rows, p.n_mat, hmat);
  V3 albedo = m.albedo;
  float rough = m.rough;
  if (p.use_proctex && m.textured) {
    V3 tex_alb, ns_tex;
    float tex_rough;
    rtrt::soil_shading(pos, ns, cone_w, tex_alb, tex_rough, ns_tex);
    albedo = albedo * tex_alb;
    rough = tex_rough;
    ns = ns_tex;
  }

  if (m.mtype == rtrt::MAT_EMISSIVE) {
    st.radiance = st.radiance + st.beta * m.emission;
    st.done = true;
    st.is_shadow = false;
    return;
  }

  // primary-hit G-buffer capture
  if (!st.got_primary) {
    st.normal = ns;
    st.depth = ht;
    st.mat_id = hmat;
    st.albedo = v3(fmaxf(albedo.x, 1e-3f), fmaxf(albedo.y, 1e-3f),
                   fmaxf(albedo.z, 1e-3f));
  }
  st.got_primary = true;

  float u1b, u2b, ul1, ul2, u_sel, unused;
  rng.get(2u + 2u * seg, u1b, u2b);
  rng.get(64u + 2u * seg, ul1, ul2);
  rng.get(128u + 2u * seg, u_sel, unused);

  rtrt::BsdfSample bs = rtrt::sample_bsdf(m.mtype, albedo, rough, m.ior, m.f0,
                                          ns, wo, st.inside, u1b, u2b);
  const bool rough_lane = !bs.is_delta;

  // light sample + MIS: sun NEE, 50/50 with sphere-light NEE
  V3 ls_wi, ls_rad;
  float ls_pdf;
  rtrt::sample_sun(sun, ul1, ul2, ls_wi, ls_rad, ls_pdf);
  float ls_dist = CUDART_INF_F;
  if (p.n_lights > 0) {
    const int nl = p.n_lights;
    float p1, p2;
    rng.get(192u + 2u * seg, p1, p2);
    int li = (int)(p1 * nl);
    li = li < 0 ? 0 : (li > nl - 1 ? nl - 1 : li);
    V3 sp_wi, sp_rad;
    float sp_pdf, sp_dist;
    rtrt::sample_sphere_light(p.light_rows, li, pos, ul1, ul2, sp_wi, sp_rad,
                              sp_pdf, sp_dist);
    if (p2 < 0.5f) {
      ls_wi = sp_wi;
      ls_rad = sp_rad;
      ls_pdf = 0.5f * sp_pdf / nl;
      ls_dist = sp_dist;
    } else {
      ls_pdf = 0.5f * ls_pdf;
    }
  }

  V3 f_l;
  float pdf_b_at_l;
  rtrt::eval_bsdf(m.mtype, albedo, rough, m.f0, ns, wo, ls_wi, f_l,
                  pdf_b_at_l);
  const float cos_l = fmaxf(rtrt::vdot(ns, ls_wi), 0.0f);
  const float w_l2 = rtrt::power_heuristic(ls_pdf, pdf_b_at_l);
  const float scale_l = (cos_l / fmaxf(ls_pdf, 1e-8f)) * w_l2;
  V3 c_light = ((st.beta * f_l) * ls_rad) * scale_l;
  if (!(ls_pdf > 1e-8f)) c_light = v3(0.0f, 0.0f, 0.0f);

  // stochastic single-ray choice between the shadow ray and the scatter
  const float est_l = rtrt::vlum(c_light);
  const float est_s = rtrt::vlum(st.beta * bs.weight);
  float q = (est_l + est_s > 0.0f) ? est_l / fmaxf(est_l + est_s, 1e-12f)
                                   : 0.0f;
  q = rtrt::clampf(q, 0.0f, 0.9f);
  const bool take_shadow = rough_lane && (u_sel < q) && (est_l > 0.0f);

  st.is_shadow = take_shadow;
  st.pending = take_shadow ? c_light * (1.0f / fmaxf(q, 1e-3f))
                           : v3(0.0f, 0.0f, 0.0f);
  st.shadow_tmax = take_shadow ? ls_dist : CUDART_INF_F;
  if (!take_shadow) {
    const float inv_p = rough_lane ? 1.0f / fmaxf(1.0f - q, 1e-3f) : 1.0f;
    st.beta = (st.beta * bs.weight) * inv_p;
    st.prev_pdf = bs.pdf;
    st.prev_delta = bs.is_delta;
    if (rtrt::vdot(bs.wi, ng) < 0.0f) st.inside = !st.inside;
  }
  const V3 new_dir = take_shadow ? ls_wi : bs.wi;
  const V3 off = rtrt::vdot(new_dir, ng) >= 0.0f ? ng * 1e-3f
                                                  : ng * (-1e-3f);
  st.org = pos + off;
  st.dir = new_dir;
  st.cone = cone_w;
  if (!take_shadow && rtrt::vlum(st.beta) < 1e-5f) st.done = true;
}

__global__ void __launch_bounds__(128)
    megakernel(const MegaParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  rtrt::SunC sun;
  const float* s = p.sun_vec;
  sun.dir = v3(s[0], s[1], s[2]);
  sun.t = v3(s[3], s[4], s[5]);
  sun.b = v3(s[6], s[7], s[8]);
  sun.trans = v3(s[9], s[10], s[11]);
  sun.intensity = s[12];
  sun.cos_max = p.cos_max;
  sun.sin2_max = p.sin2_max;
  sun.disk_omega = p.disk_omega;
  sun.disk_pdf = p.disk_pdf;

  rtrt::Sampler rng;
  rng.pix = (uint32_t)p.pix[i];
  rng.frame = p.frame;
  rng.use_bn = p.use_bn != 0;
  rng.bnx = rng.use_bn ? p.bn[2 * i] : 0.0f;
  rng.bny = rng.use_bn ? p.bn[2 * i + 1] : 0.0f;

  PathState st;
  st.org = v3(p.org[3 * i], p.org[3 * i + 1], p.org[3 * i + 2]);
  st.dir = v3(p.dir[3 * i], p.dir[3 * i + 1], p.dir[3 * i + 2]);
  st.beta = v3(1.0f, 1.0f, 1.0f);
  st.radiance = v3(0.0f, 0.0f, 0.0f);
  st.pending = v3(0.0f, 0.0f, 0.0f);
  st.esc_dir = st.dir;
  st.esc_beta = v3(0.0f, 0.0f, 0.0f);
  st.albedo = v3(1.0f, 1.0f, 1.0f);
  st.normal = v3(0.0f, 0.0f, 0.0f);
  st.shadow_tmax = CUDART_INF_F;
  st.prev_pdf = 0.0f;
  st.cone = p.cone[i];
  st.esc_pdf = 0.0f;
  st.depth = CUDART_INF_F;
  st.mat_id = -1;
  st.done = st.is_shadow = st.inside = st.got_primary = false;
  st.prev_delta = st.esc_delta = true;

  for (int seg = 0; seg < SEGMENTS; ++seg) {
    if (st.done) break;
    const float t_cap = st.is_shadow ? st.shadow_tmax : CUDART_INF_F;
    const rtrt::TraceHit h = rtrt::traverse(
        p.nodes, p.tris, make_float3(st.org.x, st.org.y, st.org.z),
        make_float3(st.dir.x, st.dir.y, st.dir.z), t_cap, st.is_shadow,
        p.overflow);
    int hmat;
    float3 ns, ng;
    rtrt::hit_attrs(p.nrm, p.ng, p.mat, h, hmat, ns, ng);
    shade_segment(st, h, hmat, v3(ns.x, ns.y, ns.z), v3(ng.x, ng.y, ng.z), p,
                  sun, rng, seg, seg == SEGMENTS - 1);
  }

  const float planes[18] = {
      st.radiance.x, st.radiance.y, st.radiance.z, st.albedo.x, st.albedo.y,
      st.albedo.z,   st.normal.x,   st.normal.y,   st.normal.z, st.depth,
      (float)st.mat_id, st.esc_dir.x, st.esc_dir.y, st.esc_dir.z,
      st.esc_beta.x, st.esc_beta.y, st.esc_beta.z,
      st.esc_delta ? -1.0f : st.esc_pdf};
  const size_t n = (size_t)p.n;
#pragma unroll
  for (int k = 0; k < 18; ++k) p.out[k * n + i] = planes[k];
}

}  // namespace

extern "C" int rtrt_megakernel(
    const float* nodes, const float* tris, const float* nrm, const float* ng,
    const int* mat, const float* mat_rows, int n_mat, const float* light_rows,
    int n_lights, const float* sun_vec, float cos_max, float sin2_max,
    float disk_omega, float disk_pdf, unsigned frame, const float* org,
    const float* dir, const float* cone, const int* pix, const float* bn,
    int use_bn, int use_proctex, int n, float* out, int* overflow,
    void* stream) {
  MegaParams p{nodes,    tris,     nrm,        ng,       mat,
               mat_rows, n_mat,    light_rows, n_lights, sun_vec,
               cos_max,  sin2_max, disk_omega, disk_pdf, frame,
               org,      dir,      cone,       pix,      bn,
               use_bn,   use_proctex, n,       out,      overflow};
  if (n > 0) {
    const int block = 128;
    megakernel<<<(n + block - 1) / block, block, 0,
                 static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
