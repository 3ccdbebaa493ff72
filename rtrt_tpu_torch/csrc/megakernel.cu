// K2 megakernel: the whole bounce program of a pixel in one thread: 5
// segments (scene intersects), or the launch's `segments`, 1 to 5
// (RTRT_SEGMENTS, render/integrator.py; the sampler table's slots bound it).
//
// Replaces: rtrt_tpu/render/megakernel.py::_mega_kernel (launched by
// megakernel_trace, wrapped by path_trace_mega).
//
// What bounds it on the H100: latency.  Each segment is a chain of
// dependent node and triangle loads from L2 (traverse.cuh), and the path
// state stays live across it, so few warps fit an SM to hide that latency;
// and divergence, where the lanes of a warp walk different nodes.  Of the
// operations, the procedural soil texture (13 value-noise octaves of 8
// hashed corners, ~2.8 k per textured hit) weighs as much as the
// traversal's box and triangle tests; chip_smoke.py counts both for the
// bound.  Output: 18 planes (18, N): radiance 3, albedo 3, normal 3, depth,
// mat id, esc_dir 3, esc_beta 3, esc_pdf (-1 = delta).
//
// Design:
//   * A per-launch sampler table.  With blue noise on (the default), every
//     sample of a pixel is a shared Owen-scrambled Sobol pair of (frame,
//     dim), rotated by the pixel's mask offsets.  The pair and the dim's
//     shift are the same for every pixel: a block's first 20 threads
//     compute them for the 20 dims of the launch into shared memory
//     (kshade.cuh::sampler_entry, ~300 integer operations each), and a
//     sample is then the rotation alone (12 operations), bit-identical to
//     computing it per pixel.  Without blue noise the per-pixel pair stays.
//   * Persistent lanes.  One wave of blocks (the occupancy calculator's
//     blocks per SM times the SMs, fewer for a small n) stays resident.
//     When every lane of a warp has ended its path (escaped, resolved
//     shadow ray, absorbed, or its last segment), lane 0 takes the next
//     tile of 32 pixels (8x4 on an image, a run of 32 on a flat batch) from
//     a global work counter with one atomicAdd, and the warp starts 32 new
//     paths on neighbouring pixels.  What a warp gains is coherence: its
//     lanes walk the same nodes in lockstep and shade together.  So
//     regenerating a lane as soon as its own path ends measured slower
//     (PERF.md section 6: 1.52 ms against 1.36 when the warp waits for
//     all 32 of a row run): it mixes camera, shadow and bounce rays in one
//     warp and splits the soil texture's 2.8 k operations over fewer lanes
//     a pass; and 8x4 tiles beat runs of 32 by 10%.
//     The per-pixel arithmetic is unchanged (RNG keyed by pixel id and
//     segment, is_last by segment), so each pixel's result does not depend
//     on the lane that runs it.  The launch zeroes the counter on the
//     stream: one launch a frame, no host sync.
//   * Registers for occupancy.  __launch_bounds__(128, 8) caps a lane at
//     64 registers (32 warps an SM, ~200 B spilled; 16 warps at the 127
//     that ptxas chose unbounded).  To fit, the path's G-buffer and escape
//     planes, written once and read when the path ends, live in shared
//     memory ([plane][lane], 7.5 KB a block), and the sun's constants in
//     __constant__ memory (copied on the stream before the launch;
//     instructions read them as constant-bank operands).  PERF.md section 6
//     lists the registers, spills and times at 4, 5, 6 and 8 blocks.
//   * The traversal is K1's device function (traverse.cuh, any-hit for
//     shadow rays); it raises a per-lane deepest-stack count, reduced to
//     one atomicMax a warp at the end.  The kernel is instantiated for
//     each tree layout of traverse.cuh::tree_kind: the BVH4 at each
//     traversal stack depth (STACK_SMALL, STACK_DEEP), the binary
//     two-level LBVH (traverse2, STACK_DEEP) and the flat binary SAH tree
//     with 8-slot leaf rows (traverse2<.., LEAF_WIDTH>, both depths), each
//     its own instantiation, so the BVH4's code is untouched by the
//     others; the C entry launches the one the tables' layout needs.
//   * Fourier-fitted textures (render/ftex.py; the TPU kernel's ftex
//     branch) are a template flag of their own (kFtex): an instantiation
//     with it shades every textured hit from the fit (kshade.cuh::
//     ftex_shading, ~3.6 k operations a hit: 2 textures x 24 atoms x 3
//     planes of a sincosf and 8 FMAs, an expf an atom), whatever
//     use_proctex says, as the TPU kernel does; the ones without it
//     compile as before.  The fit's table, 2 x (8 + 24 x 12) floats made
//     on the device once per fit (render/ftex.py::upload_ftex), goes to
//     __constant__ memory (kshade.cuh::c_ftex) by a device-to-device copy
//     of 2.4 KB on the stream before each such launch, as the sun's
//     constants do: any fit of any caller is the one its launch reads,
//     and nothing caches which fit the symbol holds.  Like c_sun it
//     is one copy a process: launches on two streams at once would race
//     (ROADMAP.md, multi-device).
//   * Traversal-step telemetry (the TPU kernel's debug_steps planes, which
//     profile_frame's --trace-steps reads) is a template flag of its own
//     (kSteps): an instantiation with it counts each segment's node + leaf
//     visits with K1's counting traversal (traverse.cuh kCount, uncapped;
//     pops pruned by their entry distance do not count) and writes an
//     int32 (segments + 1, n) plane: row 0 the path's total, row 1 + s
//     segment s's visits, 0 for the segments after the path ended.  One
//     running total a lane; a segment's count is stored when it ends.  The
//     count is per path (one thread a path); the TPU kernel's is uniform
//     over a 32x128 ray tile, whose lanes share one stack.  The
//     instantiations without it compile as before (no pointer test in the
//     loop); the G-buffer planes are the same either way.
// The TPU kernel's VMEM table staging, state parking, 32-row strips,
// per-tile segment skips and i1/i32 mask round trips are TPU artifacts and
// are not carried over.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "kshade.cuh"
#include "traverse.cuh"

namespace {

using rtrt::V3;
using rtrt::v3;

constexpr int BLOCK = 128;
constexpr int MIN_BLOCKS = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

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
  float cos_max, sin2_max, disk_omega, disk_pdf;
  const uint32_t* frame;  // the frame index, read on the device
  const float* org;
  const float* dir;
  const float* cone;
  const int* pix;
  const float* bn;
  int use_bn, use_proctex, n;
  float* out;
  int* overflow;
  int* depth;
  int* work;
  int width;           // the pixel grid's row length
  int tile_w, tiles;   // warp tiles of tile_w x 32 / tile_w pixels
  int tlas_internal;   // TLAS rows of binary two-level tables
  int* steps;          // (segments + 1, n) int32 step planes (kSteps)
  int segments;        // scene intersects a path, 1 to SAMPLER_SEGS (the
                       // sampler table's segment slots)
};

// the sun's direction, basis, transmittance and intensity (pack_sun_params'
// first 13 floats), copied on the stream before each launch: instructions
// read them as constant-bank operands, so they hold no registers
__constant__ float c_sun[13];

// The registers of a lane are what limits the warps an SM holds.  The
// path's G-buffer and escape planes (output planes 3-17: albedo 3, normal
// 3, depth, mat id, esc_dir 3, esc_beta 3, esc_pdf with -1 for a delta
// lobe) are written once (primary hit, escape) and read when the path
// ends, so they live in shared memory, [plane][lane] (conflict-free).
constexpr int COLD = 15;
struct Cold {
  float* p;  // the lane's slot of plane 0
  __device__ __forceinline__ void set(int k, float v) const {
    p[k * BLOCK] = v;
  }
  __device__ __forceinline__ void set3(int k, V3 v) const {
    set(k, v.x);
    set(k + 1, v.y);
    set(k + 2, v.z);
  }
  __device__ __forceinline__ float get(int k) const { return p[k * BLOCK]; }
};
constexpr int C_ALBEDO = 0, C_NORMAL = 3, C_DEPTH = 6, C_MAT = 7,
              C_ESC_DIR = 8, C_ESC_BETA = 11, C_ESC_PDF = 14;

// the registers' part of a path
struct PathState {
  V3 org, dir, beta, radiance, pending;
  float shadow_tmax, prev_pdf, cone;
  bool done, is_shadow, prev_delta, inside, got_primary;
};

__device__ __forceinline__ rtrt::SunC sun_consts(const MegaParams& p) {
  rtrt::SunC sun;
  sun.dir = v3(c_sun[0], c_sun[1], c_sun[2]);
  sun.t = v3(c_sun[3], c_sun[4], c_sun[5]);
  sun.b = v3(c_sun[6], c_sun[7], c_sun[8]);
  sun.trans = v3(c_sun[9], c_sun[10], c_sun[11]);
  sun.intensity = c_sun[12];
  sun.cos_max = p.cos_max;
  sun.sin2_max = p.sin2_max;
  sun.disk_omega = p.disk_omega;
  sun.disk_pdf = p.disk_pdf;
  return sun;
}

// one bounce of shading (render/megakernel.py::shade_segment, per lane);
// kFtex: textured materials take the Fourier fit (c_ftex) in place of the
// procedural soil
template <bool kFtex>
__device__ void shade_segment(PathState& st, const Cold& cold,
                              const rtrt::TraceHit& hit, int hmat, V3 hns,
                              V3 hng, const MegaParams& p,
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
    cold.set3(C_ESC_DIR, st.dir);
    cold.set3(C_ESC_BETA, st.beta);
    cold.set(C_ESC_PDF, st.prev_delta ? -1.0f : st.prev_pdf);
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
  if ((kFtex || p.use_proctex) && m.textured) {
    V3 tex_alb, ns_tex;
    float tex_rough;
    if constexpr (kFtex)
      rtrt::ftex_shading(pos, ns, cone_w, tex_alb, tex_rough, ns_tex);
    else
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
    cold.set3(C_NORMAL, ns);
    cold.set(C_DEPTH, ht);
    cold.set(C_MAT, (float)hmat);
    cold.set3(C_ALBEDO, v3(fmaxf(albedo.x, 1e-3f), fmaxf(albedo.y, 1e-3f),
                           fmaxf(albedo.z, 1e-3f)));
  }
  st.got_primary = true;

  float u1b, u2b, ul1, ul2, u_sel, unused;
  rng.get(0, seg, u1b, u2b);
  rng.get(1, seg, ul1, ul2);
  rng.get(2, seg, u_sel, unused);

  rtrt::BsdfSample bs = rtrt::sample_bsdf(m.mtype, albedo, rough, m.ior, m.f0,
                                          ns, wo, st.inside, u1b, u2b);
  const bool rough_lane = !bs.is_delta;

  // light sample + MIS: sun NEE, 50/50 with sphere-light NEE
  V3 ls_wi, ls_rad;
  float ls_pdf;
  rtrt::sample_sun(sun_consts(p), ul1, ul2, ls_wi, ls_rad, ls_pdf);
  float ls_dist = CUDART_INF_F;
  if (p.n_lights > 0) {
    const int nl = p.n_lights;
    float p1, p2;
    rng.get(3, seg, p1, p2);
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

// a new path: the pixel's primary ray and the path state's initial values
__device__ __forceinline__ void start_path(PathState& st, const Cold& cold,
                                           rtrt::Sampler& rng,
                                           const MegaParams& p, int i) {
  rng.pix = (uint32_t)p.pix[i];
  rng.bnx = rng.use_bn ? p.bn[2 * i] : 0.0f;
  rng.bny = rng.use_bn ? p.bn[2 * i + 1] : 0.0f;
  st.org = v3(p.org[3 * i], p.org[3 * i + 1], p.org[3 * i + 2]);
  st.dir = v3(p.dir[3 * i], p.dir[3 * i + 1], p.dir[3 * i + 2]);
  st.beta = v3(1.0f, 1.0f, 1.0f);
  st.radiance = v3(0.0f, 0.0f, 0.0f);
  st.pending = v3(0.0f, 0.0f, 0.0f);
  st.shadow_tmax = CUDART_INF_F;
  st.prev_pdf = 0.0f;
  st.cone = p.cone[i];
  st.done = st.is_shadow = st.inside = st.got_primary = false;
  st.prev_delta = true;
  cold.set3(C_ALBEDO, v3(1.0f, 1.0f, 1.0f));
  cold.set3(C_NORMAL, v3(0.0f, 0.0f, 0.0f));
  cold.set(C_DEPTH, CUDART_INF_F);
  cold.set(C_MAT, -1.0f);
  cold.set3(C_ESC_DIR, st.dir);
  cold.set3(C_ESC_BETA, v3(0.0f, 0.0f, 0.0f));
  cold.set(C_ESC_PDF, -1.0f);
}

// the 18 planes of an ended path: radiance, then the cold planes
__device__ __forceinline__ void write_planes(const PathState& st,
                                             const Cold& cold,
                                             const MegaParams& p, int i) {
  const size_t n = (size_t)p.n;
  p.out[i] = st.radiance.x;
  p.out[n + i] = st.radiance.y;
  p.out[2 * n + i] = st.radiance.z;
#pragma unroll
  for (int k = 0; k < COLD; ++k) p.out[(3 + k) * n + i] = cold.get(k);
}

// one segment's scene intersect of a live path on the tables' tree; with
// kSteps the traversal counts its node + leaf visits into `visits`
template <int STACK, int TREE, bool kSteps>
__device__ __forceinline__ rtrt::TraceHit trace_segment(
    const MegaParams& p, const PathState& st, int& deepest, int& visits) {
  const float t_cap = st.is_shadow ? st.shadow_tmax : CUDART_INF_F;
  const float3 o = make_float3(st.org.x, st.org.y, st.org.z);
  const float3 d = make_float3(st.dir.x, st.dir.y, st.dir.z);
  const int cap = kSteps ? INT_MAX : 0;
  int* const out = kSteps ? &visits : nullptr;
  if constexpr (TREE == rtrt::TREE_LBVH)
    return rtrt::traverse2<STACK, kSteps>(p.nodes, p.tris, p.tlas_internal,
                                          o, d, t_cap, st.is_shadow,
                                          p.overflow, deepest, cap, out);
  else if constexpr (TREE == rtrt::TREE_SAH2)
    return rtrt::traverse2<STACK, kSteps, rtrt::LEAF_WIDTH>(
        p.nodes, p.tris, 0, o, d, t_cap, st.is_shadow, p.overflow, deepest,
        cap, out);
  else
    return rtrt::traverse<STACK, kSteps>(p.nodes, p.tris, o, d, t_cap,
                                         st.is_shadow, p.overflow, deepest,
                                         cap, out);
}

// STACK: the traversal stack's depth; TREE: the tables' tree (traverse.cuh
// Tree): the BVH4 (traverse), the two-level LBVH (traverse2) or the flat
// binary SAH tree (traverse2 with 8-slot leaf rows); kFtex: textured
// materials from the Fourier fit; kSteps: the step planes (p.steps)
template <int STACK, int TREE, bool kFtex, bool kSteps>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    megakernel(const MegaParams p) {
  __shared__ float4 table[rtrt::SAMPLER_SLOTS];
  __shared__ float cold_planes[COLD][BLOCK];
  const Cold cold{&cold_planes[0][threadIdx.x]};
  const uint32_t frame = *p.frame;
  if (p.use_bn && threadIdx.x < rtrt::SAMPLER_SLOTS)
    table[threadIdx.x] = rtrt::sampler_entry(
        frame, rtrt::sampler_dim(threadIdx.x / rtrt::SAMPLER_SEGS,
                                   threadIdx.x % rtrt::SAMPLER_SEGS));
  __syncthreads();

  rtrt::Sampler rng;
  rng.frame = frame;
  rng.use_bn = p.use_bn != 0;
  rng.table = table;

  // Persistent lanes: when every lane of the warp has ended its path, lane
  // 0 takes the next tile of 32 pixels (tile_w x 32 / tile_w) from the work
  // counter (one atomicAdd a warp) and lane i starts the tile's pixel i, so
  // the warp's paths start together on neighbouring pixels.
  const int lane = threadIdx.x & 31;
  const int tile_h = 32 / p.tile_w;
  const int tiles_x = (p.width + p.tile_w - 1) / p.tile_w;
  int pix = -1, seg = 0, deepest = 0;
  int total = 0;  // kSteps: the path's visits so far
  PathState st;
  while (true) {
    __syncwarp();
    if (__all_sync(FULL, pix < 0)) {
      int t = 0;
      if (lane == 0) t = atomicAdd(p.work, 1);
      t = __shfl_sync(FULL, t, 0);
      if (t >= p.tiles) break;
      const int x = (t % tiles_x) * p.tile_w + lane % p.tile_w;
      const int i = ((t / tiles_x) * tile_h + lane / p.tile_w) * p.width + x;
      if (x < p.width && i < p.n) {
        pix = i;
        seg = 0;
        start_path(st, cold, rng, p, pix);
        if constexpr (kSteps) total = 0;
      }
    }
    if (pix >= 0) {
      int visits = 0;
      const rtrt::TraceHit h =
          trace_segment<STACK, TREE, kSteps>(p, st, deepest, visits);
      if constexpr (kSteps) {
        p.steps[(size_t)(seg + 1) * p.n + pix] = visits;
        total += visits;
      }
      int hmat;
      float3 ns, ng;
      rtrt::hit_attrs(p.nrm, p.ng, p.mat, h, hmat, ns, ng);
      shade_segment<kFtex>(st, cold, h, hmat, v3(ns.x, ns.y, ns.z),
                           v3(ng.x, ng.y, ng.z), p, rng, seg,
                           seg == p.segments - 1);
      if (st.done || ++seg == p.segments) {
        write_planes(st, cold, p, pix);
        if constexpr (kSteps) {  // the total; 0 for the segments not run
          p.steps[pix] = total;
          for (int r = seg + 2; r <= p.segments; ++r)
            p.steps[(size_t)r * p.n + pix] = 0;
        }
        pix = -1;
      }
    }
  }
  if (p.depth != nullptr) {  // one atomicMax a warp
    const int m = __reduce_max_sync(FULL, deepest);
    if (lane == 0 && m > 0) atomicMax(p.depth, m);
  }
}

// one wave of persistent blocks: resident blocks a SM (from the kernel's
// registers and shared memory, queried once per instantiation: each
// <STACK, TREE, kFtex, kSteps> has its own per_sm) times the SMs, fewer for
// a small n
template <int STACK, int TREE, bool kFtex, bool kSteps>
int launch(const MegaParams& p, cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, megakernel<STACK, TREE, kFtex, kSteps>, BLOCK, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int warps = BLOCK / 32;
  const int grid = min(per_sm * sms, (p.tiles + warps - 1) / warps);
  megakernel<STACK, TREE, kFtex, kSteps><<<grid, BLOCK, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of the tables' tree (tree_kind) and stack
template <bool kFtex, bool kSteps>
int launch_tree(const MegaParams& p, int tree, int stack, cudaStream_t s) {
  using rtrt::STACK_DEEP;
  using rtrt::STACK_SMALL;
  const bool small = stack == STACK_SMALL;
  if (tree == rtrt::TREE_LBVH)
    return launch<STACK_DEEP, rtrt::TREE_LBVH, kFtex, kSteps>(p, s);
  if (tree == rtrt::TREE_SAH2)
    return small
               ? launch<STACK_SMALL, rtrt::TREE_SAH2, kFtex, kSteps>(p, s)
               : launch<STACK_DEEP, rtrt::TREE_SAH2, kFtex, kSteps>(p, s);
  return small ? launch<STACK_SMALL, rtrt::TREE_BVH4, kFtex, kSteps>(p, s)
               : launch<STACK_DEEP, rtrt::TREE_BVH4, kFtex, kSteps>(p, s);
}

}  // namespace

// frame: the (1,) frame index (uint32) on the device, so that a replayed
// CUDA graph reads each frame's; work: (1,) int32 scratch (zeroed here, on
// the stream); depth: (1,) int32
// counter of the deepest traversal stack, or nullptr; width: the pixels'
// row length (n for a flat batch); ftex: the Fourier fit's (2, FTEX_ROW)
// coefficient table on the device (render/ftex.py::pack_ftex), copied to
// c_ftex on the stream, or nullptr for the instantiations without it;
// steps: the (segments + 1, n) int32 step planes, written by the kSteps
// instantiations (no Fourier fit: steps with ftex is refused), or nullptr;
// segments: the scene intersects a path, 1 to SAMPLER_SEGS (else refused);
// arity, leaf_width, tlas_internal, stack: the tables' layout
// (bvh/packet.py::layout_args; traverse.cuh tree_kind): any triple without
// an instantiation is refused (cudaErrorInvalidValue) before anything is
// enqueued
extern "C" int rtrt_megakernel(
    const float* nodes, const float* tris, const float* nrm, const float* ng,
    const int* mat, const float* mat_rows, int n_mat, const float* light_rows,
    int n_lights, const float* sun_vec, float cos_max, float sin2_max,
    float disk_omega, float disk_pdf, const unsigned* frame, const float* org,
    const float* dir, const float* cone, const int* pix, const float* bn,
    int use_bn, int use_proctex, int n, float* out, int* overflow,
    int* depth, int* work, int width, const float* ftex, int* steps,
    int segments, int arity, int leaf_width, int tlas_internal, int stack,
    void* stream) {
  MegaParams p{nodes,    tris,     nrm,        ng,       mat,
               mat_rows, n_mat,    light_rows, n_lights,
               cos_max,  sin2_max, disk_omega, disk_pdf, frame,
               org,      dir,      cone,       pix,      bn,
               use_bn,   use_proctex, n,       out,      overflow,
               depth,    work,     width};
  const int tree = rtrt::tree_kind(arity, leaf_width, stack);
  if (tree < 0 || (steps != nullptr && ftex != nullptr) || segments < 1 ||
      segments > rtrt::SAMPLER_SEGS)
    return static_cast<int>(cudaErrorInvalidValue);
  p.tlas_internal = tlas_internal;
  p.steps = steps;
  p.segments = segments;
  if (n <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  // 8x4 tiles where the grid has 4 rows or more, else runs of 32 pixels
  const int rows = (n + width - 1) / width;
  p.tile_w = rows >= 4 ? 8 : 32;
  const int tile_h = 32 / p.tile_w;
  p.tiles = ((width + p.tile_w - 1) / p.tile_w) *
            ((rows + tile_h - 1) / tile_h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(work, 0, sizeof(int), s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_sun, sun_vec, sizeof(c_sun), 0,
                                cudaMemcpyDeviceToDevice, s);
  if (e == cudaSuccess && ftex != nullptr)
    e = cudaMemcpyToSymbolAsync(rtrt::c_ftex, ftex, sizeof(rtrt::c_ftex), 0,
                                cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (steps != nullptr) return launch_tree<false, true>(p, tree, stack, s);
  return ftex != nullptr ? launch_tree<true, false>(p, tree, stack, s)
                         : launch_tree<false, false>(p, tree, stack, s);
}
