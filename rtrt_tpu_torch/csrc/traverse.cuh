// K1 traversal: per-thread stack traversal of the 4-wide SAH BVH.
//
// Replaces: rtrt_tpu/bvh/packet.py::traverse_tile (launched alone by
// packet.py::_kernel / packet_intersect, and inside the megakernel
// render/megakernel.py::_mega_kernel).
//
// What bounds it on the H100: latency of dependent global loads (a 128-byte
// node record, then 8 x 36-byte triangle records per leaf visit) and the
// divergence of per-ray control flow; arithmetic is small (4 slab tests or
// 8 Moller-Trumbore tests per step).  The whole table set of the 1080p
// terrain scene is a few MB, so it stays resident in the 50 MB L2.
//
// Simple design: one thread per ray and a private STACK-deep stack of
// (entry, entry distance) in local memory — the TPU tile's shared scalar
// stack, step unions, VMEM staging and distinct-winner resolve loop are TPU
// artifacts and are not carried over.  Node records load as 8 float4 reads
// through the read-only cache; triangle rows as scalar reads.  Per-ray
// semantics mirror one lane of traverse_tile (see bvh/packet.py): root-exit
// cap on best_t, near-first child order by the same 5-comparator network,
// pops pruned by their stored entry distance, strict '<' within a leaf row
// (padding slots duplicate real triangles).  A push that overflows the
// stack is dropped and counted in a device counter (atomicAdd), never
// silently.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rtrt {

constexpr int STACK = 64;
constexpr int LEAF_WIDTH = 8;
constexpr int LEAF_BIT = 1 << 23;
constexpr float RAY_TMIN = 1e-4f;
constexpr float FAR_SCALE = 1.00000036f;  // float32(1 + 3.6e-7)
constexpr float TINY = 1e-20f;

struct TraceHit {
  float t;   // +inf on miss
  int tri;   // sorted slot, -1 on miss
  float u, v;
};

__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < TINY ? (d >= 0.0f ? TINY : -TINY) : d;
  return 1.0f / s;
}

// slab test of the ray against box (lo, hi); entry distance in tn
__device__ __forceinline__ bool slab(float lo0, float lo1, float lo2,
                                     float hi0, float hi1, float hi2,
                                     float3 o, float3 inv, float best,
                                     float& tn) {
  float n0 = ((inv.x < 0.0f ? hi0 : lo0) - o.x) * inv.x;
  float n1 = ((inv.y < 0.0f ? hi1 : lo1) - o.y) * inv.y;
  float n2 = ((inv.z < 0.0f ? hi2 : lo2) - o.z) * inv.z;
  float f0 = ((inv.x < 0.0f ? lo0 : hi0) - o.x) * inv.x;
  float f1 = ((inv.y < 0.0f ? lo1 : hi1) - o.y) * inv.y;
  float f2 = ((inv.z < 0.0f ? lo2 : hi2) - o.z) * inv.z;
  tn = fmaxf(fmaxf(n0, n1), n2);
  float tf = fminf(fminf(f0, f1), f2) * FAR_SCALE;
  return (tn <= tf) && (tf > RAY_TMIN) && (tn < best);
}

// Moller-Trumbore over a [v0 | e1 | e2] record (division-free accept)
__device__ __forceinline__ bool tri_test(const float* __restrict__ r,
                                         float3 o, float3 d, float best,
                                         float& t, float& u, float& v) {
  float v0x = __ldg(r + 0), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
  float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
  float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
  float px = o.x - v0x, py = o.y - v0y, pz = o.z - v0z;
  float hx = d.y * e2z - d.z * e2y;
  float hy = d.z * e2x - d.x * e2z;
  float hz = d.x * e2y - d.y * e2x;
  float det = e1x * hx + e1y * hy + e1z * hz;
  float uq = px * hx + py * hy + pz * hz;
  float qx = py * e1z - pz * e1y;
  float qy = pz * e1x - px * e1z;
  float qz = px * e1y - py * e1x;
  float vq = d.x * qx + d.y * qy + d.z * qz;
  float tq = e2x * qx + e2y * qy + e2z * qz;
  float adet = fabsf(det);
  float sg = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  float u_s = uq * sg, v_s = vq * sg, t_s = tq * sg;
  bool ok = (det != 0.0f) && (u_s >= 0.0f) && (v_s >= 0.0f) &&
            (u_s + v_s <= adet) && (t_s > RAY_TMIN * adet) &&
            (t_s < best * adet);
  float inv = det != 0.0f ? 1.0f / det : 0.0f;
  t = tq * inv;
  u = uq * inv;
  v = vq * inv;
  return ok;
}

struct Cand {
  float t;
  int e;
};

__device__ __forceinline__ void cswap(Cand& a, Cand& b) {
  if (a.t > b.t) {
    Cand c = a;
    a = b;
    b = c;
  }
}

// Closest hit under t_cap (t_cap <= 0: no hit), or with first_hit the first
// accepted leaf hit.  overflow: device counter of dropped pushes.
// kCount (the standalone launcher's variant that
// rtrt_tpu_torch/tools/probe_traverse.py times): the ray stops after
// max_steps node or leaf visits (pops pruned by their entry distance do not
// count) and writes its visits to *steps.  K2 uses the default kCount =
// false, which compiles to the loop without counter.
template <bool kCount = false>
static __device__ TraceHit traverse(const float* __restrict__ nodes,
                             const float* __restrict__ tris, float3 o,
                             float3 d, float t_cap, bool first_hit,
                             int* overflow, int max_steps = 0,
                             int* steps = nullptr) {
  TraceHit hit{CUDART_INF_F, -1, 0.0f, 0.0f};
  int visits = 0;
  if (kCount) *steps = 0;
  if (!(t_cap > 0.0f)) return hit;
  float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));

  // per-ray scene-exit cap: a hit lies inside the root box
  float r[32];
  {
    const float4* rec = reinterpret_cast<const float4*>(nodes);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float4 q = __ldg(rec + k);
      r[4 * k] = q.x; r[4 * k + 1] = q.y; r[4 * k + 2] = q.z;
      r[4 * k + 3] = q.w;
    }
  }
  float rlo[3], rhi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rlo[k] = fminf(fminf(fminf(r[k], r[6 + k]), r[12 + k]), r[18 + k]);
    rhi[k] = fmaxf(fmaxf(fmaxf(r[3 + k], r[9 + k]), r[15 + k]), r[21 + k]);
  }
  float r_tn;
  float n0 = ((inv.x < 0.0f ? rhi[0] : rlo[0]) - o.x) * inv.x;
  float n1 = ((inv.y < 0.0f ? rhi[1] : rlo[1]) - o.y) * inv.y;
  float n2 = ((inv.z < 0.0f ? rhi[2] : rlo[2]) - o.z) * inv.z;
  float f0 = ((inv.x < 0.0f ? rlo[0] : rhi[0]) - o.x) * inv.x;
  float f1 = ((inv.y < 0.0f ? rlo[1] : rhi[1]) - o.y) * inv.y;
  float f2 = ((inv.z < 0.0f ? rlo[2] : rhi[2]) - o.z) * inv.z;
  r_tn = fmaxf(fmaxf(n0, n1), n2);
  float r_tf = fminf(fminf(f0, f1), f2) * FAR_SCALE;
  bool hit_root = (r_tn <= r_tf) && (r_tf > RAY_TMIN);
  float exit_cap = hit_root ? r_tf * 1.001f + 1e-2f : 0.0f;
  float best = fminf(t_cap, exit_cap);

  int st_e[STACK];
  float st_t[STACK];
  int sp = 0;
  int cur = 0;
  float curt = -CUDART_INF_F;
  while (true) {
    if (kCount && visits >= max_steps) break;
    if (cur < 0) {
      if (sp == 0) break;
      --sp;
      cur = st_e[sp];
      curt = st_t[sp];
    }
    const int e = cur;
    cur = -1;
    if (!(curt < best)) continue;  // pruned: entry beyond the best hit
    if (kCount) ++visits;
    if (e & LEAF_BIT) {
      const int base = ((e >> 11) & 0x7FF) * 1024 + (e & 0x7FF);
      float gt = CUDART_INF_F, gu = 0.0f, gv = 0.0f;
      int gtri = 0;
#pragma unroll 2
      for (int k = 0; k < LEAF_WIDTH; ++k) {
        float tt, tu, tv;
        bool ok = tri_test(tris + (size_t)(base + k) * 9, o, d, best, tt,
                           tu, tv);
        if (ok && tt < gt) {
          gt = tt; gu = tu; gv = tv; gtri = base + k;
        }
      }
      if (gt < best) {
        best = gt;
        hit.tri = gtri;
        hit.u = gu;
        hit.v = gv;
        if (first_hit) break;
      }
    } else {
      const float4* rec = reinterpret_cast<const float4*>(
          nodes + (size_t)(e & 0x3FFFFF) * 32);
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        float4 q = __ldg(rec + k);
        r[4 * k] = q.x; r[4 * k + 1] = q.y; r[4 * k + 2] = q.z;
        r[4 * k + 3] = q.w;
      }
      Cand c[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float tn;
        bool h = slab(r[6 * k], r[6 * k + 1], r[6 * k + 2], r[6 * k + 3],
                      r[6 * k + 4], r[6 * k + 5], o, inv, best, tn);
        c[k].t = h ? tn : CUDART_INF_F;
        c[k].e = (int)r[24 + k];
      }
      cswap(c[0], c[1]);
      cswap(c[2], c[3]);
      cswap(c[0], c[2]);
      cswap(c[1], c[3]);
      cswap(c[1], c[2]);
#pragma unroll
      for (int k = 3; k >= 1; --k) {
        if (c[k].t < CUDART_INF_F) {
          if (sp < STACK) {
            st_e[sp] = c[k].e;
            st_t[sp] = c[k].t;
            ++sp;
          } else {
            atomicAdd(overflow, 1);
          }
        }
      }
      if (c[0].t < CUDART_INF_F) {
        cur = c[0].e;
        curt = c[0].t;
      }
    }
  }
  if (hit.tri >= 0) hit.t = best;
  if (kCount) *steps = visits;
  return hit;
}

// interpolated shading normal, geometric normal and material of a hit
__device__ __forceinline__ void hit_attrs(const float* __restrict__ nrm,
                                          const float* __restrict__ ng,
                                          const int* __restrict__ mat,
                                          const TraceHit& h, int& m,
                                          float3& ns, float3& g) {
  if (h.tri < 0) {
    m = 0;
    ns = make_float3(0.0f, 0.0f, 0.0f);
    g = ns;
    return;
  }
  const float* n = nrm + (size_t)h.tri * 9;
  float w = 1.0f - h.u - h.v;
  ns.x = w * __ldg(n + 0) + h.u * __ldg(n + 3) + h.v * __ldg(n + 6);
  ns.y = w * __ldg(n + 1) + h.u * __ldg(n + 4) + h.v * __ldg(n + 7);
  ns.z = w * __ldg(n + 2) + h.u * __ldg(n + 5) + h.v * __ldg(n + 8);
  const float* gg = ng + (size_t)h.tri * 3;
  g = make_float3(__ldg(gg + 0), __ldg(gg + 1), __ldg(gg + 2));
  m = __ldg(mat + h.tri);
}

}  // namespace rtrt
