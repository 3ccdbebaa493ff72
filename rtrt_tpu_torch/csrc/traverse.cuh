// K1 traversal: per-thread stack traversal of the 4-wide SAH BVH
// (traverse) and of the binary two-level LBVH (traverse2, below).
//
// Replaces: rtrt_tpu/bvh/packet.py::traverse_tile (launched alone by
// packet.py::_kernel / packet_intersect, and inside the megakernel
// render/megakernel.py::_mega_kernel).
//
// What bounds it on the H100: latency of dependent global loads (a 112-byte
// node record, then 8 x 36-byte triangle records per leaf visit) and the
// divergence of per-ray control flow; arithmetic is small (4 slab tests or
// 8 Moller-Trumbore tests per step).  The whole table set of the 1080p
// terrain scene is a few MB, so it stays resident in the 50 MB L2.  How
// many warps an SM holds to hide that latency is set by the registers of
// the caller (K2 holds a path state around it).
//
// Design: one thread per ray and a private STACK-deep stack of (entry,
// entry distance) — the TPU tile's shared scalar stack, step unions, VMEM
// staging and distinct-winner resolve loop are TPU artifacts and are not
// carried over.  Node records load as 7 float4 reads through the read-only
// cache (staging records in shared memory measured slower, PERF.md K12),
// and each child's box is slab-tested from its two float4 as they arrive:
// no copy of the 28-float record is held, which keeps registers for the
// caller.  A stack entry is one int2 (entry, distance bits): one 8-byte
// local access a push or pop.  Triangle records (36 B) of a leaf load
// as float2 pairs.  Per-ray semantics mirror one lane of traverse_tile (see
// bvh/packet.py): root-exit cap on best_t, near-first child order by the
// same 5-comparator network, pops pruned by their stored entry distance,
// strict '<' within a leaf row (padding slots duplicate real triangles).
// A push that overflows the stack is dropped and counted in a device
// counter (atomicAdd), never silently; the caller also gets the deepest
// stack a ray reached.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rtrt {

// The stack depth is a template parameter, one instantiation for each
// entry of bvh/packet.py STACK_DEPTHS.  A BVH4 of L internal levels needs at
// most 3 L entries (3 pushes kept a level of the current descent), and the
// callers (traverse.cu, megakernel.cu) launch the smallest instantiation
// that holds the tree's 3 L (TraceTables.stack, from the tables' own
// levels).  STACK_SMALL holds L <= 10: the 1080p terrain (8 levels, 24
// entries; its deepest stack on the frames is 11).  STACK_DEEP holds every
// tree bvh/sah.py builds (L <= 82, see STACK_DEPTHS).  The entries live in
// local memory either way, so the small instantiation's gain is the
// smaller local-memory reservation, not the loop; a push beyond the stack
// is still counted, never silent.
constexpr int STACK_SMALL = 32;
constexpr int STACK_DEEP = 256;
constexpr int LEAF_WIDTH = 8;
constexpr int LEAF_BIT = 1 << 23;
constexpr float RAY_TMIN = 1e-4f;
constexpr float FAR_SCALE = 1.00000036f;  // float32(1 + 3.6e-7)
constexpr float TINY = 1e-20f;

// The tree layouts that K1 and K2 are instantiated for, by the tables'
// (arity, leaf width, stack) (bvh/packet.py::layout_args): the BVH4 (4,
// LEAF_WIDTH, STACK_SMALL or STACK_DEEP), the two-level LBVH (2, 1,
// STACK_DEEP) and the flat binary SAH tree (2, LEAF_WIDTH, STACK_SMALL or
// STACK_DEEP).  tree_kind gives -1 for any other triple, which the C
// entries refuse (cudaErrorInvalidValue) before anything is enqueued.
enum Tree { TREE_BVH4 = 0, TREE_LBVH = 1, TREE_SAH2 = 2 };
inline int tree_kind(int arity, int leaf, int stack) {
  const bool any = stack == STACK_SMALL || stack == STACK_DEEP;
  if (arity == 4 && leaf == LEAF_WIDTH && any) return TREE_BVH4;
  if (arity == 2 && leaf == 1 && stack == STACK_DEEP) return TREE_LBVH;
  if (arity == 2 && leaf == LEAF_WIDTH && any) return TREE_SAH2;
  return -1;
}

struct TraceHit {
  float t;   // +inf on miss
  int tri;   // sorted slot, -1 on miss
  float u, v;
};

__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < TINY ? (d >= 0.0f ? TINY : -TINY) : d;
  return 1.0f / s;
}

// slab test of the ray against box (lo, hi): the entry distance, or +inf
// where the ray misses the box or enters it beyond best
__device__ __forceinline__ float child_t(float lo0, float lo1, float lo2,
                                         float hi0, float hi1, float hi2,
                                         float3 o, float3 inv, float best) {
  float n0 = ((inv.x < 0.0f ? hi0 : lo0) - o.x) * inv.x;
  float n1 = ((inv.y < 0.0f ? hi1 : lo1) - o.y) * inv.y;
  float n2 = ((inv.z < 0.0f ? hi2 : lo2) - o.z) * inv.z;
  float f0 = ((inv.x < 0.0f ? lo0 : hi0) - o.x) * inv.x;
  float f1 = ((inv.y < 0.0f ? lo1 : hi1) - o.y) * inv.y;
  float f2 = ((inv.z < 0.0f ? lo2 : hi2) - o.z) * inv.z;
  float tn = fmaxf(fmaxf(n0, n1), n2);
  float tf = fminf(fminf(f0, f1), f2) * FAR_SCALE;
  return (tn <= tf) && (tf > RAY_TMIN) && (tn < best) ? tn : CUDART_INF_F;
}

// Moller-Trumbore over a [v0 | e1 | e2] record (division-free accept)
__device__ __forceinline__ bool tri_test(float v0x, float v0y, float v0z,
                                         float e1x, float e1y, float e1z,
                                         float e2x, float e2y, float e2z,
                                         float3 o, float3 d, float best,
                                         float& t, float& u, float& v) {
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

// A leaf row of LEAF_WIDTH triangle slots from slot `base` for the flat
// binary tree (traverse2): the loop of traverse()'s BVH4 leaf visit, which
// keeps its own inline copy so that the BVH4 instantiations compile as
// they did.  The nearest accepted hit under best (gt = +inf where none),
// the lowest slot on a tie (strict '<': short leaves repeat their first
// triangle in the padding slots).  `base` is a multiple of LEAF_WIDTH
// (bvh/sah.py pads leaves to row-aligned 8-slot rows), so a pair of
// 36-byte records starts 8-byte aligned: 9 float2 loads a pair instead of
// 18 scalar ones.
__device__ __forceinline__ void leaf_row(const float* __restrict__ tris,
                                         int base, float3 o, float3 d,
                                         float best, float& gt, float& gu,
                                         float& gv, int& gtri) {
  gt = CUDART_INF_F;
  gu = gv = 0.0f;
  gtri = 0;
  const float2* row =
      reinterpret_cast<const float2*>(tris + (size_t)base * 9);
#pragma unroll 1
  for (int k = 0; k < LEAF_WIDTH; k += 2) {
    float2 q[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) q[j] = __ldg(row + (k / 2) * 9 + j);
    float tt, tu, tv;
    bool ok = tri_test(q[0].x, q[0].y, q[1].x, q[1].y, q[2].x, q[2].y,
                       q[3].x, q[3].y, q[4].x, o, d, best, tt, tu, tv);
    if (ok && tt < gt) {
      gt = tt; gu = tu; gv = tv; gtri = base + k;
    }
    ok = tri_test(q[4].y, q[5].x, q[5].y, q[6].x, q[6].y, q[7].x, q[7].y,
                  q[8].x, q[8].y, o, d, best, tt, tu, tv);
    if (ok && tt < gt) {
      gt = tt; gu = tu; gv = tv; gtri = base + k + 1;
    }
  }
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
// accepted leaf hit.  overflow: device counter of dropped pushes; deepest:
// raised to the most entries the stack held.
// kCount (the standalone launcher's variant that
// rtrt_tpu_torch/tools/probe_traverse.py times): the ray stops after
// max_steps node or leaf visits (pops pruned by their entry distance do not
// count) and writes its visits to *steps.  K2 uses the default kCount =
// false, which compiles to the loop without counter.  STACK: the stack's
// depth in entries (STACK_SMALL or STACK_DEEP).
template <int STACK, bool kCount = false>
static __device__ TraceHit traverse(const float* __restrict__ nodes,
                                    const float* __restrict__ tris, float3 o,
                                    float3 d, float t_cap, bool first_hit,
                                    int* overflow, int& deepest,
                                    int max_steps = 0, int* steps = nullptr) {
  TraceHit hit{CUDART_INF_F, -1, 0.0f, 0.0f};
  int visits = 0;
  if (kCount) *steps = 0;
  if (!(t_cap > 0.0f)) return hit;
  float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));

  // A node record is 7 float4: child k's box [lo xyz | hi xyz] is floats
  // 6k..6k+5, the four child entries floats 24..27.
  // per-ray scene-exit cap: a hit lies inside the root box (the union of
  // the root's child boxes)
  float best;
  {
    const float4* rec = reinterpret_cast<const float4*>(nodes);
    const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q2 = __ldg(rec + 2);
    const float4 q3 = __ldg(rec + 3), q4 = __ldg(rec + 4),
                 q5 = __ldg(rec + 5);
    const float lx = fminf(fminf(fminf(q0.x, q1.z), q3.x), q4.z);
    const float ly = fminf(fminf(fminf(q0.y, q1.w), q3.y), q4.w);
    const float lz = fminf(fminf(fminf(q0.z, q2.x), q3.z), q5.x);
    const float hx = fmaxf(fmaxf(fmaxf(q0.w, q2.y), q3.w), q5.y);
    const float hy = fmaxf(fmaxf(fmaxf(q1.x, q2.z), q4.x), q5.z);
    const float hz = fmaxf(fmaxf(fmaxf(q1.y, q2.w), q4.y), q5.w);
    float n0 = ((inv.x < 0.0f ? hx : lx) - o.x) * inv.x;
    float n1 = ((inv.y < 0.0f ? hy : ly) - o.y) * inv.y;
    float n2 = ((inv.z < 0.0f ? hz : lz) - o.z) * inv.z;
    float f0 = ((inv.x < 0.0f ? lx : hx) - o.x) * inv.x;
    float f1 = ((inv.y < 0.0f ? ly : hy) - o.y) * inv.y;
    float f2 = ((inv.z < 0.0f ? lz : hz) - o.z) * inv.z;
    float r_tn = fmaxf(fmaxf(n0, n1), n2);
    float r_tf = fminf(fminf(f0, f1), f2) * FAR_SCALE;
    bool hit_root = (r_tn <= r_tf) && (r_tf > RAY_TMIN);
    float exit_cap = hit_root ? r_tf * 1.001f + 1e-2f : 0.0f;
    best = fminf(t_cap, exit_cap);
  }

  int2 stack[STACK];  // (entry, entry distance's bits): one 8-byte access
  int sp = 0;
  int cur = 0;
  float curt = -CUDART_INF_F;
  while (true) {
    if (kCount && visits >= max_steps) break;
    if (cur < 0) {
      if (sp == 0) break;
      --sp;
      cur = stack[sp].x;
      curt = __int_as_float(stack[sp].y);
    }
    const int e = cur;
    cur = -1;
    if (!(curt < best)) continue;  // pruned: entry beyond the best hit
    if (kCount) ++visits;
    if (e & LEAF_BIT) {
      const int base = ((e >> 11) & 0x7FF) * 1024 + (e & 0x7FF);
      float gt = CUDART_INF_F, gu = 0.0f, gv = 0.0f;
      int gtri = 0;
      // a leaf's base is a multiple of LEAF_WIDTH (bvh/sah.py pads leaves
      // to row-aligned 8-slot rows), so a pair of 36-byte records starts
      // 8-byte aligned: 9 float2 loads a pair instead of 18 scalar ones
      const float2* row =
          reinterpret_cast<const float2*>(tris + (size_t)base * 9);
#pragma unroll 1
      for (int k = 0; k < LEAF_WIDTH; k += 2) {
        float2 q[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) q[j] = __ldg(row + (k / 2) * 9 + j);
        float tt, tu, tv;
        bool ok = tri_test(q[0].x, q[0].y, q[1].x, q[1].y, q[2].x, q[2].y,
                           q[3].x, q[3].y, q[4].x, o, d, best, tt, tu, tv);
        if (ok && tt < gt) {
          gt = tt; gu = tu; gv = tv; gtri = base + k;
        }
        ok = tri_test(q[4].y, q[5].x, q[5].y, q[6].x, q[6].y, q[7].x,
                      q[7].y, q[8].x, q[8].y, o, d, best, tt, tu, tv);
        if (ok && tt < gt) {
          gt = tt; gu = tu; gv = tv; gtri = base + k + 1;
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
      // each child's box is tested from its two float4 as they arrive; no
      // copy of the whole record is held
      const float4* rec = reinterpret_cast<const float4*>(
          nodes + (size_t)(e & 0x3FFFFF) * 32);
      Cand c[4];
      const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1);
      c[0].t = child_t(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, o, inv, best);
      const float4 q2 = __ldg(rec + 2);
      c[1].t = child_t(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, o, inv, best);
      const float4 q3 = __ldg(rec + 3), q4 = __ldg(rec + 4);
      c[2].t = child_t(q3.x, q3.y, q3.z, q3.w, q4.x, q4.y, o, inv, best);
      const float4 q5 = __ldg(rec + 5);
      c[3].t = child_t(q4.z, q4.w, q5.x, q5.y, q5.z, q5.w, o, inv, best);
      const float4 q6 = __ldg(rec + 6);
      c[0].e = (int)q6.x;
      c[1].e = (int)q6.y;
      c[2].e = (int)q6.z;
      c[3].e = (int)q6.w;
      cswap(c[0], c[1]);
      cswap(c[2], c[3]);
      cswap(c[0], c[2]);
      cswap(c[1], c[3]);
      cswap(c[1], c[2]);
#pragma unroll
      for (int k = 3; k >= 1; --k) {
        if (c[k].t < CUDART_INF_F) {
          if (sp < STACK) {
            stack[sp] = make_int2(c[k].e, __float_as_int(c[k].t));
            ++sp;
          } else {
            atomicAdd(overflow, 1);
          }
        }
      }
      deepest = max(deepest, sp);
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

// ---------------------------------------------------------------------------
// The binary trees (the JAX kernel's arity=2 branch): the two-level LBVH
// (bvh/build.py; LEAF 1) and the flat binary SAH tree (bvh/sah.py with
// leaf_max 8; LEAF LEAF_WIDTH)
//
// A record is 64 bytes, 4 float4: the left child's box [lo xyz | hi xyz],
// the right child's, then the two child entries as exact floats and two
// pad floats (bvh/packet.py::binary_nodes).  A node visit slab-tests both
// boxes, continues with the nearer child (the left on a tie) and pushes
// the other with its entry distance, so the stack holds at most one entry
// a level of the current path.  Everything else is traverse()'s: the
// root-exit cap, pruned pops, any-hit, the counters.
//   * LEAF 1, the LBVH: rows are the TLAS nodes first (a TLAS entry's row
//     is its 22-bit field), then BLAS_NODES rows per batch (a BLAS entry's
//     row is tlas_internal + batch * BLAS_NODES + idx).  A leaf is one
//     triangle, slot batch * 1024 + idx; a TLAS leaf was resolved to its
//     batch's BLAS root when the tree was built.  Its stack is the static
//     bound of bvh/packet.py::binary_stack_bound (<= 84 entries): the
//     STACK_DEEP instantiation only.
//   * LEAF LEAF_WIDTH, the flat SAH tree: one level of rows, an internal
//     entry's row is its 22-bit field (no TLAS, no BLAS bit), and a leaf
//     is a row-aligned LEAF_WIDTH-slot row tested as a BVH4 leaf is
//     (leaf_row).  Its stack holds the tree's levels, counted on the host
//     when the tables are built: STACK_SMALL or STACK_DEEP.
// ---------------------------------------------------------------------------
constexpr int BLAS_BIT = 1 << 22;
constexpr int BLAS_NODES = 1023;

template <int STACK, bool kCount = false, int LEAF = 1>
static __device__ TraceHit traverse2(const float* __restrict__ nodes,
                                     const float* __restrict__ tris,
                                     int tlas_internal, float3 o, float3 d,
                                     float t_cap, bool first_hit,
                                     int* overflow, int& deepest,
                                     int max_steps = 0,
                                     int* steps = nullptr) {
  TraceHit hit{CUDART_INF_F, -1, 0.0f, 0.0f};
  int visits = 0;
  if (kCount) *steps = 0;
  if (!(t_cap > 0.0f)) return hit;
  float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));

  // per-ray scene-exit cap: the union of the TLAS root's two child boxes
  float best;
  {
    const float4* rec = reinterpret_cast<const float4*>(nodes);
    const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q2 = __ldg(rec + 2);
    const float lx = fminf(q0.x, q1.z), ly = fminf(q0.y, q1.w),
                lz = fminf(q0.z, q2.x);
    const float hx = fmaxf(q0.w, q2.y), hy = fmaxf(q1.x, q2.z),
                hz = fmaxf(q1.y, q2.w);
    float n0 = ((inv.x < 0.0f ? hx : lx) - o.x) * inv.x;
    float n1 = ((inv.y < 0.0f ? hy : ly) - o.y) * inv.y;
    float n2 = ((inv.z < 0.0f ? hz : lz) - o.z) * inv.z;
    float f0 = ((inv.x < 0.0f ? lx : hx) - o.x) * inv.x;
    float f1 = ((inv.y < 0.0f ? ly : hy) - o.y) * inv.y;
    float f2 = ((inv.z < 0.0f ? lz : hz) - o.z) * inv.z;
    float r_tn = fmaxf(fmaxf(n0, n1), n2);
    float r_tf = fminf(fminf(f0, f1), f2) * FAR_SCALE;
    bool hit_root = (r_tn <= r_tf) && (r_tf > RAY_TMIN);
    float exit_cap = hit_root ? r_tf * 1.001f + 1e-2f : 0.0f;
    best = fminf(t_cap, exit_cap);
  }

  int2 stack[STACK];  // (entry, entry distance's bits)
  int sp = 0;
  int cur = 0;  // the TLAS root
  float curt = -CUDART_INF_F;
  while (true) {
    if (kCount && visits >= max_steps) break;
    if (cur < 0) {
      if (sp == 0) break;
      --sp;
      cur = stack[sp].x;
      curt = __int_as_float(stack[sp].y);
    }
    const int e = cur;
    cur = -1;
    if (!(curt < best)) continue;  // pruned: entry beyond the best hit
    if (kCount) ++visits;
    const int idx = e & 0x7FF, batch = (e >> 11) & 0x7FF;
    if (e & LEAF_BIT) {
      if constexpr (LEAF > 1) {
        static_assert(LEAF == LEAF_WIDTH, "leaf rows of LEAF_WIDTH slots");
        float gt, gu, gv;
        int gtri;
        leaf_row(tris, batch * 1024 + idx, o, d, best, gt, gu, gv, gtri);
        if (gt < best) {
          best = gt;
          hit.tri = gtri;
          hit.u = gu;
          hit.v = gv;
          if (first_hit) break;
        }
      } else {
        const int slot = batch * 1024 + idx;
        const float* r = tris + (size_t)slot * 9;
        float tt, tu, tv;
        const bool ok = tri_test(__ldg(r), __ldg(r + 1), __ldg(r + 2),
                                 __ldg(r + 3), __ldg(r + 4), __ldg(r + 5),
                                 __ldg(r + 6), __ldg(r + 7), __ldg(r + 8),
                                 o, d, best, tt, tu, tv);
        if (ok && tt < best) {
          best = tt;
          hit.tri = slot;
          hit.u = tu;
          hit.v = tv;
          if (first_hit) break;
        }
      }
    } else {
      int row;
      if constexpr (LEAF > 1)
        row = e & (BLAS_BIT - 1);
      else
        row = (e & BLAS_BIT) ? tlas_internal + batch * BLAS_NODES + idx
                             : (e & (BLAS_BIT - 1));
      const float4* rec =
          reinterpret_cast<const float4*>(nodes + (size_t)row * 16);
      const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1);
      const float tl =
          child_t(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, o, inv, best);
      const float4 q2 = __ldg(rec + 2);
      const float tr =
          child_t(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, o, inv, best);
      const float4 q3 = __ldg(rec + 3);
      const bool left_first = tl <= tr;
      const float near_t = left_first ? tl : tr;
      const float far_t = left_first ? tr : tl;
      const int near_e = (int)(left_first ? q3.x : q3.y);
      const int far_e = (int)(left_first ? q3.y : q3.x);
      if (far_t < CUDART_INF_F) {
        if (sp < STACK) {
          stack[sp] = make_int2(far_e, __float_as_int(far_t));
          ++sp;
        } else {
          atomicAdd(overflow, 1);
        }
      }
      deepest = max(deepest, sp);
      if (near_t < CUDART_INF_F) {
        cur = near_e;
        curt = near_t;
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
