// K1 launcher: standalone ray-scene intersection (one thread per ray), over
// the BVH4, the binary two-level LBVH or the flat binary SAH tree.
//
// Replaces: rtrt_tpu/bvh/packet.py::packet_intersect -> _kernel ->
// traverse_tile.  The traversal itself and its cost notes live in
// traverse.cuh (shared with the megakernel, K2).
//
// What bounds it: dependent node/triangle loads per traversal step (see
// traverse.cuh); the launcher adds one coalesced read of the ray and one
// write of the 14 output floats per ray.
//
// Simple design: 128-thread blocks over a flat ray index; the attribute
// resolve (shading normal, geometric normal, material) is a direct gather
// at the winning slot — no distinct-winner loop.
#include <cuda_runtime.h>

#include "traverse.cuh"

namespace {

// kCount: cap each ray at max_steps visits and write its visits to steps;
// STACK: the traversal stack's depth; TREE: the tables' tree (traverse.cuh
// Tree): the BVH4 (traverse), the two-level LBVH (traverse2, tlas_internal
// TLAS rows) or the flat binary SAH tree (traverse2 with 8-slot leaf rows)
template <int STACK, bool kCount, int TREE>
__global__ void traverse_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ nrm, const float* __restrict__ ng,
    const int* __restrict__ mat, const float* __restrict__ org,
    const float* __restrict__ dir, const float* __restrict__ tmax, int n,
    int any_hit, float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ mat_out, float* __restrict__ ns_out,
    float* __restrict__ ng_out, int max_steps, int* __restrict__ steps,
    int* overflow, int tlas_internal) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float3 o = make_float3(org[3 * i], org[3 * i + 1], org[3 * i + 2]);
  float3 d = make_float3(dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
  int visits, deepest = 0;
  rtrt::TraceHit h;
  if constexpr (TREE == rtrt::TREE_LBVH)
    h = rtrt::traverse2<STACK, kCount>(nodes, tris, tlas_internal, o, d,
                                       tmax[i], any_hit != 0, overflow,
                                       deepest, max_steps, &visits);
  else if constexpr (TREE == rtrt::TREE_SAH2)
    h = rtrt::traverse2<STACK, kCount, rtrt::LEAF_WIDTH>(
        nodes, tris, 0, o, d, tmax[i], any_hit != 0, overflow, deepest,
        max_steps, &visits);
  else
    h = rtrt::traverse<STACK, kCount>(nodes, tris, o, d, tmax[i],
                                      any_hit != 0, overflow, deepest,
                                      max_steps, &visits);
  if (kCount) steps[i] = visits;
  int m;
  float3 ns, g;
  rtrt::hit_attrs(nrm, ng, mat, h, m, ns, g);
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  u_out[i] = h.u;
  v_out[i] = h.v;
  mat_out[i] = m;
  ns_out[3 * i] = ns.x;
  ns_out[3 * i + 1] = ns.y;
  ns_out[3 * i + 2] = ns.z;
  ng_out[3 * i] = g.x;
  ng_out[3 * i + 1] = g.y;
  ng_out[3 * i + 2] = g.z;
}

template <int STACK, int TREE>
void launch(int grid, int block, cudaStream_t s, const float* nodes,
            const float* tris, const float* nrm, const float* ng,
            const int* mat, const float* org, const float* dir,
            const float* tmax, int n, int any_hit, float* t, int* tri,
            float* u, float* v, int* mat_out, float* ns, float* ng_out,
            int max_steps, int* steps, int* overflow, int tlas_internal) {
  if (steps == nullptr)
    traverse_kernel<STACK, false, TREE><<<grid, block, 0, s>>>(
        nodes, tris, nrm, ng, mat, org, dir, tmax, n, any_hit, t, tri, u, v,
        mat_out, ns, ng_out, max_steps, steps, overflow, tlas_internal);
  else
    traverse_kernel<STACK, true, TREE><<<grid, block, 0, s>>>(
        nodes, tris, nrm, ng, mat, org, dir, tmax, n, any_hit, t, tri, u, v,
        mat_out, ns, ng_out, max_steps, steps, overflow, tlas_internal);
}

}  // namespace

// steps: nullptr for the plain traversal; else (n,) visits per ray, each
// ray capped at max_steps.  arity, leaf_width, tlas_internal, stack: the
// tables' layout (bvh/packet.py::layout_args; traverse.cuh tree_kind):
// any triple without an instantiation is refused (cudaErrorInvalidValue)
// and nothing launches.
extern "C" int rtrt_traverse(const float* nodes, const float* tris,
                             const float* nrm, const float* ng,
                             const int* mat, const float* org,
                             const float* dir, const float* tmax, int n,
                             int any_hit, float* t, int* tri, float* u,
                             float* v, int* mat_out, float* ns,
                             float* ng_out, int max_steps, int* steps,
                             int* overflow, int arity, int leaf_width,
                             int tlas_internal, int stack, void* stream) {
  const int tree = rtrt::tree_kind(arity, leaf_width, stack);
  if (tree < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool small = stack == rtrt::STACK_SMALL;
#define RTRT_LAUNCH(STACK, TREE)                                            \
  launch<STACK, TREE>(grid, block, s, nodes, tris, nrm, ng, mat, org, dir, \
                      tmax, n, any_hit, t, tri, u, v, mat_out, ns, ng_out, \
                      max_steps, steps, overflow, tlas_internal)
    if (tree == rtrt::TREE_LBVH)
      RTRT_LAUNCH(rtrt::STACK_DEEP, rtrt::TREE_LBVH);
    else if (tree == rtrt::TREE_SAH2 && small)
      RTRT_LAUNCH(rtrt::STACK_SMALL, rtrt::TREE_SAH2);
    else if (tree == rtrt::TREE_SAH2)
      RTRT_LAUNCH(rtrt::STACK_DEEP, rtrt::TREE_SAH2);
    else if (small)
      RTRT_LAUNCH(rtrt::STACK_SMALL, rtrt::TREE_BVH4);
    else
      RTRT_LAUNCH(rtrt::STACK_DEEP, rtrt::TREE_BVH4);
#undef RTRT_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

// the traversal stack depths (entries) that have an instantiation for
// tables of (arity, leaf_width), for the callers' checks: writes up to cap
// of them to depths, returns how many exist
extern "C" int rtrt_traverse_stack(int* depths, int cap, int arity,
                                   int leaf_width) {
  const int stacks[] = {rtrt::STACK_SMALL, rtrt::STACK_DEEP};
  int n = 0;
  for (int stack : stacks)
    if (rtrt::tree_kind(arity, leaf_width, stack) >= 0) {
      if (n < cap) depths[n] = stack;
      ++n;
    }
  return n < cap ? n : cap;
}
