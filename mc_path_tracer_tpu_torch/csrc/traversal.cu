// Closest-hit and any-hit BVH traversal for Hopper (sm_90a).
//
// Replaces: mc_path_tracer_tpu/ops/pallas/traversal_kernel.py
//   _make_arena_kernel (launched by _traverse_arena), and serves the
//   contract of _make_kernel (the paged/streaming kernel behind
//   _traverse_packed) as well: this kernel reads the tree from global
//   memory and has no size cap.  It keeps the contract, not the TPU layout:
//   Moller-Trumbore with backface culling (det >= K_EPSILON), t >= 0,
//   per-ray t_max for any-hit, dead lanes (live <= 0.5) return a miss.
//
// What bounds it on the H100: the latency of dependent loads.  Each step of
// the skip-link walk loads one 32-byte node whose address depends on the
// previous step, then up to four 36-byte triangles.  The bench scene's tree
// (51,709 nodes x 32 B) and triangles (48,002 x 36 B) come to about 3.4 MB,
// which sits in the 50 MB L2 after the first pass, so bandwidth is far from
// the limit; each ray pays roughly one L1/L2 round trip per visited node.
//
// What this simple design does about it: one thread per ray, stackless
// (the threaded tree's skip links replace the per-thread stack, so a thread
// holds only its node index and best hit in registers), nodes read as two
// aligned float4 loads through the read-only path, and many independent
// rays in flight per SM to hide the latency.  Later work: sort rays by
// direction octant so a warp walks the same nodes (the TPU path's
// _sort_perm), near-child-first order with a short stack so closest hits
// shrink t_best earlier, wide (4- or 8-ary) nodes to cut the dependent
// chain, and persistent threads that refill finished lanes.
//
// Numerics: the arithmetic is written in the operation order of
// mc_path_tracer_tpu/ops/intersect.py (moller_trumbore, shared with the
// dense kernel in mt.cuh, and _slab_test) and is built with --fmad=false,
// so it rounds exactly as the plain PyTorch version does on the card and
// the two agree on nearly every lane.
//
// Layout (row-major f32):
//   rays  [R, 8]  o.xyz, d.xyz, live, t_max
//   nodes [N, 8]  bmin.xyz, bmax.xyz, bits(first*16 + count), bits(skip)
//   geo   [T, 9]  v0, e1, e2 of each triangle, in leaf order
// A node's box hit advances to idx+1 (inner node) or tests the leaf's
// `count` triangles and moves to `skip`; a miss moves to `skip`; skip == N
// ends the walk.  Depth-first leaf order is triangle index order, so the
// strict t < t_best update resolves ties to the lowest triangle index.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using mcpt::kHuge;
using mcpt::load_ray;
using mcpt::load_tri;
using mcpt::moller_trumbore;
using mcpt::Ray;

constexpr int kThreads = 128;

// jnp.reciprocal(where(|d| > 1e-12, d, where(d >= 0, 1e-12, -1e-12)))
__device__ __forceinline__ float safe_inv(float d) {
  float g = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / g;
}

// Walks the threaded tree for one ray.  ANY_HIT stops at the first valid
// hit with t <= t_max; otherwise keeps the closest (strict t < t_best).
// Boxes are pruned against t_best, which stays K_HUGE for any-hit, as in
// intersect._traverse_chunk.  The step cap (4N + 8, the JAX walk's
// max_steps) bounds a malformed tree instead of hanging the card.
template <bool ANY_HIT>
__device__ __forceinline__ void traverse(const Ray& r,
                                         const float* __restrict__ nodes,
                                         int num_nodes,
                                         const float* __restrict__ geo,
                                         float* t_best_out, int* id_out,
                                         bool* occ_out) {
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  float t_best = kHuge;
  int best = -1;
  bool occ = false;
  int idx = 0;
  const long long max_steps = 4LL * num_nodes + 8;
  for (long long step = 0; idx < num_nodes && step < max_steps; ++step) {
    const float4* n = reinterpret_cast<const float4*>(nodes) + 2 * idx;
    const float4 a = __ldg(n);
    const float4 b = __ldg(n + 1);
    const int meta = __float_as_int(b.z);
    const int skip = __float_as_int(b.w);
    const float t0x = (a.x - r.ox) * ix, t1x = (a.w - r.ox) * ix;
    const float t0y = (a.y - r.oy) * iy, t1y = (b.x - r.oy) * iy;
    const float t0z = (a.z - r.oz) * iz, t1z = (b.y - r.oz) * iz;
    const float tnear =
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tfar =
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const bool box_hit = tnear <= tfar && tfar >= 0.0f && tnear <= t_best;
    const int count = meta & 15;
    if (!box_hit) {
      idx = skip;
      continue;
    }
    if (count == 0) {
      idx = idx + 1;
      continue;
    }
    const int first = meta >> 4;
    for (int k = 0; k < count; ++k) {
      float t;
      const bool valid = moller_trumbore(r, load_tri(geo + 9LL * (first + k)), &t);
      if (ANY_HIT) {
        if (valid && t <= r.t_max) {
          occ = true;
          break;
        }
      } else if (valid && t < t_best) {
        t_best = t;
        best = first + k;
      }
    }
    if (ANY_HIT && occ) break;
    idx = skip;
  }
  *t_best_out = t_best;
  *id_out = best;
  *occ_out = occ;
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ rays, int num_rays,
               const float* __restrict__ nodes, int num_nodes,
               const float* __restrict__ geo, float* __restrict__ out_t,
               int* __restrict__ out_id) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const Ray r = load_ray(rays, i);
  float t = kHuge;
  int id = -1;
  bool occ = false;
  if (r.live > 0.5f) {
    traverse<false>(r, nodes, num_nodes, geo, &t, &id, &occ);
  }
  out_t[i] = id >= 0 ? t : kHuge;
  out_id[i] = id;
}

__global__ void __launch_bounds__(kThreads)
anyhit_kernel(const float* __restrict__ rays, int num_rays,
              const float* __restrict__ nodes, int num_nodes,
              const float* __restrict__ geo, bool* __restrict__ out_occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const Ray r = load_ray(rays, i);
  float t = kHuge;
  int id = -1;
  bool occ = false;
  if (r.live > 0.5f) {
    traverse<true>(r, nodes, num_nodes, geo, &t, &id, &occ);
  }
  out_occ[i] = occ;
}

inline unsigned int blocks_for(int n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
extern "C" int mcpt_closest(const float* rays, int num_rays, const float* nodes,
                            int num_nodes, const float* geo, int num_tris,
                            float* out_t, int* out_id, cudaStream_t stream) {
  (void)num_tris;
  if (num_rays <= 0) return 0;
  closest_kernel<<<blocks_for(num_rays), kThreads, 0, stream>>>(
      rays, num_rays, nodes, num_nodes, geo, out_t, out_id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcpt_anyhit(const float* rays, int num_rays, const float* nodes,
                           int num_nodes, const float* geo, int num_tris,
                           bool* out_occ, cudaStream_t stream) {
  (void)num_tris;
  if (num_rays <= 0) return 0;
  anyhit_kernel<<<blocks_for(num_rays), kThreads, 0, stream>>>(
      rays, num_rays, nodes, num_nodes, geo, out_occ);
  return static_cast<int>(cudaGetLastError());
}
