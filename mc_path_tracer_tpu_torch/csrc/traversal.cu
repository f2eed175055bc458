// Closest-hit and any-hit BVH traversal for Hopper (sm_90a): a 4-wide tree
// walked near-first with a conservative box test.
//
// Replaces: mc_path_tracer_tpu/ops/pallas/traversal_kernel.py
//   _make_arena_kernel (launched by _traverse_arena), and serves the
//   contract of _make_kernel (the paged/streaming kernel behind
//   _traverse_packed) as well: this kernel reads the tree from global
//   memory and has no size cap.  It keeps the contract, not the TPU layout:
//   Moller-Trumbore with backface culling (det >= K_EPSILON), t >= 0,
//   per-ray t_max for any-hit, dead lanes (live <= 0.5) return a miss, and
//   closest hits resolve ties in t to the lowest triangle index, so the
//   answer is the brute-force one on every lane.
//
// What bounds it on the H100: the latency of dependent loads, not bytes or
// operations.  The bench scene's tables (3.4 MB) sit in the 50 MB L2; a
// ray's walk is a chain of loads whose addresses depend on the previous
// box tests, and one 65,536-ray dispatch gives a quarter of the card's
// thread slots, too few to hide that chain by occupancy alone.  The binary
// skip-link walk of the first design took ~48 such steps per ray on the
// bench shapes, in a fixed depth-first order that cannot visit the nearer
// child first.  With four boxes a step, the work of a step now sets much
// of the time too: this design runs 2.0x (closest) and 1.4x (any-hit) the
// binary walk's speed at the bench shapes (PERF.md), not the 4.6x its
// shorter chain of loads alone would give.
//
// What this design does about it:
//   - a 4-wide tree (ops/bvh.collapse_wide): one 128-byte row per node, the
//     four child boxes SoA, read as seven independent float4 loads, so a
//     step tests four boxes and a bench ray loads about a quarter as many
//     nodes (10.3 visits against 47.7 binary ones).  4-wide rather than 8:
//     at 4 the kernels build to 48 registers with no spills (chip_smoke
//     [build]); eight boxes would add 24 live floats per step, and half of
//     each 8-wide node would sit empty near the leaves of a max_leaf = 4
//     tree;
//   - near-first order for closest hits: the hit children are sorted by
//     (tnear, slot), the nearest is taken at once and the others pushed
//     farthest first, each with its tnear, so t_best shrinks early and a
//     popped entry is dropped when tnear > t_best;
//   - the per-thread stack lives in shared memory ([entry][thread], so a
//     warp's pushes fill contiguous words without bank conflicts), never
//     in local memory: a ref per entry, and for closest hits the entry's
//     tnear in a second array (any-hit needs none, so its blocks take half
//     the shared memory and 131,072 rays fit on the card in one wave); its
//     depth is 3 entries per tree level (ops/kernels/traversal.stack_entries),
//     which the wrapper sizes from the tree's depth and refuses beyond
//     MAX_STACK, so no node is ever dropped;
//   - 64-thread blocks, so a 65,536-ray dispatch spreads over all 132 SMs
//     in near-equal shares.
//   Persistent threads and ray sorting are left for later (ROADMAP).
//
// Ties and pruning.  A near-first walk does not meet triangles in index
// order, so the closest hit updates on t < t_best || (t == t_best && id <
// best), and a box or stack entry is pruned only when tnear > t_best, so an
// equal-t box is still visited: the result is the lexicographic minimum of
// (t, id), the plain argmin's.  Any-hit takes children in slot order and
// stops at its first hit with t <= t_max; its boxes are pruned at t_max.
//
// Conservative box test.  A box the triangle test would hit must never be
// missed by f32 rounding (a ray grazing the zero-thickness box of a floor
// or a quad did, once in 45,975 config2 shadow rays).  Two margins: the
// slab tfar is scaled by 1 + 2^-21 >= 1 + 2*gamma(3) (PBRT's
// Bounds3::IntersectP, after Ize, "Robust BVH Ray Traversal", JCGT 2013),
// and every child box is padded outward at the collapse (ops/bvh.BOX_PAD).
// Only the number of visits may change, never a hit.
//
// Numerics: triangle tests are mt.cuh's det-first Moller-Trumbore in the
// reference operation order, built with --fmad=false, so a hit's t is the
// plain version's bit for bit.  The torch replay of this walk (same order,
// stack and box test) is ops/kernels/traversal.walk_plain.
//
// Layout (row-major f32):
//   rays  [R, 8]   o.xyz, d.xyz, live, t_max
//   nodes [W, 32]  lo.x[4] hi.x[4] lo.y[4] hi.y[4] lo.z[4] hi.z[4]
//                  ref[4] (int32 bits) pad[4]; row 0 is the root.  A ref
//                  >= 0 is an inner node's row, -1 an empty slot, and any
//                  other negative ref a leaf ~(first * 16 + count)
//   geo   [T, 9]   v0, e1, e2 of each triangle, in leaf order

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using mcpt::kHuge;
using mcpt::load_ray;
using mcpt::load_tri;
using mcpt::moller_trumbore;
using mcpt::Ray;

constexpr int kThreads = 64;
constexpr int kEmpty = -1;
// 1 + 4 ulp, at least 1 + 2*gamma(3) = 1 + 6u / (1 - 3u), u = 2^-24
constexpr float kTfarScale = 1.0f + 0x1p-21f;
constexpr float kNoHit = __builtin_huge_valf();

// jnp.reciprocal(where(|d| > 1e-12, d, where(d >= 0, 1e-12, -1e-12)))
__device__ __forceinline__ float safe_inv(float d) {
  float g = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / g;
}

// One child's slab test: its tnear where the box is hit within `limit`,
// else kNoHit.
__device__ __forceinline__ float child_key(float lx, float hx, float ly, float hy,
                                           float lz, float hz, int ref, const Ray& r,
                                           float ix, float iy, float iz, float limit) {
  const float t0x = (lx - r.ox) * ix, t1x = (hx - r.ox) * ix;
  const float t0y = (ly - r.oy) * iy, t1y = (hy - r.oy) * iy;
  const float t0z = (lz - r.oz) * iz, t1z = (hz - r.oz) * iz;
  const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tfar =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * kTfarScale;
  const bool hit = ref != kEmpty && tnear <= tfar && tfar >= 0.0f && tnear <= limit;
  return hit ? tnear : kNoHit;
}

// Orders slots a < b by (key, slot).
__device__ __forceinline__ void order(float& ka, int& ca, int& sa, float& kb, int& cb,
                                      int& sb) {
  if (ka > kb || (ka == kb && sa > sb)) {
    const float k = ka; ka = kb; kb = k;
    const int c = ca; ca = cb; cb = c;
    const int s = sa; sa = sb; sb = s;
  }
}

// Walks the wide tree for one live ray.  `stack_ref` and `stack_key` are
// this thread's columns of the block's shared stack (entry k at
// [k * kThreads]), `cap` entries deep; any-hit keeps no keys.  The step cap
// (5W + 8: each node and each leaf at most once) bounds a malformed tree
// instead of hanging the card.
template <bool ANY_HIT>
__device__ __forceinline__ void walk(const Ray& r, const float4* __restrict__ nodes,
                                     int num_nodes, const float* __restrict__ geo,
                                     int* stack_ref, float* stack_key, int cap,
                                     float* t_out, int* id_out, bool* occ_out) {
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  float t_best = kHuge;
  int best = -1;
  bool occ = false;
  int sp = 0;
  int ref = 0;
  const long long max_steps = 5LL * num_nodes + 8;
  for (long long step = 0; step < max_steps; ++step) {
    if (ref >= 0) {
      const float4* n = nodes + 8LL * ref;
      const float4 lx = __ldg(n), hx = __ldg(n + 1), ly = __ldg(n + 2), hy = __ldg(n + 3);
      const float4 lz = __ldg(n + 4), hz = __ldg(n + 5), rf = __ldg(n + 6);
      const float limit = ANY_HIT ? r.t_max : t_best;
      int c0 = __float_as_int(rf.x), c1 = __float_as_int(rf.y);
      int c2 = __float_as_int(rf.z), c3 = __float_as_int(rf.w);
      float k0 = child_key(lx.x, hx.x, ly.x, hy.x, lz.x, hz.x, c0, r, ix, iy, iz, limit);
      float k1 = child_key(lx.y, hx.y, ly.y, hy.y, lz.y, hz.y, c1, r, ix, iy, iz, limit);
      float k2 = child_key(lx.z, hx.z, ly.z, hy.z, lz.z, hz.z, c2, r, ix, iy, iz, limit);
      float k3 = child_key(lx.w, hx.w, ly.w, hy.w, lz.w, hz.w, c3, r, ix, iy, iz, limit);
      if (!ANY_HIT) {
        // sorting network on (tnear, slot); misses (kNoHit) sort last
        int s0 = 0, s1 = 1, s2 = 2, s3 = 3;
        order(k0, c0, s0, k1, c1, s1);
        order(k2, c2, s2, k3, c3, s3);
        order(k0, c0, s0, k2, c2, s2);
        order(k1, c1, s1, k3, c3, s3);
        order(k1, c1, s1, k2, c2, s2);
      }
      // hold the first hit child, push the others so the first pops next
      int next = kEmpty;
      float next_key = 0.0f;
#define MCPT_TAKE(K, C)                                  \
  if ((K) != kNoHit) {                                   \
    if (next != kEmpty) {                                \
      if (sp >= cap) __trap();                           \
      stack_ref[sp * kThreads] = next;                   \
      if (!ANY_HIT) stack_key[sp * kThreads] = next_key; \
      ++sp;                                              \
    }                                                    \
    next = (C);                                          \
    next_key = (K);                                      \
  }
      MCPT_TAKE(k3, c3)
      MCPT_TAKE(k2, c2)
      MCPT_TAKE(k1, c1)
      MCPT_TAKE(k0, c0)
#undef MCPT_TAKE
      if (next != kEmpty) {
        ref = next;
        continue;
      }
    } else {
      const int meta = ~ref;
      const int first = meta >> 4, count = meta & 15;
      for (int k = 0; k < count; ++k) {
        const int id = first + k;
        float t;
        if (moller_trumbore(r, load_tri(geo + 9LL * id), &t)) {
          if (ANY_HIT) {
            if (t <= r.t_max) {
              occ = true;
              break;
            }
          } else if (t < t_best || (t == t_best && id < best)) {
            t_best = t;
            best = id;
          }
        }
      }
      if (ANY_HIT && occ) break;
    }
    // pop the nearest entry not pruned by t_best
    bool found = false;
    while (sp > 0) {
      --sp;
      if (ANY_HIT || stack_key[sp * kThreads] <= t_best) {
        ref = stack_ref[sp * kThreads];
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  *t_out = t_best;
  *id_out = best;
  *occ_out = occ;
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ rays, int num_rays,
               const float4* __restrict__ nodes, int num_nodes,
               const float* __restrict__ geo, int cap, float* __restrict__ out_t,
               int* __restrict__ out_id) {
  extern __shared__ int stack_mem[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= num_rays) return;
  const Ray r = load_ray(rays, i);
  float t = kHuge;
  int id = -1;
  bool occ = false;
  if (r.live > 0.5f) {
    float* keys = reinterpret_cast<float*>(stack_mem + cap * kThreads);
    walk<false>(r, nodes, num_nodes, geo, stack_mem + threadIdx.x, keys + threadIdx.x, cap,
                &t, &id, &occ);
  }
  out_t[i] = id >= 0 ? t : kHuge;
  out_id[i] = id;
}

__global__ void __launch_bounds__(kThreads)
anyhit_kernel(const float* __restrict__ rays, int num_rays,
              const float4* __restrict__ nodes, int num_nodes,
              const float* __restrict__ geo, int cap, bool* __restrict__ out_occ) {
  extern __shared__ int stack_mem[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= num_rays) return;
  const Ray r = load_ray(rays, i);
  float t = kHuge;
  int id = -1;
  bool occ = false;
  if (r.live > 0.5f) {
    walk<true>(r, nodes, num_nodes, geo, stack_mem + threadIdx.x, nullptr, cap, &t, &id,
               &occ);
  }
  out_occ[i] = occ;
}

// Launch geometry: 64-thread blocks, cap stack entries of `entry` bytes per
// thread in dynamic shared memory (opted in above 48 KB).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int cap, size_t entry, size_t* smem) {
  *smem = static_cast<size_t>(cap) * entry * kThreads;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

inline unsigned int blocks_for(int n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError() (or the
// error of raising the kernel's shared-memory limit).  `stack_cap` is the
// per-thread stack depth in entries, at least stack_entries(depth) of the
// tree (the wrapper checks it).
extern "C" int mcpt_closest(const float* rays, int num_rays, const float* nodes,
                            int num_nodes, const float* geo, int num_tris,
                            int stack_cap, float* out_t, int* out_id,
                            cudaStream_t stream) {
  (void)num_tris;
  if (num_rays <= 0) return 0;
  size_t smem = 0;
  const cudaError_t err =
      prepare(closest_kernel, stack_cap, sizeof(int) + sizeof(float), &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  closest_kernel<<<blocks_for(num_rays), kThreads, smem, stream>>>(
      rays, num_rays, reinterpret_cast<const float4*>(nodes), num_nodes, geo, stack_cap,
      out_t, out_id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcpt_anyhit(const float* rays, int num_rays, const float* nodes,
                           int num_nodes, const float* geo, int num_tris,
                           int stack_cap, bool* out_occ, cudaStream_t stream) {
  (void)num_tris;
  if (num_rays <= 0) return 0;
  size_t smem = 0;
  const cudaError_t err = prepare(anyhit_kernel, stack_cap, sizeof(int), &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  anyhit_kernel<<<blocks_for(num_rays), kThreads, smem, stream>>>(
      rays, num_rays, reinterpret_cast<const float4*>(nodes), num_nodes, geo, stack_cap,
      out_occ);
  return static_cast<int>(cudaGetLastError());
}
