// Dense closest-hit and any-hit for Hopper (sm_90a): every ray against
// every triangle, no acceleration structure.
//
// Replaces: mc_path_tracer_tpu/ops/pallas/intersect_kernel.py `_run`
//   (intersect_dense_pallas / occluded_dense_pallas) with its kernels
//   `_closest_kernel` and `_anyhit_kernel`.  It keeps the contract, not the
//   TPU layout: the same packed rays [R, 8] and leaf-order geo [T, 9] as
//   the traversal kernel (not the TPU's component-major [9, T]); closest
//   keeps (t, id) with ties to the lowest index and returns (t, tri_id),
//   from which ops/intersect.finish_closest recomputes u, v; any-hit
//   honours each ray's t_max directly (the TPU route's "closest t <= t_max"
//   answers the same question); dead lanes (live <= 0.5) return a miss.
//
// What bounds it on the H100: operations.  Each ray runs R x T
// Moller-Trumbore tests of 46 fp32 multiplies, adds and one division
// (mt.cuh); the data are a few MB and stay in L2.  At config2's 65,536
// camera rays x 2,320 triangles that is 7.0 GFLOP per dispatch.
//
// What this simple design does about it: one thread per ray, 128 threads
// a block; the block stages 128 triangle rows (4.6 KB) at a time in shared
// memory with coalesced loads, so every row read from global memory serves
// 128 rays, and every thread then reads the same shared address (a
// broadcast, no bank conflicts).  Closest hits use a strict t < t_best
// over increasing index, so ties go to the lowest index as the TPU
// kernel's first-min and strict cross-block compare do.  Any-hit stops a
// thread at its first hit within t_max, and the block leaves the tile loop
// once every thread is done (__syncthreads_or).  Later work: several rays
// per thread to reuse each staged row from registers, and a larger tile
// per barrier.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using mcpt::kHuge;
using mcpt::load_ray;
using mcpt::moller_trumbore;
using mcpt::Ray;
using mcpt::Tri;

constexpr int kThreads = 128;
constexpr int kTile = 128;  // triangle rows staged per block and step

// Copies rows [base, base + n) of geo into the shared tile: consecutive
// threads load consecutive floats.
__device__ __forceinline__ void stage_tile(float* tile,
                                           const float* __restrict__ geo,
                                           int base, int n) {
  const float* src = geo + 9LL * base;
  for (int k = threadIdx.x; k < 9 * n; k += kThreads) tile[k] = __ldg(src + k);
}

__device__ __forceinline__ Tri tile_row(const float* tile, int j) {
  const float* g = tile + 9 * j;
  return Tri{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8]};
}

__global__ void __launch_bounds__(kThreads)
dense_closest_kernel(const float* __restrict__ rays, int num_rays,
                     const float* __restrict__ geo, int num_tris,
                     float* __restrict__ out_t, int* __restrict__ out_id) {
  __shared__ float tile[9 * kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  Ray r{};
  bool active = false;
  if (i < num_rays) {
    r = load_ray(rays, i);
    active = r.live > 0.5f;
  }
  float t_best = kHuge;
  int best = -1;
  // a block whose lanes are all dead or out of range tests nothing
  if (__syncthreads_or(active)) {
    for (int base = 0; base < num_tris; base += kTile) {
      const int n = min(kTile, num_tris - base);
      stage_tile(tile, geo, base, n);
      __syncthreads();
      if (active) {
        for (int j = 0; j < n; ++j) {
          float t;
          if (moller_trumbore(r, tile_row(tile, j), &t) && t < t_best) {
            t_best = t;
            best = base + j;
          }
        }
      }
      __syncthreads();  // the tile is read before the next one overwrites it
    }
  }
  if (i < num_rays) {
    out_t[i] = best >= 0 ? t_best : kHuge;
    out_id[i] = best;
  }
}

__global__ void __launch_bounds__(kThreads)
dense_anyhit_kernel(const float* __restrict__ rays, int num_rays,
                    const float* __restrict__ geo, int num_tris,
                    bool* __restrict__ out_occ) {
  __shared__ float tile[9 * kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  Ray r{};
  bool done = true;
  if (i < num_rays) {
    r = load_ray(rays, i);
    done = !(r.live > 0.5f);
  }
  bool occ = false;
  // leaves once every thread of the block is done; the barrier also keeps
  // the tile until every thread has read it
  for (int base = 0; base < num_tris && __syncthreads_or(!done); base += kTile) {
    const int n = min(kTile, num_tris - base);
    stage_tile(tile, geo, base, n);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        float t;
        if (moller_trumbore(r, tile_row(tile, j), &t) && t <= r.t_max) {
          occ = true;
          done = true;
          break;
        }
      }
    }
  }
  if (i < num_rays) out_occ[i] = occ;
}

inline unsigned int blocks_for(int n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
extern "C" int mcpt_dense_closest(const float* rays, int num_rays,
                                  const float* geo, int num_tris,
                                  float* out_t, int* out_id,
                                  cudaStream_t stream) {
  if (num_rays <= 0) return 0;
  dense_closest_kernel<<<blocks_for(num_rays), kThreads, 0, stream>>>(
      rays, num_rays, geo, num_tris, out_t, out_id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcpt_dense_anyhit(const float* rays, int num_rays,
                                 const float* geo, int num_tris,
                                 bool* out_occ, cudaStream_t stream) {
  if (num_rays <= 0) return 0;
  dense_anyhit_kernel<<<blocks_for(num_rays), kThreads, 0, stream>>>(
      rays, num_rays, geo, num_tris, out_occ);
  return static_cast<int>(cudaGetLastError());
}
