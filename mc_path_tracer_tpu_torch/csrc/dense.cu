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
// What bounds it on the H100: operations.  A full Moller-Trumbore test is
// 46 fp32 multiplies, adds and one division (mt.cuh), but most rows leave
// it early: 14 operations at the det split, 24 at the u exit.  The data
// are a few MB and stay in L2.  At config2's 65,536 camera rays x 2,320
// triangles, where about 52% of the tests stop at the det split and 47% at
// the u exit, that is about 19 operations a test, 2.9 GFLOP, 0.043 ms at
// 67 TFLOP/s (0.104 ms if every test ran in full).  The build keeps
// --fmad=false (so kernel and plain version agree bit for bit), and
// unfused multiplies and adds issue one instruction each: the reachable
// ceiling is about half the peak, ~0.086 ms for that dispatch.
//
// What this design does about it:
//   - the early exits of mt.cuh: a back-facing row (about half of a closed
//     mesh, for any ray) stops after 14 operations, and a front-facing row
//     whose u numerator already lies outside [0, det] after 24, both
//     before the division (25 and 38 SASS instructions against 77 for a
//     full test);
//   - four rays per thread: each triangle row staged in shared memory is
//     read once (three float4 broadcasts) and serves four independent
//     tests, which also gives the scheduler four independent chains;
//   - the triangle range is split over a second grid dimension until the
//     grid fills every SM with as many blocks as fit (65,536 rays make
//     only 128 blocks of 512 rays for 132 SMs).  Slices merge their
//     closest hits with a 64-bit atomicMin on (bits(t) << 32) | id into
//     scratch the wrapper allocates: t >= 0 (a -0 is stored as +0), so the
//     bits order as the numbers and ties go to the lowest id, as the plain
//     argmin does; a second small kernel decodes the scratch.  Any-hit
//     slices set the ray's output flag and read the other slices' flags at
//     every tile, and a block leaves its tile loop once all its rays are
//     occluded or dead.
//   78 (closest) and 63 (any-hit) registers, no spills.  Later work:
//   double-buffered staging (cp.async), a grid balanced over the SMs.
//
// Layout (row-major f32):
//   rays [R, 8]  o.xyz, d.xyz, live, t_max
//   geo  [T, 9]  v0, e1, e2 of each triangle, in leaf order

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using mcpt::kHuge;
using mcpt::load_ray;
using mcpt::moller_trumbore;
using mcpt::Ray;
using mcpt::Tri;

constexpr int kThreads = 128;
constexpr int kRays = 4;                       // rays per thread
constexpr int kBlockRays = kThreads * kRays;   // rays per block
constexpr int kTile = 256;                     // triangle rows staged per step
constexpr int kMinSlice = 128;                 // fewest rows a slice takes
constexpr unsigned long long kNoKey = ~0ull;

// Copies rows [base, base + n) of geo into the shared tile, 12 floats a row
// (three aligned float4, the last three unused): consecutive threads load
// consecutive floats.
__device__ __forceinline__ void stage_tile(float4* tile, const float* __restrict__ geo,
                                           int base, int n) {
  float* dst = reinterpret_cast<float*>(tile);
  const float* src = geo + 9LL * base;
  for (int k = threadIdx.x; k < 9 * n; k += kThreads) {
    const int row = k / 9;
    dst[12 * row + (k - 9 * row)] = __ldg(src + k);
  }
}

__device__ __forceinline__ Tri tile_row(const float4* tile, int j) {
  const float4 a = tile[3 * j], b = tile[3 * j + 1], c = tile[3 * j + 2];
  return Tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
}

// This thread's rays, i = block base + q * kThreads + thread; returns
// whether any is live.
__device__ __forceinline__ bool load_rays(const float* __restrict__ rays, int num_rays,
                                          Ray* r, bool* live) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int i = blockIdx.x * kBlockRays + q * kThreads + threadIdx.x;
    r[q] = Ray{};
    live[q] = false;
    if (i < num_rays) {
      r[q] = load_ray(rays, i);
      live[q] = r[q].live > 0.5f;
    }
    any = any || live[q];
  }
  return any;
}

__global__ void __launch_bounds__(kThreads)
dense_closest_kernel(const float* __restrict__ rays, int num_rays,
                     const float* __restrict__ geo, int num_tris, int slice_rows,
                     unsigned long long* __restrict__ keys) {
  __shared__ float4 tile[3 * kTile];
  const int lo = blockIdx.y * slice_rows;
  const int hi = min(num_tris, lo + slice_rows);
  Ray r[kRays];
  bool live[kRays];
  float t_best[kRays];
  int best[kRays];
  const bool any = load_rays(rays, num_rays, r, live);
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    t_best[q] = kHuge;
    best[q] = -1;
  }
  // a block whose rays are all dead or out of range tests nothing
  if (!__syncthreads_or(any)) return;
  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    stage_tile(tile, geo, base, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const Tri g = tile_row(tile, j);
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        float t;
        // strict < over increasing index: ties go to the lowest index
        if (live[q] && moller_trumbore(r[q], g, &t) && t < t_best[q]) {
          t_best[q] = t;
          best[q] = base + j;
        }
      }
    }
    __syncthreads();  // the tile is read before the next one overwrites it
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    if (best[q] >= 0) {
      const int i = blockIdx.x * kBlockRays + q * kThreads + threadIdx.x;
      const float t = t_best[q] == 0.0f ? 0.0f : t_best[q];
      atomicMin(keys + i, (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
                              static_cast<unsigned int>(best[q]));
    }
  }
}

__global__ void dense_closest_decode_kernel(const unsigned long long* __restrict__ keys,
                                            int num_rays, float* __restrict__ out_t,
                                            int* __restrict__ out_id) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const unsigned long long k = keys[i];
  const bool hit = k != kNoKey;
  out_t[i] = hit ? __uint_as_float(static_cast<unsigned int>(k >> 32)) : kHuge;
  out_id[i] = hit ? static_cast<int>(k & 0xffffffffull) : -1;
}

__global__ void __launch_bounds__(kThreads)
dense_anyhit_kernel(const float* __restrict__ rays, int num_rays,
                    const float* __restrict__ geo, int num_tris, int slice_rows,
                    bool* __restrict__ out_occ) {
  __shared__ float4 tile[3 * kTile];
  const int lo = blockIdx.y * slice_rows;
  const int hi = min(num_tris, lo + slice_rows);
  Ray r[kRays];
  bool todo[kRays];
  bool busy = load_rays(rays, num_rays, r, todo);
  // leaves once no ray of the block is left to test; the barrier also keeps
  // the tile until every thread has read it
  for (int base = lo; base < hi && __syncthreads_or(busy); base += kTile) {
    const int n = min(kTile, hi - base);
    // drop the rays another slice has found occluded meanwhile
    busy = false;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const volatile bool* flag = out_occ + blockIdx.x * kBlockRays + q * kThreads + threadIdx.x;
      todo[q] = todo[q] && !*flag;
      busy = busy || todo[q];
    }
    stage_tile(tile, geo, base, n);
    __syncthreads();
    for (int j = 0; j < n && busy; ++j) {
      const Tri g = tile_row(tile, j);
      busy = false;
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        float t;
        if (todo[q] && moller_trumbore(r[q], g, &t) && t <= r[q].t_max) {
          todo[q] = false;
          out_occ[blockIdx.x * kBlockRays + q * kThreads + threadIdx.x] = true;
        }
        busy = busy || todo[q];
      }
    }
  }
}

// The launch grid: ray blocks x triangle slices, with slices added until
// the grid holds as many blocks as the card keeps resident at once, each
// slice at least kMinSlice rows.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int num_rays, int num_tris, dim3* grid,
                     int* slice_rows) {
  static int resident = 0;   // blocks of this kernel the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int ray_blocks = (num_rays + kBlockRays - 1) / kBlockRays;
  int slices = resident / ray_blocks;
  slices = min(slices, (num_tris + kMinSlice - 1) / kMinSlice);
  slices = max(slices, 1);
  *slice_rows = (num_tris + slices - 1) / slices;
  if (*slice_rows > 0) slices = (num_tris + *slice_rows - 1) / *slice_rows;
  *grid = dim3(static_cast<unsigned int>(ray_blocks), static_cast<unsigned int>(slices));
  return cudaSuccess;
}

}  // namespace

// Plain C interface, bound with ctypes.  Each entry point clears its
// output or scratch, launches on the given stream, does not synchronise,
// and returns the first CUDA error (cudaGetLastError() after the launches).
// `scratch` holds num_rays 64-bit keys.
extern "C" int mcpt_dense_closest(const float* rays, int num_rays,
                                  const float* geo, int num_tris,
                                  unsigned long long* scratch, float* out_t,
                                  int* out_id, cudaStream_t stream) {
  if (num_rays <= 0) return 0;
  dim3 grid;
  int slice_rows = 0;
  cudaError_t err = grid_for(dense_closest_kernel, num_rays, num_tris, &grid, &slice_rows);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0xFF, sizeof(unsigned long long) * num_rays, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_closest_kernel<<<grid, kThreads, 0, stream>>>(rays, num_rays, geo, num_tris,
                                                      slice_rows, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_closest_decode_kernel<<<(num_rays + 255) / 256, 256, 0, stream>>>(
      scratch, num_rays, out_t, out_id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcpt_dense_anyhit(const float* rays, int num_rays,
                                 const float* geo, int num_tris,
                                 bool* out_occ, cudaStream_t stream) {
  if (num_rays <= 0) return 0;
  dim3 grid;
  int slice_rows = 0;
  cudaError_t err = grid_for(dense_anyhit_kernel, num_rays, num_tris, &grid, &slice_rows);
  if (err == cudaSuccess) err = cudaMemsetAsync(out_occ, 0, sizeof(bool) * num_rays, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_anyhit_kernel<<<grid, kThreads, 0, stream>>>(rays, num_rays, geo, num_tris,
                                                     slice_rows, out_occ);
  return static_cast<int>(cudaGetLastError());
}
