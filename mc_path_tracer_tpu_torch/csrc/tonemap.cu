// Display pass for Hopper (sm_90a): accumulated radiance -> 8-bit RGB.
//
// Replaces: mc_path_tracer_tpu/ops/pallas/tonemap_kernel.py
//   `tonemap_pallas` with its kernel `_kernel`, the reference's
//   draw_to_surface (wavefront_kernels.cu:6-40).  Per pixel, in this order
//   and in f32: c = Ld / max(samples, 1); c = c * exposure;
//   c = c / (c + 1) (Reinhard); clip(c * 255, 0, 255), truncated to uint8
//   as astype(uint8) truncates.  Built without --use_fast_math, so `/` is
//   the IEEE-rounded division PyTorch's plain version uses and the two
//   agree bit for bit.
//
// What bounds it on the H100: bytes.  Each pixel reads 12 + 4 bytes and
// writes 3, and does a handful of operations on them: 39.4 MB at 1080p.
//
// What this simple design does about it: one thread per pixel, 256
// threads a block, the sample count and the three channels read once and
// the three bytes written once; neighbouring threads touch neighbouring
// pixels, so every load and store is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned char quantize(float c) {
  const float q = fminf(fmaxf(c * 255.0f, 0.0f), 255.0f);
  return static_cast<unsigned char>(q);
}

__global__ void __launch_bounds__(kThreads)
tonemap_kernel(const float* __restrict__ ld, const float* __restrict__ samples,
               float exposure, long long num_pixels,
               unsigned char* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= num_pixels) return;
  const float s = fmaxf(__ldg(samples + p), 1.0f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float c = __ldg(ld + 3 * p + ch) / s;
    c = c * exposure;
    c = c / (c + 1.0f);
    out[3 * p + ch] = quantize(c);
  }
}

}  // namespace

// Plain C interface, bound with ctypes: launches on the given stream, does
// not synchronise, and returns cudaGetLastError().
extern "C" int mcpt_tonemap(const float* ld, const float* samples,
                            float exposure, long long num_pixels,
                            unsigned char* out, cudaStream_t stream) {
  if (num_pixels <= 0) return 0;
  const long long blocks = (num_pixels + kThreads - 1) / kThreads;
  tonemap_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      ld, samples, exposure, num_pixels, out);
  return static_cast<int>(cudaGetLastError());
}
