// Ray and triangle records and the Moller-Trumbore test shared by the
// traversal kernel (traversal.cu) and the dense kernel (dense.cu).
//
// Numerics: the arithmetic is written in the operation order of
// mc_path_tracer_tpu/ops/intersect.py moller_trumbore (dot products left to
// right, jnp.cross's component formula, IEEE 1/det), and every source that
// includes this file is built with --fmad=false, so a test rounds exactly
// as the plain PyTorch version (ops/intersect.moller_trumbore) does on the
// card.  Contract: backface culling (det >= K_EPSILON), 0 <= u, v, u+v <= 1,
// t >= 0.  ops/intersect.early_exits names the rows that leave the split
// below early.
//
// Layout (row-major f32):
//   rays [R, 8]  o.xyz, d.xyz, live, t_max
//   geo  [T, 9]  v0, e1, e2 of each triangle, in leaf order

#pragma once

#include <cuda_runtime.h>

namespace mcpt {

constexpr float kEpsilon = 1e-6f;
constexpr float kHuge = 1e32f;
// Early u exit: with det >= kEpsilon, a u numerator above det * kUSlack
// makes the rounded u = num * (1 / det) exceed 1, and one below
// -det * kUFloor makes it negative (the exact product is far from the
// underflow to -0), whatever the roundings of 1 / det, of the product and
// of the bounds (each within a factor 1 +- 2^-22, 1 / det subnormal
// included).
constexpr float kUSlack = 1.0f + 0x1p-20f;
constexpr float kUFloor = 0x1p-100f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, live, t_max;
};

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int i) {
  const float4* r = reinterpret_cast<const float4*>(rays) + 2 * i;
  float4 a = __ldg(r);
  float4 b = __ldg(r + 1);
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// One geo row read from global memory through the read-only path.
__device__ __forceinline__ Tri load_tri(const float* __restrict__ g) {
  return Tri{__ldg(g + 0), __ldg(g + 1), __ldg(g + 2),
             __ldg(g + 3), __ldg(g + 4), __ldg(g + 5),
             __ldg(g + 6), __ldg(g + 7), __ldg(g + 8)};
}

// Moller-Trumbore in the reference operation order, split at the
// determinant: a row with !(det >= kEpsilon) (back-facing, grazing or NaN,
// which the full test also rejects) returns before the division and the
// rest of the test.  Written negated so that a NaN det stays a miss.  Past
// the split det >= 1e-6, so 1 / det is the reference's guarded reciprocal
// 1 / (|det| > 1e-30 ? det : 1) bit for bit.  A second early exit rejects
// rows whose u numerator alone proves u < 0 or u > 1 (conservatively:
// only rows the full test also rejects; NaN goes on).  Every surviving
// test rounds as the full reference does.  Returns valid, writes t when
// valid.
__device__ __forceinline__ bool moller_trumbore(const Ray& r, const Tri& g,
                                                float* t_out) {
  // pvec = cross(d, e2)
  const float px = r.dy * g.e2z - r.dz * g.e2y;
  const float py = r.dz * g.e2x - r.dx * g.e2z;
  const float pz = r.dx * g.e2y - r.dy * g.e2x;
  const float det = g.e1x * px + g.e1y * py + g.e1z * pz;
  if (!(det >= kEpsilon)) return false;
  const float tx = r.ox - g.v0x, ty = r.oy - g.v0y, tz = r.oz - g.v0z;
  const float u_num = tx * px + ty * py + tz * pz;
  if (u_num < -det * kUFloor || u_num > det * kUSlack) return false;
  const float inv_det = 1.0f / det;
  const float u = u_num * inv_det;
  // qvec = cross(tvec, e1)
  const float qx = ty * g.e1z - tz * g.e1y;
  const float qy = tz * g.e1x - tx * g.e1z;
  const float qz = tx * g.e1y - ty * g.e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (g.e2x * qx + g.e2y * qy + g.e2z * qz) * inv_det;
  *t_out = t;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
}

}  // namespace mcpt
