// The exact-f32 ray-sphere pair test of the sphere scans, shared by K1
// (sphere_scan.cu) and K4 (bounce_megakernel.cu).
//
// Per (ray, sphere), in this order and with every operation rounded on its
// own (the __f*_rn intrinsics are never contracted into FMAs, and the
// libraries are also built with -fmad=false):
//   oc = ro - c;  half_b = -(oc.rd);  c0 = oc.oc - r2;  disc = half_b^2 - c0
//   sq = sqrt(disc) (IEEE);  t = half_b - sq, or half_b + sq for a
//   transparent sphere (flag > 1.5) whose near root is below t_min.
// The best hit is replaced only on t >= t_min and t < t_best, so the first
// index wins ties. This is the sequence of the plain PyTorch versions
// (ops/sphere_scan.py::intersect_spheres_scan_plain), so both agree bit for
// bit.
//
// The root is taken only when disc >= 0. A negative disc (a miss, or a
// padding row with r2 = -inf) or a NaN one gives a NaN sqrt, hence a NaN t
// that fails t >= t_min: skipping that branch gives the same result, and
// saves the IEEE sqrt and the root select on nearly every pair.

#pragma once

#include <cuda_runtime.h>

namespace lpt {

struct ScanRay {
  float ox, oy, oz, dx, dy, dz;
};

// The discriminant of the pair (ray r, sphere c: centre and r^2), and its
// half_b.
__device__ __forceinline__ float pair_disc(const ScanRay& r, float4 c, float& half_b) {
  const float ocx = __fsub_rn(r.ox, c.x);
  const float ocy = __fsub_rn(r.oy, c.y);
  const float ocz = __fsub_rn(r.oz, c.z);
  half_b = -__fadd_rn(
      __fadd_rn(__fmul_rn(ocx, r.dx), __fmul_rn(ocy, r.dy)), __fmul_rn(ocz, r.dz));
  const float c0 = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)), __fmul_rn(ocz, ocz)),
      c.w);
  return __fsub_rn(__fmul_rn(half_b, half_b), c0);
}

// The root of a pair with disc >= 0 (sphere j, its flag at *flag), offered
// to the running best (t_best, idx_best).
__device__ __forceinline__ void pair_root(float half_b, float disc, const float* flag, int j,
                                          float t_min, float& t_best, int& idx_best) {
  const float sq = __fsqrt_rn(disc);
  const float t_near = __fsub_rn(half_b, sq);
  const bool use_far = (t_near < t_min) && (*flag > 1.5f);
  const float t = use_far ? __fadd_rn(half_b, sq) : t_near;
  if (t >= t_min && t < t_best) {
    t_best = t;
    idx_best = j;
  }
}

// Pairs whose discriminants share one branch. On the H100, 4 gave the
// least K4 time a mega frame (8 and 16 sped up a pass of coherent primary
// rays but slowed the frame's incoherent passes, whose roots diverge more
// in larger groups) and K1 within 5 % of the best.
constexpr int kScanGroup = 4;

// Scans the spheres [j0, j1) of a chunk staged in shared memory (sph:
// centres and r^2; flag: flags), whose first sphere is sphere `base` of the
// table, in increasing order. The discriminants of kScanGroup pairs are
// computed before one branch on whether any is >= 0, so their arithmetic
// overlaps (a branch per pair cuts the loop into blocks that the compiler
// schedules one by one); the roots then run pair by pair, in order, for
// the pairs with disc >= 0 only.
__device__ __forceinline__ void scan_range(const ScanRay& r, const float4* sph,
                                           const float* flag, int j0, int j1, int base,
                                           float t_min, float& t_best, int& idx_best) {
  int j = j0;
  for (; j + kScanGroup <= j1; j += kScanGroup) {
    float half_b[kScanGroup], disc[kScanGroup];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kScanGroup; ++u) {
      disc[u] = pair_disc(r, sph[j + u], half_b[u]);
      any |= disc[u] >= 0.f;
    }
    if (any) {
#pragma unroll
      for (int u = 0; u < kScanGroup; ++u) {
        if (disc[u] >= 0.f) {
          pair_root(half_b[u], disc[u], flag + j + u, base + j + u, t_min, t_best, idx_best);
        }
      }
    }
  }
  for (; j < j1; ++j) {
    float half_b;
    const float disc = pair_disc(r, sph[j], half_b);
    if (disc >= 0.f) pair_root(half_b, disc, flag + j, base + j, t_min, t_best, idx_best);
  }
}

}  // namespace lpt
