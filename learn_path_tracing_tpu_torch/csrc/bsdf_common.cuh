// The device helpers of the kernels that shade: K4 (bounce_megakernel.cu)
// and K7 (legacy_scatter.cu).
//
// Exact-rounding f32 arithmetic, 3-vectors, the counter RNG of core/rng.py
// on uint32, and the sampling functions both kernels call
// (bsdf/sampling.py, operation for operation). Every operation rounds on
// its own: the __f*_rn intrinsics are never contracted into FMAs (the
// kernels are also built with -fmad=false), 3-sums run as (x + y) + z
// (sampling.sum3), sqrt and division are IEEE, and sinf/cosf are the CUDA
// math library's, which torch.sin and torch.cos call on the card. So each
// helper rounds like the plain PyTorch ops it stands for.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lpt {

constexpr float kTwoPi = 6.283185307179586f;        // f32 of sampling.TWO_PI
constexpr float kInv2p24 = 5.9604644775390625e-08f;  // 2**-24
constexpr uint32_t kGolden = 0x9E3779B9u;

// ------------------------------------------------------------ arithmetic --

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// torch.clamp_min / torch.clamp on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
__device__ __forceinline__ V3 vmul(V3 a, V3 b) {
  return {mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z)};
}
__device__ __forceinline__ V3 vscale(float s, V3 a) {
  return {mul(s, a.x), mul(s, a.y), mul(s, a.z)};
}
__device__ __forceinline__ V3 vsel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float sum3(V3 v) { return add(add(v.x, v.y), v.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return sum3(vmul(a, b)); }

// sampling.normalize: v / sqrt(sum3(v*v)), the norm clamped below by eps
// when eps > 0
__device__ __forceinline__ V3 normalize(V3 v, float eps) {
  float n = sqrt_rn(dot(v, v));
  if (eps > 0.f) n = clamp_min(n, eps);
  return {dvd(v.x, n), dvd(v.y, n), dvd(v.z, n)};
}

// ------------------------------------------------------------------- rng --
// core/rng.py on uint32: PCG-RXS-M-XS and the boost-style fold

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  const uint32_t word = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (word >> 22u) ^ word;
}

__device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t v) {
  return pcg(h ^ (v + kGolden + (h << 6u) + (h >> 2u)));
}

// rng.uniform(base, dim)
__device__ __forceinline__ float uniform(uint32_t base, uint32_t dim) {
  return mul((float)(pcg(base + dim * kGolden) >> 8u), kInv2p24);
}

// -------------------------------------------------------------- sampling --

__device__ __forceinline__ V3 sample_at_sphere(float u1, float u2) {
  const float z = sub(1.f, mul(2.f, u1));
  const float r = sqrt_rn(clamp_min(sub(1.f, mul(z, z)), 0.f));
  const float theta = mul(kTwoPi, u2);
  return {mul(r, cosf(theta)), mul(r, sinf(theta)), z};
}

__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return vsub(d, vscale(mul(2.f, dot(d, n)), n));
}

__device__ __forceinline__ float schlick(float cos_theta, float f0) {
  const float c = clamp_min(cos_theta, 0.f);
  const float m = sub(1.f, c);
  const float m2 = mul(m, m);
  return add(f0, mul(sub(1.f, f0), mul(mul(m2, m2), m)));
}

}  // namespace lpt
