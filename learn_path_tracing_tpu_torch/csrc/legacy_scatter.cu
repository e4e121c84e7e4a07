// The legacy BSDF's scatter (K7) for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fuses bsdf/bsdf.py::
// scatter_legacy, with the PCG hashes of its uniforms, into one fusion.
// Issued op by op in PyTorch it is ~300 eager ops over every lane, most of
// them the int64 arithmetic of seven hashes, and the host's time to issue
// them, not the card, set the pace of the wavefront and hybrid integrators.
// K7 is the whole call in one launch: one thread a lane, every
// intermediate in registers.
//
// Per lane, from its ray (direction, throughput), its hit (point, shading
// normal) and gathered material (albedo, roughness, metallic, ior,
// transparency, absorptivity) and its base hash (rng.base, int64 holding a
// uint32), it writes scatter_legacy's next origin, direction and
// throughput:
//   u_metal = U(0); a point on the sphere from U(1), U(2); the in-ball
//   radius max(U(3), U(5), U(6)); u_fresnel = U(4);
//   metal (u_metal < metallic): tinted Schlick, the mirror direction about
//   the normal roughened by the in-ball jitter;
//   dielectric: transmit (u_fresnel > Schlick of the scalar F0) to the
//   roughened clamped refraction when transparent, else to the Lambertian
//   direction, both attenuated by albedo * (1 - absorptivity); otherwise
//   the roughened mirror with the throughput unchanged;
//   origin = point + 2e-4 * normal.
// Every lane is computed, live or not, as the twin does; the callers
// select.
//
// Arithmetic: the plain twin's operations (bsdf/bsdf.py::
// scatter_legacy_plain) in its order, each rounded on its own
// (bsdf_common.cuh); Python constants round to f32 as PyTorch's CUDA
// kernels take them. 3-sums run as (x + y) + z (sampling.sum3), but for the
// twin's one torch.sum(..., dim=-1), cos_theta: PyTorch's CUDA reduction
// gives a row of three two threads, one adding x and z, the other y, then
// adds the two partial sums, so (x + z) + y. (Each thread starts from +0,
// which turns a -0 term into +0; a zero cos_theta of either sign gives the
// same Schlick terms, so that is left out.)
//
// Bound: memory. A lane reads 88 bytes (five f32 rows of 3, five f32
// scalars, the int64 hash) and writes 36: 124 bytes, 28.6 MB for the
// 230,400 lanes of a 640x360 pass, 8.5 us at 3.35 TB/s. Its ~250 FP32
// operations (seven hashes, sinf/cosf, three normalisations, two
// divisions) take a few microseconds at 67 TFLOP/s.
//
// Design: one thread a lane, 256 threads a block; a row of 3 is read as
// three floats, so a warp reads 384 contiguous bytes of each row array
// (whole sectors) and writes the same.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsdf_common.cuh"

namespace {

using namespace lpt;  // bsdf_common.cuh

constexpr int kThreads = 256;
constexpr float kOriginOffset = 2e-4f;  // f32 of the twin's 2.0 * 1e-4
constexpr float kNormEps = 1e-12f;

struct Args {
  const float* rd;            // f32[n,3]
  const float* thp;           // f32[n,3]
  const float* point;         // f32[n,3]
  const float* nrm;           // f32[n,3]
  const float* albedo;        // f32[n,3]
  const float* roughness;     // f32[n]
  const float* metallic;      // f32[n]
  const float* ior;           // f32[n]
  const float* transparency;  // f32[n]
  const float* absorptivity;  // f32[n]
  const long long* base;      // i64[n], each in [0, 2**32)
  float* ro_out;              // f32[n,3]
  float* rd_out;              // f32[n,3]
  float* thp_out;             // f32[n,3]
  long long n;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// sampling.refract_legacy: the perpendicular part's squared length clamped
// to 1 (torch.clamp_max: NaN passes through) instead of a TIR fallback
__device__ __forceinline__ V3 refract_legacy(V3 d, V3 n, float ior) {
  const float k = dot(d, n);
  const V3 r_perp = {dvd(sub(d.x, mul(k, n.x)), ior), dvd(sub(d.y, mul(k, n.y)), ior),
                     dvd(sub(d.z, mul(k, n.z)), ior)};
  float p2 = dot(r_perp, r_perp);
  p2 = isnan(p2) ? p2 : fminf(p2, 1.f);
  const float kk = sqrt_rn(clamp_min(sub(1.f, p2), 0.f));
  return vsub(r_perp, vscale(kk, n));
}

// the twin's _roughen: normalize(direction + roughness * ball, eps=1e-12)
__device__ __forceinline__ V3 roughen(V3 direction, float roughness, V3 ball) {
  return normalize(vadd(direction, vscale(roughness, ball)), kNormEps);
}

__global__ void __launch_bounds__(kThreads) legacy_scatter_kernel(Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const V3 d = load3(a.rd, i);
  const V3 thp = load3(a.thp, i);
  const V3 nrm = load3(a.nrm, i);
  const V3 alb = load3(a.albedo, i);
  const float rough = a.roughness[i];
  const float ior = a.ior[i];
  const uint32_t base = (uint32_t)a.base[i];

  const float u_metal = uniform(base, 0);
  const float u1 = uniform(base, 1), u2 = uniform(base, 2), u3 = uniform(base, 3);
  const float u_fresnel = uniform(base, 4);
  const float u4 = uniform(base, 5), u5 = uniform(base, 6);

  const V3 s_sphere = sample_at_sphere(u1, u2);
  const V3 ball = vscale(fmaxf(u3, fmaxf(u4, u5)), s_sphere);  // sampling.ball_radius

  // torch.sum(nrm * -d, dim=-1) on the card: (x + z) + y (see the header)
  const V3 p = vmul(nrm, V3{-d.x, -d.y, -d.z});
  const float cos_theta = clamp_min(add(add(p.x, p.z), p.y), 0.f);
  const V3 rd_reflect = roughen(reflect(d, nrm), rough, ball);

  // metal
  const V3 l_metal = {mul(thp.x, schlick(cos_theta, alb.x)),
                      mul(thp.y, schlick(cos_theta, alb.y)),
                      mul(thp.z, schlick(cos_theta, alb.z))};

  // dielectric
  const float q = dvd(sub(ior, 1.f), add(ior, 1.f));
  const float f_diel = schlick(cos_theta, mul(q, q));
  const V3 rd_refract = roughen(refract_legacy(d, nrm, ior), rough, ball);
  const V3 rd_diffuse = normalize(vadd(nrm, s_sphere), kNormEps);
  const float keep = sub(1.f, a.absorptivity[i]);
  const V3 attenuation = {mul(alb.x, keep), mul(alb.y, keep), mul(alb.z, keep)};
  const bool transmit = u_fresnel > f_diel;
  const bool is_transparent = a.transparency[i] > 0.f;
  const V3 rd_nonspec = vsel(is_transparent, rd_refract, rd_diffuse);
  const V3 rd_diel = vsel(transmit, rd_nonspec, rd_reflect);
  const V3 l_diel = vsel(transmit, vmul(thp, attenuation), thp);

  const bool is_metal = u_metal < a.metallic[i];
  store3(a.ro_out, i, vadd(load3(a.point, i), vscale(kOriginOffset, nrm)));
  store3(a.rd_out, i, vsel(is_metal, rd_reflect, rd_diel));
  store3(a.thp_out, i, vsel(is_metal, l_metal, l_diel));
}

}  // namespace

// Plain C entry for ctypes. rd, thp, point, nrm, albedo: f32[n,3];
// roughness, metallic, ior, transparency, absorptivity: f32[n]; base:
// i64[n]; ro_out, rd_out, thp_out: f32[n,3]. All contiguous on the current
// device. Launches on `stream` and returns cudaGetLastError() (0 on
// success) without synchronising.
extern "C" int lpt_legacy_scatter(const void* rd, const void* thp, const void* point,
                                  const void* nrm, const void* albedo, const void* roughness,
                                  const void* metallic, const void* ior,
                                  const void* transparency, const void* absorptivity,
                                  const void* base, void* ro_out, void* rd_out, void* thp_out,
                                  long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  Args a;
  a.rd = (const float*)rd;
  a.thp = (const float*)thp;
  a.point = (const float*)point;
  a.nrm = (const float*)nrm;
  a.albedo = (const float*)albedo;
  a.roughness = (const float*)roughness;
  a.metallic = (const float*)metallic;
  a.ior = (const float*)ior;
  a.transparency = (const float*)transparency;
  a.absorptivity = (const float*)absorptivity;
  a.base = (const long long*)base;
  a.ro_out = (float*)ro_out;
  a.rd_out = (float*)rd_out;
  a.thp_out = (float*)thp_out;
  a.n = n;
  const long long blocks = (n + kThreads - 1) / kThreads;
  legacy_scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
