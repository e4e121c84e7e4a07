// Sphere-scan nearest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel learn_path_tracing_tpu/ops/sphere_scan.py::_kernel
// (entry intersect_spheres_pallas). For each ray it finds the nearest sphere
// over the whole table in exact f32, then copies that sphere's attribute row.
//
// Math, per (ray, sphere), in this order and with every operation rounded on
// its own (the __f*_rn intrinsics are never contracted into FMAs, and the
// library is also built with -fmad=false):
//   oc = ro - c;  half_b = -(oc.rd);  c0 = oc.oc - r2;  disc = half_b^2 - c0
//   sq = sqrt(disc) (IEEE);  t = half_b - sq, or half_b + sq for a
//   transparent sphere (flag > 1.5) whose near root is below t_min.
// A miss or a padding row (r2 = -inf) gives disc < 0 and sq = NaN; every
// compare with NaN is false, so it never passes t >= t_min. The best hit
// is replaced only on t < t_best, so the first index wins ties. Misses keep
// t = +inf and idx = 0; callers mask with isfinite(t). This is the same
// sequence as the plain PyTorch twin in ops/sphere_scan.py, so the two agree
// bit for bit.
//
// Design: one thread per ray. Each block stages the sphere table through
// shared memory in chunks of kChunk spheres (20 bytes each: 20 KB), and every
// thread walks the chunk; all threads of a warp read the same sphere, so the
// shared-memory reads are broadcasts. The epilogue reads the winner's 16-float
// attribute row as four 16-byte loads and writes it the same way.
//
// Bound: FP32 ALU work. On the main path a full pass is 57,344 rays x 512
// spheres = 29 M ray-sphere pairs at about 20 FLOP and one sqrt each; the
// bytes moved (rays in, t/idx/attr out, a 16 KB table per block) are
// trivial. The TPU kernel's [sphere, ray] VMEM tiling and its bf16 one-hot
// epilogue are not carried over. This version is written to be right;
// tensor cores, TMA and tuning are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;   // spheres staged per shared-memory pass
constexpr int kTableCols = 8;  // cx, cy, cz, r2, flag, 3 unused
constexpr int kAttr = 16;      // attribute floats per sphere

__global__ void __launch_bounds__(kThreads)
sphere_scan_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ table,
                   const float4* __restrict__ attrs,
                   float* __restrict__ t_out, int* __restrict__ idx_out,
                   float4* __restrict__ attr_out, int n, int s, float t_min) {
  __shared__ float4 sph[kChunk];   // cx, cy, cz, r2
  __shared__ float flag[kChunk];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    ox = ro[3 * i + 0]; oy = ro[3 * i + 1]; oz = ro[3 * i + 2];
    dx = rd[3 * i + 0]; dy = rd[3 * i + 1]; dz = rd[3 * i + 2];
  }

  float t_best = INFINITY;
  int idx_best = 0;
  for (int s0 = 0; s0 < s; s0 += kChunk) {
    const int sc = min(kChunk, s - s0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < sc; j += kThreads) {
      const float* row = table + (size_t)(s0 + j) * kTableCols;
      sph[j] = make_float4(row[0], row[1], row[2], row[3]);
      flag[j] = row[4];
    }
    __syncthreads();

    for (int j = 0; j < sc; ++j) {
      const float4 c = sph[j];
      const float ocx = __fsub_rn(ox, c.x);
      const float ocy = __fsub_rn(oy, c.y);
      const float ocz = __fsub_rn(oz, c.z);
      const float half_b = -__fadd_rn(
          __fadd_rn(__fmul_rn(ocx, dx), __fmul_rn(ocy, dy)), __fmul_rn(ocz, dz));
      const float c0 = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                    __fmul_rn(ocz, ocz)),
          c.w);
      const float disc = __fsub_rn(__fmul_rn(half_b, half_b), c0);
      const float sq = __fsqrt_rn(disc);
      const float t_near = __fsub_rn(half_b, sq);
      const bool use_far = (t_near < t_min) && (flag[j] > 1.5f);
      const float t = use_far ? __fadd_rn(half_b, sq) : t_near;
      if (t >= t_min && t < t_best) {
        t_best = t;
        idx_best = s0 + j;
      }
    }
  }

  if (active) {
    t_out[i] = t_best;
    idx_out[i] = idx_best;
    const float4* a = attrs + (size_t)idx_best * (kAttr / 4);
    float4* o = attr_out + (size_t)i * (kAttr / 4);
#pragma unroll
    for (int q = 0; q < kAttr / 4; ++q) o[q] = a[q];
  }
}

}  // namespace

// Plain C entry for ctypes. ro, rd: f32[n,3]; table: f32[s,8]; attrs:
// f32[s,16]; t_out: f32[n]; idx_out: i32[n]; attr_out: f32[n,16]; all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success) without synchronising.
extern "C" int lpt_sphere_scan(const void* ro, const void* rd,
                               const void* table, const void* attrs,
                               void* t_out, void* idx_out, void* attr_out,
                               int n, int s, float t_min, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  sphere_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ro, (const float*)rd, (const float*)table,
      (const float4*)attrs, (float*)t_out, (int*)idx_out, (float4*)attr_out,
      n, s, t_min);
  return (int)cudaGetLastError();
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
