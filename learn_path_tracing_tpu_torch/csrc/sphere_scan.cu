// Sphere-scan nearest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel learn_path_tracing_tpu/ops/sphere_scan.py::_kernel
// (entry intersect_spheres_pallas). For each ray it finds the nearest sphere
// over the whole table in exact f32, then copies that sphere's attribute row.
// The pair arithmetic is sphere_pair.cuh's (shared with K4). Misses keep
// t = +inf and idx = 0; callers mask with isfinite(t).
//
// Bound: FP32 ALU work. On the main path a full pass is 57,344 rays x 512
// spheres = 29 M ray-sphere pairs at about 20 operations each; the bytes
// moved (rays in, t/idx/attr out, the table) are trivial. Exact rounding
// rules out FMAs, so every operation takes an issue slot of its own.
//
// Design: warp teams over sphere slices. A block holds `teams` groups of
// 32 rays; each group is scanned by `slices` warps (P, chosen by the
// wrapper from the ray and sphere counts, ops/sphere_scan.py::team_slices),
// warp w taking slice w mod P of every shared-memory chunk of the table
// (contiguous index ranges, scanned in increasing order). All lanes of a
// warp read the same sphere, so the shared-memory loads are broadcasts and
// the loop bounds are warp-uniform. Each warp keeps the serial rule's best
// (t, idx) of its slice; the P partial results are then reduced in shared
// memory as a tree to the lexicographically least (t, idx). That equals
// the serial scan's result: only t >= t_min is a candidate, the serial
// scan keeps the least t, and among equal t the first index, which is the
// least. A wide pass (57,344 rays) takes few slices and fills the card with
// ray groups; a drain pass (256 rays) takes 32 slices of 16 spheres, so its
// few rays still spread over 32 warps each. The sqrt runs only for pairs
// with disc >= 0 (see sphere_pair.cuh). The epilogue copies the winners'
// 64-byte attribute rows as 16-byte quarters, one quarter a thread.
//
// The TPU kernel's [sphere, ray] VMEM tiling and its bf16 one-hot epilogue
// are not carried over.

#include <cuda_runtime.h>
#include <math.h>

#include "sphere_pair.cuh"

namespace {

constexpr int kChunk = 1024;       // spheres staged per shared-memory pass
constexpr int kTableCols = 8;      // cx, cy, cz, r2, flag, 3 unused
constexpr int kAttrQuarters = 4;   // 16 attribute floats per sphere, as float4
constexpr int kMinWarps = 8;       // a block has max(kMinWarps, slices) warps
constexpr int kMaxSlices = 32;
constexpr int kMaxThreads = 32 * kMaxSlices;
constexpr int kMaxRays = 32 * kMinWarps;   // rays of a block (slices = 1)

__global__ void __launch_bounds__(kMaxThreads)
sphere_scan_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ table,
                   const float4* __restrict__ attrs,
                   float* __restrict__ t_out, int* __restrict__ idx_out,
                   float4* __restrict__ attr_out, int n, int s, float t_min, int slices) {
  __shared__ float4 sph[kChunk];   // cx, cy, cz, r2
  __shared__ float flag[kChunk];
  __shared__ float part_t[kMaxThreads];
  __shared__ int part_i[kMaxThreads];
  __shared__ int winner[kMaxRays];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = warp / slices;
  const int slice = warp - team * slices;
  const int rays = (blockDim.x >> 5) / slices * 32;   // rays of this block
  const int ray0 = blockIdx.x * rays;
  const int i = ray0 + team * 32 + lane;
  const bool active = i < n;
  lpt::ScanRay r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    r = {ro[3 * i + 0], ro[3 * i + 1], ro[3 * i + 2],
         rd[3 * i + 0], rd[3 * i + 1], rd[3 * i + 2]};
  }

  float t_best = INFINITY;
  int idx_best = 0;
  for (int s0 = 0; s0 < s; s0 += kChunk) {
    const int sc = min(kChunk, s - s0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < sc; j += blockDim.x) {
      const float* row = table + (size_t)(s0 + j) * kTableCols;
      sph[j] = make_float4(row[0], row[1], row[2], row[3]);
      flag[j] = row[4];
    }
    __syncthreads();
    const int per = (sc + slices - 1) / slices;
    lpt::scan_range(r, sph, flag, slice * per, min((slice + 1) * per, sc), s0, t_min, t_best,
                    idx_best);
  }

  // the slices' (t, idx), reduced as a tree to the lexicographic least
  // (thread k holds slice k / 32 % slices of its team's rays; its partner
  // at each level is the thread `half` warps on)
  part_t[threadIdx.x] = t_best;
  part_i[threadIdx.x] = idx_best;
  for (int half = slices >> 1; half > 0; half >>= 1) {
    __syncthreads();  // the previous level's partial results are written
    if (slice < half) {
      const float t = part_t[threadIdx.x + half * 32];
      const int j = part_i[threadIdx.x + half * 32];
      if (t < t_best || (t == t_best && j < idx_best)) {
        t_best = t;
        idx_best = j;
        part_t[threadIdx.x] = t;
        part_i[threadIdx.x] = j;
      }
    }
  }
  if (slice == 0) {
    winner[team * 32 + lane] = idx_best;
    if (active) {
      t_out[i] = t_best;
      idx_out[i] = idx_best;
    }
  }
  __syncthreads();

  // the winners' attribute rows, a 16-byte quarter a thread
  for (int q = threadIdx.x; q < rays * kAttrQuarters; q += blockDim.x) {
    const int k = q / kAttrQuarters, part = q % kAttrQuarters;
    if (ray0 + k < n) {
      attr_out[(size_t)(ray0 + k) * kAttrQuarters + part] =
          attrs[(size_t)winner[k] * kAttrQuarters + part];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. ro, rd: f32[n,3]; table: f32[s,8]; attrs:
// f32[s,16]; t_out: f32[n]; idx_out: i32[n]; attr_out: f32[n,16]; all
// contiguous on the current device. `slices` (1, 2, 4, 8, 16 or 32) is the
// number of warps that share each group of 32 rays. Launches on `stream`
// and returns cudaGetLastError() (0 on success) without synchronising.
extern "C" int lpt_sphere_scan(const void* ro, const void* rd,
                               const void* table, const void* attrs,
                               void* t_out, void* idx_out, void* attr_out,
                               int n, int s, float t_min, int slices, void* stream) {
  if (slices < 1 || slices > kMaxSlices || (slices & (slices - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int warps = slices > kMinWarps ? slices : kMinWarps;
  const int rays = warps / slices * 32;
  const int blocks = (n + rays - 1) / rays;
  sphere_scan_kernel<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const float*)ro, (const float*)rd, (const float*)table,
      (const float4*)attrs, (float*)t_out, (int*)idx_out, (float4*)attr_out,
      n, s, t_min, slices);
  return (int)cudaGetLastError();
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
