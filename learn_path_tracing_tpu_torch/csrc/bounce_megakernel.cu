// Fused persistent bounce pass (the mega engine) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel learn_path_tracing_tpu/ops/bounce_megakernel.py::
// _kernel (entry bounce_pass). One thread runs one listed lane of the
// persistent integrator's mega schedule through one whole pass, with every
// intermediate in registers:
//   1. the nearest sphere over the whole table (K1's exact pair test,
//      sphere_pair.cuh);
//   2. the winner's attribute row, its outward normal and the back-face
//      flip (scene/world.py::hit);
//   3. the escaped ray's sky radiance times its throughput (the contrib
//      rows), optionally deposited into the render's int64 fixed-point
//      accumulator with one 64-bit atomic add per channel;
//   4. scatter_modern (bsdf/bsdf.py) from the BSDF stream of (seed, sample,
//      bounce, pixel);
//   5. the work-item advance and the thin-lens primary ray of the next item
//      (camera/camera.py::thin_lens_rays);
//   6. the select of the next state, written in place, and the lane's entry
//      in the next pass's lane list.
//
// State (the JAX package's layout, lane = column, row-major):
//   stf f32[16,n]: 0-2 ro, 3-5 rd, 6-8 throughput, 9 alive (1/0),
//                  10-12 contrib (written; input ignored), 13-15 zero
//   sti i32[8,n]:  0 k (work-item counter), 1 bounce, 2 nearest sphere of
//                  the pass's ray (-1 on a miss or a dead lane), 3-7 zero
// Lane L serves group g = L / spp and sample L % spp; its item k is pixel
// g + k * (n / spp).
//
// Arithmetic: every operation is the plain PyTorch twin's
// (ops/bounce_megakernel.py::bounce_pass_plain), in its order, each rounded
// on its own: the __f*_rn intrinsics are never contracted into FMAs, 3-sums
// run as (x + y) + z (bsdf/sampling.py::sum3), sqrt and division are IEEE,
// and sinf/cosf/acosf are the CUDA math library's, which torch.sin, cos and
// acos call on the card. Two rules follow PyTorch's CUDA kernels: a tensor
// divided by a Python number is multiplied by its f32 reciprocal (the
// camera's "/ w" and "/ h"), and clamp lets NaN through.
//
// Not carried over from the TPU kernel: the expanded quadratic on the MXU
// (o.o - 2 o.c + c.c - r^2, ill-conditioned on the r = 10000 ground; the
// scan here is K1's oc = ro - c form over the world's K1 tables), the
// one-hot MXU attribute gather (a row load), the polynomial acos (|err| <=
// 6.7e-5, Mosaic has no acos) and the direct slerp (sampling.slerp's
// angle-difference form). So the pass computes the modular engine's
// per-sample values.
//
// Bound: FP32 ALU work of the scan (spheres x live lanes, ~20 operations a
// pair, no FMA under exact rounding); the shading is ~300 operations per
// live lane, and the state traffic at most 52 bytes in and 100 out per
// listed lane.
//
// Design: a pass runs over a compacted list of lanes, one thread per
// listed lane, 256 threads per block, in place. A lane that is dead on
// entry never lives again (alive' = survived || regen, and a dead lane has
// neither), so the list only shrinks. The pass writes the next list: the
// lanes alive after it at the front, and at the back, once, the lanes that
// died in it; so a lane stays listed for one pass after its death, writes
// the rows the plain version gives a dead lane (contrib 0, sphere -1,
// bounce 0), and drops out. Every later pass would rewrite those same rows,
// so the whole state stays the plain version's after every pass. Entries
// are appended with one atomic add per warp (warp-aggregated); the order
// within the list is free, since each lane's arithmetic is its own and the
// deposits are integer adds. Alive lanes first keep the warps of the scan
// uniform: a warp pays the scan only if a lane of it is alive, and only
// the one warp at the boundary mixes the two. Each block with a live lane
// stages the sphere table through shared memory in chunks of kChunk spheres
// (20 KB) and every live thread walks the chunk (broadcast reads) with
// sphere_pair.cuh's grouped scan; the sqrt runs only where disc >= 0. K1's
// warp teams over sphere slices are not used: on the H100 the passes that
// list under a tenth of the lanes, where they would help, took under 5 % of
// the K4 time of a mega frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsdf_common.cuh"
#include "sphere_pair.cuh"

namespace {

using namespace lpt;  // bsdf_common.cuh

constexpr int kThreads = 256;
constexpr int kChunk = 1024;    // spheres staged per shared-memory pass
constexpr int kTableCols = 8;   // cx, cy, cz, r2, flag, 3 unused
constexpr int kAttr = 16;       // attribute floats per sphere

// state rows
constexpr int kRo = 0, kRd = 3, kThp = 6, kAlive = 9, kContrib = 10, kStfRows = 16;
constexpr int kK = 0, kBounce = 1, kObj = 2, kStiRows = 8;
// attribute columns (scene/world.py)
constexpr int kC0 = 0, kAlb0 = 4, kRough = 7, kMetal = 8, kIor = 9, kTransp = 10;
// camera vector (ops/bounce_megakernel.py::pack_camera)
constexpr int kPos = 0, kDir = 3, kWa = 6, kHa = 9, kVw = 12, kVh = 13, kHalfAp = 14,
              kFocal = 15;

constexpr float kFixedOne = 4294967296.0f;  // accumulator units (2**32)

constexpr uint32_t kSeedXor = 0x6C078965u;
constexpr uint32_t kBounceMix = 2654435761u;
constexpr uint32_t kStreamCamera = 0u, kStreamBsdf = 1u;

// ------------------------------------------------------------------- rng --

// rng.base(rng.stream(seed, sample, bounce, stream_id), pixel), from the
// seed's first hash
__device__ __forceinline__ uint32_t rng_base(uint32_t seed_h, uint32_t sample,
                                             uint32_t bounce, uint32_t stream_id,
                                             uint32_t pixel) {
  const uint32_t h = fold(fold(seed_h, sample), bounce * kBounceMix + stream_id);
  return fold(h, pixel);
}

// -------------------------------------------------------------- sampling --
// bsdf/sampling.py, operation for operation (the rest in bsdf_common.cuh)

__device__ __forceinline__ V3 sample_lambertian(V3 n, float u1, float u2) {
  return normalize(vadd(n, sample_at_sphere(u1, u2)), 1e-12f);
}

__device__ __forceinline__ V3 slerp(V3 a, V3 b, float t) {
  const float cosw = clamp(dot(a, b), -1.f, 1.f);
  const float omega = acosf(cosw);
  const float so = sqrt_rn(clamp_min(sub(1.f, mul(cosw, cosw)), 0.f));
  const bool small = so < 1e-6f;
  const float safe_so = small ? 1.f : so;
  const float tw = mul(t, omega);
  const float sin_tw = sinf(tw);
  const float cos_tw = cosf(tw);
  const float s_a = sub(cos_tw, dvd(mul(cosw, sin_tw), safe_so));
  const float s_b = dvd(sin_tw, safe_so);
  const V3 lin = vadd(vscale(sub(1.f, t), a), vscale(t, b));
  const V3 sph = vadd(vscale(s_a, a), vscale(s_b, b));
  return normalize(vsel(small, lin, sph), 1e-12f);
}

__device__ __forceinline__ V3 refract(V3 d, V3 n, float ior) {
  const float k = dot(d, n);
  const V3 r_perp = {dvd(sub(d.x, mul(k, n.x)), ior), dvd(sub(d.y, mul(k, n.y)), ior),
                     dvd(sub(d.z, mul(k, n.z)), ior)};
  const float p2 = dot(r_perp, r_perp);
  const float kk = sqrt_rn(clamp_min(sub(1.f, p2), 0.f));
  const V3 refracted = vsub(r_perp, vscale(kk, n));
  return p2 > 1.f ? reflect(d, n) : refracted;
}

// ---------------------------------------------------------------- kernel --

struct Args {
  float* stf;           // f32[16,n], updated in place for the listed lanes
  int* sti;             // i32[8,n], likewise
  const float* table;   // f32[s,8]
  const float* attrs;   // f32[s,16]
  const float* cam;     // f32[16]
  unsigned long long* acc;  // i64[n,3] fixed point, or null
  const int* lanes;     // i32[count]: the lanes of this pass
  int* next;            // i32[alive_in]: the lanes of the next pass
  int* counters;        // i32[2]: lanes alive after the pass, lanes that died
                        // in it; zeroed before the launch
  int count, alive_in;  // listed lanes; those alive on entry
  int n, s, spp, w, h, limit;
  float t_min;
  uint32_t seed;
};

// Steps 2-6 for one listed lane, after the scan; returns whether the lane
// is alive after the pass.
__device__ __forceinline__ bool shade_and_store(const Args& a, int i, bool alive, V3 ro,
                                                V3 rd, float t_best, int idx_best) {
  const int n = a.n;
  V3 thp = {a.stf[(kThp + 0) * n + i], a.stf[(kThp + 1) * n + i],
            a.stf[(kThp + 2) * n + i]};
  const int k = a.sti[kK * n + i];
  const int bounce = a.sti[kBounce * n + i];
  const int spp = a.spp;
  const int groups = n / spp;
  const int g = i / spp;
  const uint32_t sample = (uint32_t)(i % spp);
  const uint32_t seed_h = pcg(a.seed ^ kSeedXor);

  const bool hit = alive && isfinite(t_best);
  bool survived = false;
  V3 contrib = {0.f, 0.f, 0.f};
  V3 ro_next = ro, rd_next = rd, thp_next = thp;

  if (alive && !hit) {
    // 3. sky_background(rd) * throughput (integrator/wavefront.py)
    const float ts = mul(0.5f, add(rd.y, 1.f));
    const float one_t = sub(1.f, ts);
    contrib = {mul(add(one_t, mul(ts, 0.5f)), thp.x), mul(add(one_t, mul(ts, 0.7f)), thp.y),
               mul(add(one_t, mul(ts, 1.0f)), thp.z)};
    if (a.acc != nullptr) {
      unsigned long long* dst = a.acc + (size_t)(g + k * groups) * 3;
      const float cc[3] = {contrib.x, contrib.y, contrib.z};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const long long q = __float2ll_rn(mul(cc[c], kFixedOne));
        if (q != 0) atomicAdd(dst + c, (unsigned long long)q);
      }
    }
  }

  if (hit) {
    // 2. the hit record (scene/world.py::hit, geometry/sphere.py)
    const float* at = a.attrs + (size_t)idx_best * kAttr;
    const V3 point = vadd(ro, vscale(t_best, rd));
    const V3 v = vsub(point, V3{at[kC0 + 0], at[kC0 + 1], at[kC0 + 2]});
    const float vn = clamp_min(sqrt_rn(dot(v, v)), 1e-20f);
    V3 nrm = {dvd(v.x, vn), dvd(v.y, vn), dvd(v.z, vn)};
    const bool backface = dot(rd, nrm) > 0.f;
    float ior = at[kIor];
    if (backface) {
      nrm = {-nrm.x, -nrm.y, -nrm.z};
      ior = dvd(1.f, clamp_min(ior, 1e-9f));
    }
    const V3 alb = {at[kAlb0 + 0], at[kAlb0 + 1], at[kAlb0 + 2]};
    const float rough = at[kRough];

    // 4. scatter_modern (bsdf/bsdf.py)
    const uint32_t pixel = (uint32_t)(g + k * groups);
    const uint32_t base = rng_base(seed_h, sample, (uint32_t)bounce, kStreamBsdf, pixel);
    const float u1 = uniform(base, 0), u2 = uniform(base, 1);
    const float u_roulette = uniform(base, 2);
    const float u3 = uniform(base, 3), u4 = uniform(base, 4);

    const V3 d = rd;
    // sampling.sample_normal: slerp the mirror direction toward a cosine
    // sample by roughness^2, then the half-way normal
    const V3 s_l = sample_lambertian(nrm, u1, u2);
    const V3 pert = slerp(reflect(d, nrm), s_l, mul(rough, rough));
    const V3 nn = normalize(vsub(pert, d), 1e-12f);
    const float cos_theta = clamp_min(sum3(vmul(nn, V3{-d.x, -d.y, -d.z})), 0.f);

    const bool is_metal = at[kMetal] == 1.f;
    V3 rd_new, thp_new;
    if (is_metal) {
      rd_new = reflect(d, nn);
      thp_new = {mul(thp.x, schlick(cos_theta, alb.x)), mul(thp.y, schlick(cos_theta, alb.y)),
                 mul(thp.z, schlick(cos_theta, alb.z))};
    } else {
      const float q = dvd(sub(ior, 1.f), add(ior, 1.f));
      const float f_diel = schlick(cos_theta, mul(q, q));
      const bool transmit = u_roulette > f_diel;
      if (transmit) {
        rd_new = at[kTransp] > 0.f ? refract(d, nn, ior) : sample_lambertian(nrm, u3, u4);
        thp_new = vmul(thp, alb);
      } else {
        rd_new = reflect(d, nn);
        thp_new = thp;
      }
    }
    survived = bounce + 1 < a.limit;
    if (survived) {
      ro_next = point;
      rd_next = rd_new;
      thp_next = thp_new;
    }
  }

  // 5. work-item advance and the next item's primary ray
  const bool ended = alive && !survived;
  const int next_k = k + (ended ? 1 : 0);
  const bool regen = ended && next_k < spp;
  if (regen) {
    const float* cam = a.cam;
    const int npix = g + next_k * groups;
    const float fi = (float)(npix / a.h);
    const float fj = (float)(npix % a.h);
    const uint32_t cbase = rng_base(seed_h, sample, 0u, kStreamCamera, (uint32_t)npix);
    const float c0 = uniform(cbase, 0), c1 = uniform(cbase, 1);
    const float c2 = uniform(cbase, 2), c3 = uniform(cbase, 3);
    const float inv_w = dvd(1.f, (float)a.w), inv_h = dvd(1.f, (float)a.h);
    const float du = mul(sub(mul(add(fi, c0), inv_w), 0.5f), cam[kVw]);
    const float dv = mul(sub(mul(add(fj, c1), inv_h), 0.5f), cam[kVh]);
    const V3 dir = {cam[kDir + 0], cam[kDir + 1], cam[kDir + 2]};
    const V3 wa = {cam[kWa + 0], cam[kWa + 1], cam[kWa + 2]};
    const V3 ha = {cam[kHa + 0], cam[kHa + 1], cam[kHa + 2]};
    const V3 target = vscale(cam[kFocal], vadd(vadd(dir, vscale(du, wa)), vscale(dv, ha)));
    const float r = sqrt_rn(c2);
    const float theta = mul(kTwoPi, c3);
    const float dx = mul(r, cosf(theta)), dy = mul(r, sinf(theta));
    const V3 origin = vscale(cam[kHalfAp], vadd(vscale(dx, wa), vscale(dy, ha)));
    ro_next = vadd(V3{cam[kPos + 0], cam[kPos + 1], cam[kPos + 2]}, origin);
    rd_next = normalize(vsub(target, origin), 0.f);
    thp_next = {1.f, 1.f, 1.f};
  }
  const bool alive_next = survived || regen;

  // 6. the next state, over the lane's own columns (read above)
  float* so = a.stf;
  so[(kRo + 0) * n + i] = ro_next.x;
  so[(kRo + 1) * n + i] = ro_next.y;
  so[(kRo + 2) * n + i] = ro_next.z;
  so[(kRd + 0) * n + i] = rd_next.x;
  so[(kRd + 1) * n + i] = rd_next.y;
  so[(kRd + 2) * n + i] = rd_next.z;
  so[(kThp + 0) * n + i] = thp_next.x;
  so[(kThp + 1) * n + i] = thp_next.y;
  so[(kThp + 2) * n + i] = thp_next.z;
  so[kAlive * n + i] = alive_next ? 1.f : 0.f;
  so[(kContrib + 0) * n + i] = contrib.x;
  so[(kContrib + 1) * n + i] = contrib.y;
  so[(kContrib + 2) * n + i] = contrib.z;
  for (int r = kContrib + 3; r < kStfRows; ++r) so[r * n + i] = 0.f;
  int* io = a.sti;
  io[kK * n + i] = next_k;
  io[kBounce * n + i] = survived ? bounce + 1 : 0;
  io[kObj * n + i] = hit ? idx_best : -1;
  for (int r = kObj + 1; r < kStiRows; ++r) io[r * n + i] = 0;
  return alive_next;
}

// The slot of this thread's entry among the entries its warp appends to a
// list whose length is `*counter` (one atomic add per warp); every lane of
// the warp calls it, and those with `take` false get an unused value.
__device__ __forceinline__ int warp_append(bool take, int* counter) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (mask == 0u) return 0;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(mask & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kThreads, 2) bounce_pass_kernel(Args a) {
  __shared__ float4 sph[kChunk];  // cx, cy, cz, r2
  __shared__ float flag[kChunk];

  const int n = a.n;
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const bool listed = slot < a.count;
  const int i = listed ? a.lanes[slot] : 0;
  const bool alive = listed && a.stf[kAlive * n + i] > 0.5f;

  V3 ro = {0.f, 0.f, 0.f}, rd = {0.f, 0.f, 0.f};
  if (listed) {
    ro = {a.stf[(kRo + 0) * n + i], a.stf[(kRo + 1) * n + i], a.stf[(kRo + 2) * n + i]};
    rd = {a.stf[(kRd + 0) * n + i], a.stf[(kRd + 1) * n + i], a.stf[(kRd + 2) * n + i]};
  }

  // 1. nearest sphere: K1's pair test (sphere_pair.cuh), live lanes only
  float t_best = INFINITY;
  int idx_best = 0;
  if (__syncthreads_or(alive)) {
    const lpt::ScanRay r = {ro.x, ro.y, ro.z, rd.x, rd.y, rd.z};
    for (int s0 = 0; s0 < a.s; s0 += kChunk) {
      const int sc = min(kChunk, a.s - s0);
      __syncthreads();  // the previous chunk is no longer read
      for (int j = threadIdx.x; j < sc; j += kThreads) {
        const float* row = a.table + (size_t)(s0 + j) * kTableCols;
        sph[j] = make_float4(row[0], row[1], row[2], row[3]);
        flag[j] = row[4];
      }
      __syncthreads();
      if (alive) {
        lpt::scan_range(r, sph, flag, 0, sc, s0, a.t_min, t_best, idx_best);
      }
    }
  }
  bool alive_next = false;
  if (listed) alive_next = shade_and_store(a, i, alive, ro, rd, t_best, idx_best);

  // the next list: lanes alive after the pass from the front, lanes that
  // died in it from the back (once: they are dead on entry next time)
  const bool died = alive && !alive_next;
  const int front = warp_append(alive_next, a.counters);
  const int back = warp_append(died, a.counters + 1);
  if (alive_next) a.next[front] = i;
  if (died) a.next[a.alive_in - 1 - back] = i;
}

}  // namespace

// Plain C entry for ctypes. stf: f32[16,n] and sti: i32[8,n], updated in
// place for the lanes lanes[0:count] (distinct, alive_in of them alive in
// stf); table: f32[s,8]; attrs: f32[s,16]; cam: f32[16]; acc: i64[n,3] or
// null; next: i32[alive_in] or larger, receives the next pass's lanes;
// counters: i32[2]. All contiguous on the current device. Zeroes
// `counters`, launches on `stream` and returns cudaGetLastError() (0 on
// success) without synchronising. After the pass, counters[0] lanes alive
// after it fill next[0:counters[0]] and counters[1] lanes that died in it
// fill the rest of next[0:alive_in].
extern "C" int lpt_bounce_pass(void* stf, void* sti, const void* table, const void* attrs,
                               const void* cam, void* acc, const void* lanes, int count,
                               int alive_in, void* next, void* counters, int n, int s,
                               int spp, int w, int h, int limit, float t_min,
                               unsigned int seed, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (count <= 0) return (int)cudaGetLastError();
  Args a;
  a.stf = (float*)stf;
  a.sti = (int*)sti;
  a.table = (const float*)table;
  a.attrs = (const float*)attrs;
  a.cam = (const float*)cam;
  a.acc = (unsigned long long*)acc;
  a.lanes = (const int*)lanes;
  a.next = (int*)next;
  a.counters = (int*)counters;
  a.count = count;
  a.alive_in = alive_in;
  a.n = n;
  a.s = s;
  a.spp = spp;
  a.w = w;
  a.h = h;
  a.limit = limit;
  a.t_min = t_min;
  a.seed = seed;
  const int blocks = (count + kThreads - 1) / kThreads;
  bounce_pass_kernel<<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
