// Nearest hit over an 8-wide BVH for NVIDIA Hopper (sm_90a): kernels K2
// (triangle leaves) and K3 (sphere leaves), one template.
//
// Replaces the TPU kernel learn_path_tracing_tpu/ops/packet_traverse.py::
// _kernel_v2 (leaf_kind 'tri' and 'sphere'; entries packet_traverse and
// packet_traverse_sorted). It reads the same tables (nodes f32[M,128],
// entries i32[M,128], runs f32[R,128]; layout in ops/packet_traverse.py) and
// computes what that kernel computes, with an order-free tie rule.
//
// Design: the TPU walks ONE stack per 1024-ray packet on its scalar core and
// tests every node against all lanes of the packet. Here every thread walks
// its own ray with a private stack in local memory (the reference's
// per-thread walk): pop an entry, drop it if its entry distance is no longer
// < t_best + eps, slab-test the node's 8 children, test the entered leaf
// children at once nearest first, and push the entered node children so
// that the nearest pops first. Leaves never touch the stack, so it holds at
// most 1 + 7*depth entries; the wrapper passes that bound (stack_cap) and
// the kernel reports an overflow, or reaching the max_iters pop backstop,
// in *err instead of truncating.
//
// Arithmetic: every operation is an explicitly rounded __f*_rn intrinsic
// (and the library is built with -fmad=false), in the order of the plain
// PyTorch twin packet_traverse_plain, so the two agree bit for bit:
//   slab   t = lo*inv - ro*inv, inv = 1/rd, NaN-propagating min/max,
//          entered if t1 > t0 - eps, t1 > 0 and t0 < t_best + eps;
//   tri    t = (d - ro.n)/(rd.n), w1 = (ro.g1 + t*(rd.g1)) + c1, w2 alike,
//          w3 = (1 - w1) - w2, hit if t > eps and all w > 0;
//   sphere oc = ro - c, hb = oc.rd, disc = hb*hb - (oc.oc - r2),
//          t = -hb - sqrt(max(disc, 0)), or -hb + sqrt(..) for flag 2 when
//          the near root is < eps; hit if disc >= 0 and t > eps.
// Tie rule: a candidate wins on strictly smaller t, or equal t and a
// smaller prim id, so the result is the least (t, prim) over all tested
// primitives whatever the visiting order.
//
// Bound: latency of dependent loads (node row, then the run rows it names)
// and divergence between the rays of a warp; the tables of a 23k-triangle
// mesh are a few MB and stay resident in the 50 MB L2, read through the
// read-only path (__ldg). This version is written to be right; the render
// path traverses rays in lane order (a coherence sort in front of the kernel
// cost more than it saved), and treelet restart, shared-memory staging and
// occupancy tuning are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWidth = 8;
constexpr int kRowF = 128;        // floats per table row
constexpr int kMaxStack = 256;    // per-thread stack (ops MAX_STACK)
constexpr int kPad = -(1 << 30);  // empty child slot
constexpr int kEnc = 64;          // run-length field of a leaf code
constexpr int kPrimCol = 96;      // prim ids of a run row
constexpr int kErrStack = 1;
constexpr int kErrIters = 2;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// Test slots [0, nslots) of one run row; fold hits into (tb, pb).
template <int kSphere>
__device__ __forceinline__ void test_run(const float* __restrict__ row,
                                         int nslots, const float o[3],
                                         const float d[3], float eps,
                                         float& tb, int& pb) {
  for (int j = 0; j < nslots; ++j) {
    float t;
    bool ok;
    if (kSphere) {
      const float ocx = __fsub_rn(o[0], __ldg(row + 0 * kWidth + j));
      const float ocy = __fsub_rn(o[1], __ldg(row + 1 * kWidth + j));
      const float ocz = __fsub_rn(o[2], __ldg(row + 2 * kWidth + j));
      const float r2 = __ldg(row + 3 * kWidth + j);
      const float flag = __ldg(row + 4 * kWidth + j);
      const float hb = dot3(ocx, ocy, ocz, d[0], d[1], d[2]);
      const float cterm = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), r2);
      const float disc = __fsub_rn(__fmul_rn(hb, hb), cterm);
      const float sq = __fsqrt_rn(disc > 0.f ? disc : 0.f);
      const float t_near = __fsub_rn(-hb, sq);
      t = (t_near < eps && flag > 1.5f) ? __fadd_rn(-hb, sq) : t_near;
      ok = disc >= 0.f && t > eps;
    } else {
      float c[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) c[k] = __ldg(row + k * kWidth + j);
      const float denom = dot3(d[0], d[1], d[2], c[0], c[1], c[2]);
      const float ron = dot3(o[0], o[1], o[2], c[0], c[1], c[2]);
      t = __fdiv_rn(__fsub_rn(c[3], ron), denom);
      const float w1 = __fadd_rn(
          __fadd_rn(dot3(o[0], o[1], o[2], c[4], c[5], c[6]),
                    __fmul_rn(t, dot3(d[0], d[1], d[2], c[4], c[5], c[6]))),
          c[7]);
      const float w2 = __fadd_rn(
          __fadd_rn(dot3(o[0], o[1], o[2], c[8], c[9], c[10]),
                    __fmul_rn(t, dot3(d[0], d[1], d[2], c[8], c[9], c[10]))),
          c[11]);
      const float w3 = __fsub_rn(__fsub_rn(1.f, w1), w2);
      ok = t > eps && w1 > 0.f && w2 > 0.f && w3 > 0.f;
    }
    if (ok) {
      const int pid = (int)__ldg(row + kPrimCol + j);
      if (t < tb || (t == tb && pid < pb)) {
        tb = t;
        pb = pid;
      }
    }
  }
}

template <int kSphere>
__global__ void __launch_bounds__(kThreads)
packet_traverse_kernel(const float* __restrict__ nodes,
                       const int* __restrict__ entries,
                       const float* __restrict__ runs,
                       const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ t_init,
                       const unsigned char* __restrict__ active,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       int* __restrict__ iters_out, int* __restrict__ err,
                       int n, int stack_cap, int max_iters, float eps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float tb = t_init[i];
  int pb = -1;
  int iters = 0;
  if (active[i]) {
    float o[3], d[3], inv[3], roinv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = ro[3 * i + k];
      d[k] = rd[3 * i + k];
      inv[k] = __fdiv_rn(1.f, d[k]);
      roinv[k] = __fmul_rn(o[k], inv[k]);
    }
    int s_code[kMaxStack];
    float s_t[kMaxStack];
    int sp = 0;
    s_code[0] = 0;   // root
    s_t[0] = 0.f;
    while (sp >= 0) {
      if (iters >= max_iters) {
        atomicOr(err, kErrIters);
        break;
      }
      ++iters;
      const int code = s_code[sp];
      const float t_pop = s_t[sp];
      --sp;
      if (!(t_pop < __fadd_rn(tb, eps))) continue;   // stale entry

      const float* __restrict__ box = nodes + (size_t)code * kRowF;
      const int* __restrict__ kid = entries + (size_t)code * kRowF;
      float key[kWidth];
      int ent[kWidth];
      unsigned leaves = 0, inner = 0;
      const float reach = __fadd_rn(tb, eps);
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        ent[c] = __ldg(kid + c);
        float t0 = -INFINITY, t1 = INFINITY;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ta = __fsub_rn(__fmul_rn(__ldg(box + k * kWidth + c), inv[k]),
                                     roinv[k]);
          const float tc = __fsub_rn(
              __fmul_rn(__ldg(box + (3 + k) * kWidth + c), inv[k]), roinv[k]);
          t0 = nan_max(t0, nan_min(ta, tc));
          t1 = nan_min(t1, nan_max(ta, tc));
        }
        key[c] = nan_max(t0, 0.f);
        const bool entered = t1 > __fsub_rn(t0, eps) && t1 > 0.f &&
                             t0 < reach && ent[c] != kPad;
        if (entered) {
          if (ent[c] < 0) leaves |= 1u << c;
          else inner |= 1u << c;
        }
      }

      // leaf children inline, nearest first (ties: lower slot)
      while (leaves) {
        int bc = -1, be = 0;
        float bk = 0.f;
#pragma unroll
        for (int c = 0; c < kWidth; ++c) {
          if (((leaves >> c) & 1u) && (bc < 0 || key[c] < bk)) {
            bc = c;
            bk = key[c];
            be = ent[c];
          }
        }
        leaves &= ~(1u << bc);
        if (!(bk < __fadd_rn(tb, eps))) continue;
        const int v = -(be + 1);
        const int row = v / kEnc, count = v % kEnc;
        test_run<kSphere>(runs + (size_t)row * kRowF, min(count, kWidth), o, d,
                          eps, tb, pb);
        if (count > kWidth)   // fat leaf: spill row
          test_run<kSphere>(runs + (size_t)(row + 1) * kRowF, count - kWidth,
                            o, d, eps, tb, pb);
      }

      // node children, farthest pushed first (ties: higher slot first), so
      // the nearest, lowest slot ends on top
      if (sp + __popc(inner) >= stack_cap) {
        atomicOr(err, kErrStack);
        break;
      }
      while (inner) {
        int bc = -1, be = 0;
        float bk = 0.f;
#pragma unroll
        for (int c = 0; c < kWidth; ++c) {
          if (((inner >> c) & 1u) && (bc < 0 || key[c] >= bk)) {
            bc = c;
            bk = key[c];
            be = ent[c];
          }
        }
        inner &= ~(1u << bc);
        ++sp;
        s_code[sp] = be;
        s_t[sp] = bk;
      }
    }
  }
  t_out[i] = tb;
  prim_out[i] = pb;
  iters_out[i] = iters;
}

}  // namespace

// Plain C entry for ctypes. nodes/entries/runs: the packed tables (f32 / i32
// / f32, 128 columns); ro, rd: f32[n,3]; t_init: f32[n]; active: bool[n]
// (one byte each); t_out: f32[n]; prim_out, iters_out: i32[n]; err: one i32,
// zero on entry (bit 1: stack overflow, bit 2: pop backstop). leaf_kind 0 =
// triangles (K2), 1 = spheres (K3). All contiguous on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success)
// without synchronising.
extern "C" int lpt_packet_traverse(const void* nodes, const void* entries,
                                   const void* runs, const void* ro,
                                   const void* rd, const void* t_init,
                                   const void* active, void* t_out,
                                   void* prim_out, void* iters_out, void* err,
                                   int n, int stack_cap, int max_iters,
                                   float eps, int leaf_kind, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (leaf_kind == 1) {
    packet_traverse_kernel<1><<<blocks, kThreads, 0, s>>>(
        (const float*)nodes, (const int*)entries, (const float*)runs,
        (const float*)ro, (const float*)rd, (const float*)t_init,
        (const unsigned char*)active, (float*)t_out, (int*)prim_out,
        (int*)iters_out, (int*)err, n, stack_cap, max_iters, eps);
  } else {
    packet_traverse_kernel<0><<<blocks, kThreads, 0, s>>>(
        (const float*)nodes, (const int*)entries, (const float*)runs,
        (const float*)ro, (const float*)rd, (const float*)t_init,
        (const unsigned char*)active, (float*)t_out, (int*)prim_out,
        (int*)iters_out, (int*)err, n, stack_cap, max_iters, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
