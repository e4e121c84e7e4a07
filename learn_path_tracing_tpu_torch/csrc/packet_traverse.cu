// Nearest hit over an 8-wide BVH for NVIDIA Hopper (sm_90a): kernels K2
// (triangle leaves) and K3 (sphere leaves), one template, and the packet
// kernels K5a and K5b (triangle leaves), which share its slab and leaf code.
//
// Replaces the TPU kernels of learn_path_tracing_tpu/ops/packet_traverse.py,
// the versions the JAX package picks with LPT_PACKET_VERSION:
//   K2/K3  _kernel_v2 (version 2; leaf_kind 'tri' and 'sphere');
//   K5a    _kernel    (version 1: the ordered packet walk);
//   K5b    _kernel_v3 (version 3: the tile-ranged packet walk).
// All read the same tables (nodes f32[M,128], entries i32[M,128], runs
// f32[R,128]; layout in ops/packet_traverse.py) and compute what those
// kernels compute, with an order-free tie rule.
//
// K2/K3 design: the TPU walks ONE stack per 1024-ray packet on its scalar
// core and tests every node against all lanes of the packet. Here every
// thread walks its own ray with a private stack in local memory (the
// reference's per-thread walk): pop an entry, drop it if its entry distance
// is no longer < t_best + eps, slab-test the node's 8 children, test the
// entered leaf children at once nearest first, and push the entered node
// children so that the nearest pops first. Leaves never touch the stack, so
// it holds at most 1 + 7*depth entries; the wrapper passes that bound
// (stack_cap) and the kernel reports an overflow, or reaching the max_iters
// pop backstop, in *err instead of truncating.
//
// K5a design (v1): the TPU's packet becomes a warp's: 32 rays share one
// stack in shared memory whose entries are (code, packet entry distance,
// mask of the lanes that entered). At a node pop each lane of the mask whose
// t_best still admits the entry slab-tests the 8 children in v1's form
// (lo - ro)*inv; __ballot_sync gives each child's mask and
// __reduce_min_sync on the bits of the non-negative entry distances its
// packet key. Children, leaves included, are pushed near to far; a leaf pop
// is tested by the lanes of its mask only, which keeps each ray's (t, prim)
// that of its own walk (the TPU tests every lane against a leaf, so there a
// ray's result can depend on its packet mates). Each node pop replaces one
// entry by at most 8, so the stack bound stays 1 + 7*depth.
//
// K5b design (v3): v3's 8 lane tiles of 128 become the 8 warps of a
// 256-thread block, one packet per block. Every entry carries the range of
// warps [lo, hi) that entered it and, for exactness, each warp's lane mask
// (48 bytes; a few KB of shared memory for the whole stack). Warps outside
// the range skip the pop's slab and leaf work, which is v3's saving. Leaves
// are tested inline at their parent's pop, nearest first, as in v3; child
// ranges come from per-warp ballots merged by warp 0, which also pushes.
// Three __syncthreads a live pop keep the block's stack consistent; a pop no
// lane still wants costs one __syncthreads_or. The slab form is the hoisted
// lo*inv - ro*inv of v2/v3.
//
// Not carried over from the TPU kernels, being scheduling devices and not
// parts of the function: the scalar-core sorting network (here a warp
// ranks the 8 children), the int keys with 3 dropped mantissa bits (here
// exact float bits, ties to the lower slot), the SMEM trash slots for
// invalid pushes, the block-max t_cap prune (each lane checks its own
// t_best) and v3's 1/rd VMEM cache (1/rd lives in registers).
//
// Arithmetic: every operation is an explicitly rounded __f*_rn intrinsic
// (and the library is built with -fmad=false), in the order of the plain
// PyTorch twin packet_traverse_plain, so a kernel and the twin agree bit
// for bit in (t, prim):
//   slab   t = lo*inv - ro*inv (K2, K3, K5b) or (lo - ro)*inv (K5a),
//          inv = 1/rd, NaN-propagating min/max, entered if t1 > t0 - eps,
//          t1 > 0 and t0 < t_best + eps;
//   tri    t = (d - ro.n)/(rd.n), w1 = (ro.g1 + t*(rd.g1)) + c1, w2 alike,
//          w3 = (1 - w1) - w2, hit if t > eps and all w > 0;
//   sphere oc = ro - c, hb = oc.rd, disc = hb*hb - (oc.oc - r2),
//          t = -hb - sqrt(max(disc, 0)), or -hb + sqrt(..) for flag 2 when
//          the near root is < eps; hit if disc >= 0 and t > eps.
// Tie rule: a candidate wins on strictly smaller t, or equal t and a
// smaller prim id, so the result is the least (t, prim) over all tested
// primitives whatever the visiting order. The packet kernels visit nodes in
// another order than the twin and test a superset of what each ray's own
// walk tests (a lane in an entry's mask re-checks the packet's entry
// distance, not its own); what they add lies beyond the eps-relaxed boxes
// the ray's own walk culled, so the least (t, prim) is the same.
//
// Bound: latency of dependent loads (node row, then the run rows it names)
// and divergence; the tables of a 23k-triangle mesh are a few MB and stay
// resident in the 50 MB L2, read through the read-only path (__ldg). The
// packet kernels trade K2's divergence for a packet's node union and, in
// K5b, block-wide barriers per pop. These versions are written to be right;
// treelet restart, shared-memory staging and occupancy tuning are later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;     // K2/K3: one ray per thread
constexpr int kWidth = 8;
constexpr int kRowF = 128;        // floats per table row
constexpr int kMaxStack = 256;    // stack entries (ops MAX_STACK)
constexpr int kPad = -(1 << 30);  // empty child slot
constexpr int kEnc = 64;          // run-length field of a leaf code
constexpr int kPrimCol = 96;      // prim ids of a run row
constexpr int kErrStack = 1;
constexpr int kErrIters = 2;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;   // above the bits of any finite key
constexpr int kWarpsV1 = 4;                // K5a: packets (warps) per block
constexpr int kThreadsV1 = 32 * kWarpsV1;
constexpr int kWarpsV3 = 8;                // K5b: warps (v3's tiles) per packet
constexpr int kThreadsV3 = 32 * kWarpsV3;

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

// Bits of a non-negative entry distance that order as the floats do (-0
// becomes +0), for warp min-reductions.
__device__ __forceinline__ unsigned key_bits(float k) {
  return __float_as_uint(__fadd_rn(k, 0.f));
}

__device__ __forceinline__ void load_ray(const float* __restrict__ ro,
                                         const float* __restrict__ rd, int i,
                                         float o[3], float d[3], float inv[3],
                                         float roinv[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = ro[3 * i + k];
    d[k] = rd[3 * i + k];
    inv[k] = __fdiv_rn(1.f, d[k]);
    roinv[k] = __fmul_rn(o[k], inv[k]);
  }
}

// Slab interval [t0, t1] of child c of a node row: kDirect (v1)
// (lo - ro)*inv, else lo*inv - ro*inv.
template <int kDirect>
__device__ __forceinline__ void slab(const float* __restrict__ box, int c,
                                     const float o[3], const float inv[3],
                                     const float roinv[3], float& t0,
                                     float& t1) {
  t0 = -INFINITY;
  t1 = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = __ldg(box + k * kWidth + c);
    const float hi = __ldg(box + (3 + k) * kWidth + c);
    const float ta = kDirect ? __fmul_rn(__fsub_rn(lo, o[k]), inv[k])
                             : __fsub_rn(__fmul_rn(lo, inv[k]), roinv[k]);
    const float tc = kDirect ? __fmul_rn(__fsub_rn(hi, o[k]), inv[k])
                             : __fsub_rn(__fmul_rn(hi, inv[k]), roinv[k]);
    t0 = nan_max(t0, nan_min(ta, tc));
    t1 = nan_min(t1, nan_max(ta, tc));
  }
}

__device__ __forceinline__ bool enters(float t0, float t1, float eps,
                                       float reach) {
  return t1 > __fsub_rn(t0, eps) && t1 > 0.f && t0 < reach;
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

// Test the leaf run of entry code (< 0): its first row, and the spill row
// of a fat leaf.
template <int kSphere>
__device__ __forceinline__ void test_leaf(const float* __restrict__ runs,
                                          int code, const float o[3],
                                          const float d[3], float eps,
                                          float& tb, int& pb) {
  const int v = -(code + 1);
  const int row = v / kEnc, count = v % kEnc;
  test_run<kSphere>(runs + (size_t)row * kRowF, min(count, kWidth), o, d, eps,
                    tb, pb);
  if (count > kWidth)
    test_run<kSphere>(runs + (size_t)(row + 1) * kRowF, count - kWidth, o, d,
                      eps, tb, pb);
}

// ------------------------------------------------ K2/K3: a ray per thread --

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
    load_ray(ro, rd, i, o, d, inv, roinv);
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
        float t0, t1;
        slab<0>(box, c, o, inv, roinv, t0, t1);
        key[c] = nan_max(t0, 0.f);
        if (enters(t0, t1, eps, reach) && ent[c] != kPad) {
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
        test_leaf<kSphere>(runs, be, o, d, eps, tb, pb);
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

// Ray i of a packet kernel: (o, d, 1/d, o/d) and whether it is walked; a
// lane past n or inactive takes part in the warp's votes only.
__device__ __forceinline__ bool packet_lane(const float* __restrict__ ro,
                                            const float* __restrict__ rd,
                                            const float* __restrict__ t_init,
                                            const unsigned char* __restrict__ active,
                                            int i, int n, float o[3], float d[3],
                                            float inv[3], float roinv[3],
                                            float& tb) {
  tb = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = d[k] = inv[k] = roinv[k] = 0.f;
  if (i >= n) return false;
  tb = t_init[i];
  if (!active[i]) return false;
  load_ray(ro, rd, i, o, d, inv, roinv);
  return true;
}

// ------------------------------------------- K5a: v1 packet walk per warp --

__global__ void __launch_bounds__(kThreadsV1)
packet_walk_v1_kernel(const float* __restrict__ nodes,
                      const int* __restrict__ entries,
                      const float* __restrict__ runs,
                      const float* __restrict__ ro,
                      const float* __restrict__ rd,
                      const float* __restrict__ t_init,
                      const unsigned char* __restrict__ active,
                      float* __restrict__ t_out, int* __restrict__ prim_out,
                      int* __restrict__ iters_out, int* __restrict__ err,
                      int n, int stack_cap, int max_iters, float eps) {
  __shared__ int s_code[kWarpsV1][kMaxStack];
  __shared__ float s_key[kWarpsV1][kMaxStack];
  __shared__ unsigned s_mask[kWarpsV1][kMaxStack];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreadsV1 + threadIdx.x;
  int* st_code = s_code[warp];
  float* st_key = s_key[warp];
  unsigned* st_mask = s_mask[warp];
  float o[3], d[3], inv[3], roinv[3], tb;
  const bool act = packet_lane(ro, rd, t_init, active, i, n, o, d, inv, roinv, tb);
  int pb = -1;
  const unsigned root = __ballot_sync(kFullMask, act);
  int sp = -1, iters = 0;   // warp-uniform
  if (root) {
    if (lane == 0) {
      st_code[0] = 0;
      st_key[0] = 0.f;
      st_mask[0] = root;
    }
    sp = 0;
  }
  __syncwarp();
  while (sp >= 0) {
    if (iters >= max_iters) {
      if (lane == 0) atomicOr(err, kErrIters);
      break;
    }
    ++iters;
    const int code = st_code[sp];
    const float key = st_key[sp];
    const unsigned mask = st_mask[sp];
    --sp;
    const bool mine = ((mask >> lane) & 1u) && key < __fadd_rn(tb, eps);
    if (!__any_sync(kFullMask, mine)) continue;   // stale for every lane
    if (code < 0) {                                // a leaf run
      if (mine) test_leaf<0>(runs, code, o, d, eps, tb, pb);
      continue;
    }
    const float* __restrict__ box = nodes + (size_t)code * kRowF;
    const int* __restrict__ kid = entries + (size_t)code * kRowF;
    const float reach = __fadd_rn(tb, eps);
    unsigned cmask[kWidth], ckey[kWidth];
    int cent[kWidth];
    unsigned present = 0;
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      cent[c] = __ldg(kid + c);
      bool entered = false;
      float k = 0.f;
      if (mine && cent[c] != kPad) {
        float t0, t1;
        slab<1>(box, c, o, inv, roinv, t0, t1);
        entered = enters(t0, t1, eps, reach);
        k = nan_max(t0, 0.f);
      }
      cmask[c] = __ballot_sync(kFullMask, entered);
      ckey[c] = __reduce_min_sync(kFullMask, entered ? key_bits(k) : kNoKey);
      if (cmask[c]) present |= 1u << c;
    }
    if (sp + __popc(present) >= stack_cap) {
      if (lane == 0) atomicOr(err, kErrStack);
      break;
    }
    __syncwarp();   // every lane has read the popped entry
    // children, leaves included, farthest pushed first (ties: higher slot
    // first), so the nearest, lowest slot ends on top
    while (present) {
      int bc = 0;
      unsigned bk = 0, bm = 0;
      int be = 0;
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        if (((present >> c) & 1u) && ckey[c] >= bk) {
          bc = c;
          bk = ckey[c];
          bm = cmask[c];
          be = cent[c];
        }
      }
      present &= ~(1u << bc);
      ++sp;
      if (lane == 0) {
        st_code[sp] = be;
        st_key[sp] = __uint_as_float(bk);
        st_mask[sp] = bm;
      }
    }
    __syncwarp();   // the pushes are visible to every lane
  }
  if (i < n) {
    t_out[i] = tb;
    prim_out[i] = pb;
    iters_out[i] = iters;
  }
}

// ---------------------------------- K5b: v3 tile-ranged walk per 8 warps --

struct PacketEntry {
  int code;
  float key;                  // the packet's entry distance
  int lo, hi;                 // warps [lo, hi) that entered
  unsigned mask[kWarpsV3];    // each warp's entering lanes
};

__global__ void __launch_bounds__(kThreadsV3)
packet_walk_v3_kernel(const float* __restrict__ nodes,
                      const int* __restrict__ entries,
                      const float* __restrict__ runs,
                      const float* __restrict__ ro,
                      const float* __restrict__ rd,
                      const float* __restrict__ t_init,
                      const unsigned char* __restrict__ active,
                      float* __restrict__ t_out, int* __restrict__ prim_out,
                      int* __restrict__ iters_out, int* __restrict__ err,
                      int n, int stack_cap, int max_iters, float eps) {
  __shared__ PacketEntry s_stack[kMaxStack];
  __shared__ PacketEntry s_leaf[kWidth];        // this pop's leaves, nearest first
  __shared__ unsigned s_cmask[kWarpsV3][kWidth];  // [warp][child] entering lanes
  __shared__ unsigned s_ckey[kWarpsV3][kWidth];   // [warp][child] key bits
  __shared__ int s_sp, s_nleaf, s_overflow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreadsV3 + threadIdx.x;
  float o[3], d[3], inv[3], roinv[3], tb;
  const bool act = packet_lane(ro, rd, t_init, active, i, n, o, d, inv, roinv, tb);
  int pb = -1;
  const unsigned wm = __ballot_sync(kFullMask, act);
  if (lane == 0) s_stack[0].mask[warp] = wm;
  if (threadIdx.x == 0) {   // the root, over v3's full range
    s_stack[0].code = 0;
    s_stack[0].key = 0.f;
    s_stack[0].lo = 0;
    s_stack[0].hi = kWarpsV3;
  }
  int sp = __syncthreads_or(act) ? 0 : -1;   // block-uniform
  int iters = 0;
  while (sp >= 0) {
    if (iters >= max_iters) {
      if (threadIdx.x == 0) atomicOr(err, kErrIters);
      break;
    }
    ++iters;
    const PacketEntry& e = s_stack[sp];
    const int code = e.code;
    const float key = e.key;
    const bool in_range = warp >= e.lo && warp < e.hi;
    const unsigned m = e.mask[warp];
    --sp;
    const bool mine = in_range && ((m >> lane) & 1u) && key < __fadd_rn(tb, eps);
    if (!__syncthreads_or(mine)) continue;   // stale for every lane

    // slab test of the 8 children by the warps in range
    unsigned cmask[kWidth], ckey[kWidth];
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      cmask[c] = 0;
      ckey[c] = kNoKey;
    }
    if (in_range) {   // warp-uniform
      const float* __restrict__ box = nodes + (size_t)code * kRowF;
      const int* __restrict__ kid = entries + (size_t)code * kRowF;
      const float reach = __fadd_rn(tb, eps);
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        bool entered = false;
        float k = 0.f;
        if (mine && __ldg(kid + c) != kPad) {
          float t0, t1;
          slab<0>(box, c, o, inv, roinv, t0, t1);
          entered = enters(t0, t1, eps, reach);
          k = nan_max(t0, 0.f);
        }
        cmask[c] = __ballot_sync(kFullMask, entered);
        ckey[c] = __reduce_min_sync(kFullMask, entered ? key_bits(k) : kNoKey);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        s_cmask[warp][c] = cmask[c];
        s_ckey[warp][c] = ckey[c];
      }
    }
    __syncthreads();

    // warp 0: lane c merges child c over the warps, ranks it among the
    // entered children of its kind by (key, slot), and writes it: nodes
    // onto the stack (the nearest on top), leaves into this pop's list
    if (warp == 0) {
      const int c = lane;
      unsigned kb = kNoKey;
      int clo = kWarpsV3, chi = 0, ent = kPad;
      if (c < kWidth) {
        ent = __ldg(entries + (size_t)code * kRowF + c);
        for (int w = 0; w < kWarpsV3; ++w) {
          if (s_cmask[w][c]) {
            kb = min(kb, s_ckey[w][c]);
            clo = min(clo, w);
            chi = w + 1;
          }
        }
      }
      const bool entered = chi > 0;
      const unsigned leafs = __ballot_sync(kFullMask, entered && ent < 0);
      const unsigned inner = __ballot_sync(kFullMask, entered && ent >= 0);
      const unsigned kind = ent < 0 ? leafs : inner;
      int rank = 0;
      for (int j = 0; j < kWidth; ++j) {
        const unsigned kj = __shfl_sync(kFullMask, kb, j);
        if (((kind >> j) & 1u) && (kj < kb || (kj == kb && j < c))) ++rank;
      }
      const int nn = __popc(inner);
      const bool overflow = sp + nn >= stack_cap;
      PacketEntry* dst = nullptr;
      if (entered && ent >= 0 && !overflow) dst = &s_stack[sp + nn - rank];
      if (entered && ent < 0) dst = &s_leaf[rank];
      if (dst) {
        dst->code = ent;
        dst->key = __uint_as_float(kb);
        dst->lo = clo;
        dst->hi = chi;
        for (int w = 0; w < kWarpsV3; ++w) dst->mask[w] = s_cmask[w][c];
      }
      if (lane == 0) {
        s_sp = sp + nn;
        s_nleaf = __popc(leafs);
        s_overflow = overflow;
      }
    }
    __syncthreads();
    if (s_overflow) {
      if (threadIdx.x == 0) atomicOr(err, kErrStack);
      break;
    }
    sp = s_sp;

    // leaves inline, nearest first, by the lanes that entered them
    const int nleaf = s_nleaf;
    for (int k = 0; k < nleaf; ++k) {
      const PacketEntry& leaf = s_leaf[k];
      if (warp >= leaf.lo && warp < leaf.hi && ((leaf.mask[warp] >> lane) & 1u) &&
          leaf.key < __fadd_rn(tb, eps))
        test_leaf<0>(runs, leaf.code, o, d, eps, tb, pb);
    }
  }
  if (i < n) {
    t_out[i] = tb;
    prim_out[i] = pb;
    iters_out[i] = iters;
  }
}

}  // namespace

// Plain C entry for ctypes. nodes/entries/runs: the packed tables (f32 / i32
// / f32, 128 columns); ro, rd: f32[n,3]; t_init: f32[n]; active: bool[n]
// (one byte each); t_out: f32[n]; prim_out, iters_out: i32[n]; err: one i32,
// zero on entry (bit 1: stack overflow, bit 2: pop backstop). leaf_kind 0 =
// triangles, 1 = spheres; version 2 = K2/K3, 1 = K5a, 3 = K5b (triangles
// only). All contiguous on the current device. Launches on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising, or
// cudaErrorInvalidValue for a version or leaf kind it does not take.
extern "C" int lpt_packet_traverse(const void* nodes, const void* entries,
                                   const void* runs, const void* ro,
                                   const void* rd, const void* t_init,
                                   const void* active, void* t_out,
                                   void* prim_out, void* iters_out, void* err,
                                   int n, int stack_cap, int max_iters,
                                   float eps, int leaf_kind, int version,
                                   void* stream) {
  if (version < 1 || version > 3 || leaf_kind < 0 || leaf_kind > 1 ||
      (version != 2 && leaf_kind != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* nf = (const float*)nodes;
  const int* ei = (const int*)entries;
  const float* rf = (const float*)runs;
  const float* rof = (const float*)ro;
  const float* rdf = (const float*)rd;
  const float* tif = (const float*)t_init;
  const unsigned char* ac = (const unsigned char*)active;
  float* to = (float*)t_out;
  int* po = (int*)prim_out;
  int* io = (int*)iters_out;
  int* er = (int*)err;
  if (version == 1) {
    packet_walk_v1_kernel<<<(n + kThreadsV1 - 1) / kThreadsV1, kThreadsV1, 0, s>>>(
        nf, ei, rf, rof, rdf, tif, ac, to, po, io, er, n, stack_cap, max_iters, eps);
  } else if (version == 3) {
    packet_walk_v3_kernel<<<(n + kThreadsV3 - 1) / kThreadsV3, kThreadsV3, 0, s>>>(
        nf, ei, rf, rof, rdf, tif, ac, to, po, io, er, n, stack_cap, max_iters, eps);
  } else if (leaf_kind == 1) {
    packet_traverse_kernel<1><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        nf, ei, rf, rof, rdf, tif, ac, to, po, io, er, n, stack_cap, max_iters, eps);
  } else {
    packet_traverse_kernel<0><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        nf, ei, rf, rof, rdf, tif, ac, to, po, io, er, n, stack_cap, max_iters, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
