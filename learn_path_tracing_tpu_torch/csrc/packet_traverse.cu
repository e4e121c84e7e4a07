// Nearest hit over an 8-wide BVH for NVIDIA Hopper (sm_90a): kernels K2
// (triangle leaves) with its modes K2r (seeded: the treelet restart), K2h
// (bf16 node slabs) and K2rh (both), and K3 (sphere leaves), one template,
// and the packet kernels K5a and K5b (triangle leaves), one template too,
// which share its slab and leaf code.
//
// Replaces the TPU kernels of learn_path_tracing_tpu/ops/packet_traverse.py,
// the versions the JAX package picks with LPT_PACKET_VERSION:
//   K2/K3  _kernel_v2 (version 2; leaf_kind 'tri' and 'sphere'; its
//          seed_init and bf16-slab modes are K2r and K2h);
//   K5a    _kernel    (version 1: the ordered packet walk);
//   K5b    _kernel_v3 (version 3: the tile-ranged packet walk).
// All read the same tables (nodes f32[M,128], entries i32[M,128], runs
// f32[R,128]; layout in ops/packet_traverse.py) and compute what those
// kernels compute, with an order-free tie rule.
//
// K2/K3 design: the TPU walks ONE stack per 1024-ray packet on its scalar
// core and tests every node against all lanes of the packet. Here every
// thread walks its own ray with a private stack (the reference's per-thread
// walk): pop an entry, drop it if its entry distance is no longer
// < t_best + eps, slab-test the node's 8 children, test the entered leaf
// children at once nearest first, and push the entered node children so
// that the nearest pops first. Leaves never touch the stack, so it holds at
// most 1 + 7*depth entries; the wrapper passes that bound (stack_cap) and
// the kernel reports an overflow, or reaching the max_iters pop backstop,
// in *err instead of truncating.
// What bounds it on the H100 is instruction rate under divergence, not
// bytes: the tables (a few MB) stay in the 50 MB L2 and mostly in L1, and a
// warp runs as long as its slowest ray, through the leaf code whenever one
// of its 32 rays has a leaf. So the design spends as few instructions a pop
// as exact rounding allows: a node row arrives as twelve 16-byte loads (the
// tables are component-major, so four children's values of one component
// lie side by side) and the 8 entries as two; the NaN-propagating min/max
// of the slab test are single min.NaN/max.NaN instructions; a sphere run
// row is read as 16-byte loads, four slots at a time, and the root is taken
// only where the discriminant admits one. K2's triangle leaf reads two
// slots at a time, each coefficient of the pair as one 8-byte load: the 13
// loads of a pair are in flight together, which is what a walk waits for on
// incoherent rays and in narrow launches, at 70 registers. The 16-byte form
// (four slots, 100 registers) gains more there and loses a quarter on the
// coherent primary slab; capped to 64 registers it spills and loses
// everywhere. The stack stays in local memory (interleaved by lane, so a
// warp's entry is one 128-byte line, resident in L1): a shared-memory stack
// of stack_cap entries a thread caps the SM at a third of its threads and
// measured no faster.
// Tried and dropped, with the times in PERF.md: eight lanes walking one ray
// together (a lane a child, a lane a leaf slot, the stack in shared
// memory). It cuts the divergence to 4 rays a warp and beat the old walk on
// incoherent rays by a third, but runs over twice the instructions a pop
// (ballots, shuffles and the ranking replace work that 32 rays shared) and
// took 2.5 times as long on the coherent slabs. A split triangle test (the
// plane distance of four slots first, the barycentric weights only where
// t > eps and t <= t_best): exact, but the plane rejects few slots a warp
// (some lane nearly always goes on), and the second dependent load cost
// 6-25 % on every set but rays starting on the surface. Persistent warps
// whose idle lanes refetch rays from a counter: exact in (t, prim, iters),
// up to 15 % faster on over a million incoherent rays (K3), 12-24 % slower
// on K2's coherent slab (a vote a pop, 72 against 64 registers, rays of a
// warp no longer neighbours). Prefetching the next node's rows before the
// leaf tests: no faster.
//
// K5a and K5b design: the TPU's v1 walks one ordered stack a 1024-ray
// packet; its v3 splits the packet into 8 lane tiles and lets a tile skip
// every node that none of its lanes entered. On this card a tile is a warp,
// and the ranging is taken to its end: every warp keeps a stack of its own
// (shared memory, stack_cap entries of code, key, lane mask) and walks only
// what its own lanes entered, with __syncwarp and no block-wide barrier. A
// node row is read as 16-byte loads; each lane of the entry's mask whose
// t_best still admits it slab-tests the 8 children; __ballot_sync gives each
// child's mask and __reduce_min_sync on the bits of the non-negative entry
// distances its key; lane c keeps child c's entry, mask and key, and ranks
// it with 8 shuffles. Leaves are tested inline at their parent's pop, nearest
// first, by the lanes that entered them, never pushed (the TPU's v1 tests
// every lane against a leaf, so there a ray's result can depend on its packet
// mates). The two kernels are one template and differ in what is their
// function: K5a slab-tests in v1's form (lo - ro)*inv, which hits the
// axis-parallel rays that the hoisted lo*inv - ro*inv of K5b (and K2) loses
// to inf - inf. Their leaf is the scalar one: 8-byte loads made both slower
// on the coherent slab (76-80 registers) for 2-3 % in narrow launches.
// What bounds them is the packet's node union (every lane of a warp steps
// through every node any of them entered) and, on incoherent rays, leaf
// tests by a few lanes of a warp. Tried and dropped, with the times in
// PERF.md: K5a as first ported (scalar node loads, every lane ranking all 8
// children, three static 256-entry stacks a warp), and the new walk with
// v1's pushed leaves (a pop, a vote and two __syncwarp more a leaf run: 8 %
// slower a frame than inline); for K5b one packet of 8 warps a block with a
// stack replicated per warp, entries carrying the range of warps that
// entered, one __syncthreads a shared pop, and entries that at most 1, 2, 4
// or 8 warps entered detached onto those warps' private stacks (drained
// after each shared pop, or put off until the shared stack was empty). Every
// step towards less sharing
// was faster: a shared pop costs all 8 warps a barrier and a merge and
// saves none of them a slab test, so the walk with nothing shared is the
// one kept. Packets of 2 or 4 warps for narrow launches went with it.
//
// K2r and K2h are template flags of K2, not copies (K2rh is both), each
// redesigned for this card once its straight port had been measured (the
// times are in PERF.md). What bounds them is K2's: instructions under
// divergence, not bytes.
// K2r replaces _kernel_v2(seed_init=True) (ops/packet_traverse.py:428-472):
// the TPU seeds a 1024-ray packet's shared stack with the depth-2 treelets
// any of its rays enters (up to 8, from an SMEM row), so the packet skips
// the top two levels. Its first port seeded every thread from its block's
// row: a ray popped every treelet of the union, and a block whose union
// passed 8 walked from the root. Here each ray is seeded from the treelets
// it enters itself: its words (bit t set for treelet slot t, from the
// coherence key's slab test, empty slots dropped) and its two nearest
// slots m1, m2 (the key's own), read as one 16-byte load, mapped through
// the tables' 64 treelet codes. A node seed is pushed at entry distance +0
// (m1 pops first, then m2, then the rest in slot order), a leaf seed tested
// at once, an empty slot skipped; a ray that enters none walks nothing, one
// that enters more than 8 walks from the root. Exact: a ray hits only
// primitives below a treelet it enters, since the primitive lies in the
// treelet's box and the key's test is eps-relaxed like the kernel's, so
// (t, prim) is the root walk's under the order-free tie rule. (A ray whose
// slab terms are NaN, from ro = 0 along a zero direction component, has
// every box rejected by the root walk; its seeds skip the top two levels,
// so a leaf seed can give it a hit that the root walk lacks.) The stack
// holds at most 7 seeds under the walk below one, within stack_cap.
// K2h replaces the bf16-slab mode (:445, :486-490, :563-583): the TPU walks
// its [8, lanes] slab pipeline in bf16, which XLA computes as f32
// operations each rounded to bf16. Its first port did the same in scalar
// f32 with a convert to bf16 and back after each operation, and widened
// the row's 48 box values first: more instructions a child than K2, on an
// instruction-bound walk. Here the row stays as loaded (six 16-byte loads,
// component k of children 2p, 2p + 1 in bf16x2 word p) and the slab test
// runs on bf16x2 words, two children an instruction: mul.rn and sub.rn
// (sm_90; never contracted), min.NaN and max.NaN, and the entry test's
// t0 - eps16; then the halves are widened exactly for the compares and the
// f32 keys. 25 bf16x2 instructions a pair of children (12.5 a child,
// against 48 rounded f32 operations and 6 widenings). Bit for bit the
// op-by-op form: the product or difference of two bf16 values rounded to
// f32 and then to bf16 is the correctly rounded bf16 result, because f32's
// 24 bits exceed 2*8 + 2 (the f32 grid is 16 bits finer in the subnormal
// range too), which is what the bf16x2 instructions give; min/max select an
// operand, and neither the sign of a zero nor a NaN's payload reaches a
// comparison's outcome.
//
// Not carried over from the TPU kernels, being scheduling devices and not
// parts of the function: the scalar-core sorting network (here a thread or
// a warp ranks the 8 children), the int keys with 3 dropped mantissa bits
// (here exact float bits, ties to the lower slot), the SMEM trash slots for
// invalid pushes, the block-max t_cap prune (each lane checks its own
// t_best), v3's 1/rd VMEM cache (1/rd lives in registers) and v3's shared
// stack over 8 tiles (above).
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
//          t = -hb - sqrt(disc), or -hb + sqrt(disc) for flag 2 when the
//          near root is < eps; hit if disc >= 0 and t > eps.
// Tie rule: a candidate wins on strictly smaller t, or equal t and a
// smaller prim id, so the result is the least (t, prim) over all tested
// primitives whatever the visiting order. The packet kernels visit nodes in
// another order than the twin and test a superset of what each ray's own
// walk tests (a lane in an entry's mask re-checks the warp's entry
// distance, not its own); what they add lies beyond the eps-relaxed boxes
// the ray's own walk culled, so the least (t, prim) is the same.
// iters: K2/K3 count each ray's pops, bit for bit the twin's; K5a and K5b
// give every ray its warp's node pops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;     // K2/K3: one ray per thread
constexpr int kWidth = 8;
constexpr int kRowF = 128;        // floats per table row
constexpr int kMaxStack = 256;    // K2/K3: stack entries (ops MAX_STACK)
constexpr int kPad = -(1 << 30);  // empty child slot
constexpr int kEnc = 64;          // run-length field of a leaf code
constexpr int kPrimCol = 96;      // prim ids of a run row
constexpr int kErrStack = 1;
constexpr int kErrIters = 2;
constexpr int kTreelets = 64;     // K2r: depth-2 treelet slots (ops RaySeeds)

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;   // above the bits of any finite key
constexpr int kWarpsPk = 4;                // K5a/K5b: packets (warps) per block
constexpr int kThreadsPk = 32 * kWarpsPk;

// NaN-propagating min and max (torch.minimum / torch.maximum): one
// instruction each on sm_80 and later.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

// Component k (lo.x .. hi.z) of children 4*half .. 4*half + 3 of a node row,
// read as 16-byte vectors: b[k][q].
__device__ __forceinline__ void load_half_boxes(const float* __restrict__ node_row,
                                                int half, float b[6][4]) {
  const float4* __restrict__ box = reinterpret_cast<const float4*>(node_row);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float4 v = __ldg(box + 2 * k + half);
    b[k][0] = v.x;
    b[k][1] = v.y;
    b[k][2] = v.z;
    b[k][3] = v.w;
  }
}

// x rounded to the nearest even bfloat16, held as a float: K2h's per-ray
// and per-pop terms (1/rd, ro/rd, eps, t_best + eps).
__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// K2h's slab arithmetic on bf16x2 words (two children an instruction, the
// low half the even child): Hopper's correctly rounded mul/sub (sm_90; the
// intrinsics __hmul2_rn / __hsub2_rn, which never contract into an FMA)
// and the NaN-propagating min/max (__hmin2_nan / __hmax2_nan).
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned bf2_sub(unsigned a, unsigned b) {
  unsigned r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned bf2_min(unsigned a, unsigned b) {
  unsigned r;
  asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned bf2_max(unsigned a, unsigned b) {
  unsigned r;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// A float that is a bf16 value (bf_round's result), in both halves.
__device__ __forceinline__ unsigned bf2_splat(float x) {
  const unsigned b = __float_as_uint(x) >> 16;
  return b | (b << 16);
}

// The halves of a bf16x2 word as floats (exact).
__device__ __forceinline__ float bf2_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf2_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// K2h's slab test of a bf16 node row (48 box values, 96 bytes, as six
// 16-byte loads: component k = lo.x .. hi.z of children 2p, 2p + 1 in
// word p of w[k]), two children an instruction: the hoisted form t =
// bf(bf(lo*inv16) - roinv16), t0/t1 from the TPU kernel's bounds
// -/+bf(3e38), entered if t1 > bf(t0 - eps16), t1 > 0 and t0 < reach16.
// Sets each child's bit in *in and its key max(t0, 0) (f32, widened
// exactly). 3 x (2 mul, 2 sub, min, max, 2 folds) + 1 sub = 25 bf16x2
// instructions a pair of children: 12.5 a child, against the f32 form's
// 24 and the op-by-op rounded form's 48 (each term an f32 operation, a
// convert to bf16 and a shift back) and its 6 widenings of the box values.
__device__ __forceinline__ unsigned slab_row_bf16(const __nv_bfloat16* __restrict__ node_row,
                                                  const unsigned inv2[3],
                                                  const unsigned roinv2[3], unsigned bmax2,
                                                  unsigned eps2, float reach16,
                                                  float key[kWidth]) {
  const uint4* __restrict__ box = reinterpret_cast<const uint4*>(node_row);
  uint4 w[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) w[k] = __ldg(box + k);
  unsigned in = 0;
#pragma unroll
  for (int p = 0; p < kWidth / 2; ++p) {
    unsigned t0 = bmax2 ^ 0x80008000u, t1 = bmax2;   // -/+bf(3e38)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned lo = p == 0 ? w[k].x : p == 1 ? w[k].y : p == 2 ? w[k].z : w[k].w;
      const unsigned hi = p == 0   ? w[3 + k].x
                          : p == 1 ? w[3 + k].y
                          : p == 2 ? w[3 + k].z
                                   : w[3 + k].w;
      const unsigned ta = bf2_sub(bf2_mul(lo, inv2[k]), roinv2[k]);
      const unsigned tc = bf2_sub(bf2_mul(hi, inv2[k]), roinv2[k]);
      t0 = bf2_max(t0, bf2_min(ta, tc));
      t1 = bf2_min(t1, bf2_max(ta, tc));
    }
    const unsigned t0e = bf2_sub(t0, eps2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a0 = h ? bf2_hi(t0) : bf2_lo(t0);
      const float a1 = h ? bf2_hi(t1) : bf2_lo(t1);
      const float ae = h ? bf2_hi(t0e) : bf2_lo(t0e);
      key[2 * p + h] = nan_max(a0, 0.f);
      if (a1 > ae && a1 > 0.f && a0 < reach16) in |= 1u << (2 * p + h);
    }
  }
  return in;
}

// The slab interval [t0, t1] of child q of a half row b (load_half_boxes):
// v1's form (lo - ro)*inv if kDirect, else the hoisted lo*inv - ro*inv.
template <bool kDirect>
__device__ __forceinline__ void slab_child(float b[6][4], int q, const float o[3],
                                           const float inv[3], const float roinv[3],
                                           float& t0, float& t1) {
  t0 = -INFINITY;
  t1 = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float ta, tc;
    if (kDirect) {
      ta = __fmul_rn(__fsub_rn(b[k][q], o[k]), inv[k]);
      tc = __fmul_rn(__fsub_rn(b[3 + k][q], o[k]), inv[k]);
    } else {
      ta = __fsub_rn(__fmul_rn(b[k][q], inv[k]), roinv[k]);
      tc = __fsub_rn(__fmul_rn(b[3 + k][q], inv[k]), roinv[k]);
    }
    t0 = nan_max(t0, nan_min(ta, tc));
    t1 = nan_min(t1, nan_max(ta, tc));
  }
}

__device__ __forceinline__ bool enters(float t0, float t1, float eps,
                                       float reach) {
  return t1 > __fsub_rn(t0, eps) && t1 > 0.f && t0 < reach;
}

__device__ __forceinline__ void fold_hit(float t, int pid, float& tb, int& pb) {
  if (t < tb || (t == tb && pid < pb)) {
    tb = t;
    pb = pid;
  }
}

// One triangle slot from its 12 coefficients: whether the ray hits it, and
// at which t.
__device__ __forceinline__ bool tri_slot_hit(const float c[12], const float o[3],
                                             const float d[3], float eps, float& t) {
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
  return t > eps && w1 > 0.f && w2 > 0.f && w3 > 0.f;
}

// Triangle slots [0, nslots) of one run row, a slot at a time with scalar
// loads (the packet walks' leaf: few lanes of a warp are in it at once, and
// it keeps their register count down).
__device__ __forceinline__ void test_tri_run(const float* __restrict__ row,
                                             int nslots, const float o[3],
                                             const float d[3], float eps,
                                             float& tb, int& pb) {
  for (int j = 0; j < nslots; ++j) {
    float c[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) c[k] = __ldg(row + k * kWidth + j);
    float t;
    if (tri_slot_hit(c, o, d, eps, t))
      fold_hit(t, (int)__ldg(row + kPrimCol + j), tb, pb);
  }
}

// The same slots two at a time, every coefficient of a pair as one 8-byte
// load (K2's leaf): the 13 loads of a pair are in flight together, and 24
// coefficients are live at once, not the 48 of the 16-byte form.
__device__ __forceinline__ void test_tri_run_pairs(const float* __restrict__ row,
                                                   int nslots, const float o[3],
                                                   const float d[3], float eps,
                                                   float& tb, int& pb) {
  const float2* __restrict__ row2 = reinterpret_cast<const float2*>(row);
#pragma unroll
  for (int h = 0; h < kWidth / 2; ++h) {
    if (2 * h >= nslots) break;
    float c[2][12];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float2 v = __ldg(row2 + (kWidth / 2) * k + h);
      c[0][k] = v.x;
      c[1][k] = v.y;
    }
    const float2 prim = __ldg(row2 + kPrimCol / 2 + h);
    float t;
    if (tri_slot_hit(c[0], o, d, eps, t)) fold_hit(t, (int)prim.x, tb, pb);
    if (2 * h + 1 < nslots && tri_slot_hit(c[1], o, d, eps, t))
      fold_hit(t, (int)prim.y, tb, pb);
  }
}

// Sphere slots [0, nslots) of one run row, four slots to a 16-byte load of
// each component; the root only where the discriminant admits one (a
// negative or NaN discriminant is no hit whatever the root). Folds hits
// into (tb, pb).
__device__ __forceinline__ void test_sphere_run(const float* __restrict__ row,
                                                int nslots, const float o[3],
                                                const float d[3], float eps,
                                                float& tb, int& pb) {
  const float4* __restrict__ row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (4 * h >= nslots) break;
    float c[5][4];   // cx, cy, cz, r2, flag of slots 4*h .. 4*h + 3
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float4 v = __ldg(row4 + 2 * k + h);
      c[k][0] = v.x;
      c[k][1] = v.y;
      c[k][2] = v.z;
      c[k][3] = v.w;
    }
    const float4 pv = __ldg(row4 + kPrimCol / 4 + h);
    const float prim[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * h + q >= nslots) break;
      const float ocx = __fsub_rn(o[0], c[0][q]);
      const float ocy = __fsub_rn(o[1], c[1][q]);
      const float ocz = __fsub_rn(o[2], c[2][q]);
      const float hb = dot3(ocx, ocy, ocz, d[0], d[1], d[2]);
      const float cterm = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), c[3][q]);
      const float disc = __fsub_rn(__fmul_rn(hb, hb), cterm);
      if (disc >= 0.f) {
        const float sq = __fsqrt_rn(disc);
        const float t_near = __fsub_rn(-hb, sq);
        const float t =
            (t_near < eps && c[4][q] > 1.5f) ? __fadd_rn(-hb, sq) : t_near;
        if (t > eps) fold_hit(t, (int)prim[q], tb, pb);
      }
    }
  }
}

constexpr int kTriScalar = 0, kSpheres = 1, kTriPairs = 2;   // leaf kinds

// Slots [0, nslots) of one run row by the leaf kind's test.
template <int kLeaf>
__device__ __forceinline__ void test_run(const float* __restrict__ row, int nslots,
                                         const float o[3], const float d[3],
                                         float eps, float& tb, int& pb) {
  if (kLeaf == kSpheres) test_sphere_run(row, nslots, o, d, eps, tb, pb);
  else if (kLeaf == kTriPairs) test_tri_run_pairs(row, nslots, o, d, eps, tb, pb);
  else test_tri_run(row, nslots, o, d, eps, tb, pb);
}

// Test the leaf run of entry code (< 0): its first row, and the spill row
// of a fat leaf.
template <int kLeaf>
__device__ __forceinline__ void test_leaf(const float* __restrict__ runs,
                                          int code, const float o[3],
                                          const float d[3], float eps,
                                          float& tb, int& pb) {
  const int v = -(code + 1);
  const int row = v / kEnc, count = v % kEnc;
  const float* __restrict__ first = runs + (size_t)row * kRowF;
  test_run<kLeaf>(first, min(count, kWidth), o, d, eps, tb, pb);
  if (count > kWidth) test_run<kLeaf>(first + kRowF, count - kWidth, o, d, eps, tb, pb);
}

// ------------------------------------------------ K2/K3: a ray per thread --

// kSeeded (K2r): when the ray's words (seeds[i] = w0, w1, m1, m2: bit t of
// the 64-bit w1:w0 set for each depth-2 treelet slot t it enters; m1, m2
// its nearest two, 64 for none) set at most 8 slots, its walk starts from
// them instead of the root: seed_codes[t] (the tables' treelet codes) is
// pushed at entry distance +0 for a node, tested at once for a leaf run,
// skipped when empty; no slot set, the walk is empty. The rest are pushed
// from the highest slot down, then m2, then m1, so that m1 pops first and
// the rest follow in slot order. The stack holds nodes only, so no pop
// reads a node row at a leaf's negative code.
// kBf16 (K2h): node rows are bf16 and the slab test runs on bf16x2 words
// (slab_row_bf16; entered if t1 > bf(t0 - eps16), t1 > 0 and
// t0 < bf(bf(t_best) + eps16)); keys, pops and leaves stay f32.
template <int kLeaf, bool kSeeded, bool kBf16>
__global__ void __launch_bounds__(kThreads)
packet_traverse_kernel(const void* __restrict__ nodes_raw,
                       const int* __restrict__ entries,
                       const float* __restrict__ runs,
                       const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ t_init,
                       const unsigned char* __restrict__ active,
                       const int* __restrict__ seeds,
                       const int* __restrict__ seed_codes,
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
    unsigned inv2[3], roinv2[3], eps2 = 0, bmax2 = 0;
    float eps16 = 0.f;
    if (kBf16) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        inv2[k] = bf2_splat(bf_round(inv[k]));
        roinv2[k] = bf2_splat(bf_round(roinv[k]));
      }
      eps16 = bf_round(eps);
      eps2 = bf2_splat(eps16);
      bmax2 = bf2_splat(bf_round(3.0e38f));
    }
    int2 stack[kMaxStack];        // (code, bits of the entry distance)
    int sp = 0;
    stack[0] = make_int2(0, 0);   // root, entry distance +0
    bool overflow = false;
    if (kSeeded) {
      const int4 s = __ldg(reinterpret_cast<const int4*>(seeds) + i);
      unsigned long long rest =
          ((unsigned long long)(unsigned)s.y << 32) | (unsigned long long)(unsigned)s.x;
      if (__popcll(rest) <= kWidth) {
        sp = -1;
        unsigned long long lead[2] = {0ull, 0ull};   // m1's bit, m2's bit
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = h ? s.w : s.z;
          if (m >= 0 && m < kTreelets) lead[h] = rest & (1ull << m);
        }
        rest &= ~(lead[0] | lead[1]);
        // the rest from the highest slot down, then m2, then m1
        while (!overflow) {
          unsigned long long bit;
          if (rest) {
            bit = 1ull << (63 - __clzll(rest));
            rest ^= bit;
          } else if (lead[1]) {
            bit = lead[1];
            lead[1] = 0;
          } else if (lead[0]) {
            bit = lead[0];
            lead[0] = 0;
          } else {
            break;
          }
          const int code = __ldg(seed_codes + (__ffsll((long long)bit) - 1));
          if (code >= 0) {
            if (sp + 1 >= stack_cap) overflow = true;
            else stack[++sp] = make_int2(code, 0);
          } else if (code != kPad) {
            test_leaf<kLeaf>(runs, code, o, d, eps, tb, pb);
          }
        }
      }
    }
    if (overflow) {
      atomicOr(err, kErrStack);
      sp = -1;
    }
    while (sp >= 0) {
      if (iters >= max_iters) {
        atomicOr(err, kErrIters);
        break;
      }
      ++iters;
      const int2 e = stack[sp];
      --sp;
      if (!(__int_as_float(e.y) < __fadd_rn(tb, eps))) continue;   // stale entry

      const int4* __restrict__ kid =
          reinterpret_cast<const int4*>(entries + (size_t)e.x * kRowF);
      float key[kWidth];
      int ent[kWidth];
      unsigned leaves = 0, inner = 0;
      const float reach = __fadd_rn(tb, eps);
      unsigned in16 = 0;
      if (kBf16)
        in16 = slab_row_bf16(static_cast<const __nv_bfloat16*>(nodes_raw) + (size_t)e.x * kRowF,
                             inv2, roinv2, bmax2, eps2,
                             bf_round(__fadd_rn(bf_round(tb), eps16)), key);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int4 e4 = __ldg(kid + half);
        ent[4 * half + 0] = e4.x;
        ent[4 * half + 1] = e4.y;
        ent[4 * half + 2] = e4.z;
        ent[4 * half + 3] = e4.w;
        float b[6][4];
        if (!kBf16)
          load_half_boxes(static_cast<const float*>(nodes_raw) + (size_t)e.x * kRowF, half,
                          b);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * half + q;
          bool in;
          if (kBf16) {
            in = (in16 >> c) & 1u;
          } else {
            float t0, t1;
            slab_child<false>(b, q, o, inv, roinv, t0, t1);
            in = enters(t0, t1, eps, reach);
            key[c] = nan_max(t0, 0.f);
          }
          if (in && ent[c] != kPad) {
            if (ent[c] < 0) leaves |= 1u << c;
            else inner |= 1u << c;
          }
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
        test_leaf<kLeaf>(runs, be, o, d, eps, tb, pb);
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
        stack[++sp] = make_int2(be, __float_as_int(bk));
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

// ------------------------- K5a, K5b: the ranged packet walk, a warp a tile --

// The warp's node step: the lanes with `mine` slab-test the 8 children of
// node `code` (kDirect: v1's slab form, else the hoisted one); lane c < 8
// returns child c's entry, the lanes that entered it and the least of their
// keys (the other lanes kPad, no lane, kNoKey). The leaf children some lane
// entered are tested at once, nearest first, by the lanes that entered them.
template <bool kDirect>
__device__ __forceinline__ void ranged_node_step(
    const float* __restrict__ nodes, const int* __restrict__ entries,
    const float* __restrict__ runs, int code, bool mine, const float o[3],
    const float d[3], const float inv[3], const float roinv[3], float eps,
    float& tb, int& pb, int& ent_c, unsigned& mask_c, unsigned& key_c) {
  const int lane = threadIdx.x & 31;
  ent_c = lane < kWidth ? __ldg(entries + (size_t)code * kRowF + lane) : kPad;
  mask_c = 0u;
  key_c = kNoKey;
  const float reach = __fadd_rn(tb, eps);
  unsigned cmask[kWidth], ckey[kWidth];   // warp-uniform
  unsigned leafs = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float b[6][4];
    load_half_boxes(nodes + (size_t)code * kRowF, half, b);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * half + q;
      const int ent = __shfl_sync(kFullMask, ent_c, c);
      bool entered = false;
      float key = 0.f;
      if (mine && ent != kPad) {
        float t0, t1;
        slab_child<kDirect>(b, q, o, inv, roinv, t0, t1);
        entered = enters(t0, t1, eps, reach);
        key = nan_max(t0, 0.f);
      }
      cmask[c] = __ballot_sync(kFullMask, entered);
      ckey[c] = __reduce_min_sync(kFullMask, entered ? key_bits(key) : kNoKey);
      if (cmask[c] && ent < 0) leafs |= 1u << c;
      if (lane == c) {
        mask_c = cmask[c];
        key_c = ckey[c];
      }
    }
  }
  while (leafs) {   // warp-uniform: nearest first, ties to the lower slot
    int bc = 0;
    unsigned bk = kNoKey, bm = 0;
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      if (((leafs >> c) & 1u) && ckey[c] < bk) {
        bc = c;
        bk = ckey[c];
        bm = cmask[c];
      }
    }
    leafs &= ~(1u << bc);
    const int ent = __shfl_sync(kFullMask, ent_c, bc);
    if (((bm >> lane) & 1u) && __uint_as_float(bk) < __fadd_rn(tb, eps))
      test_leaf<kTriScalar>(runs, ent, o, d, eps, tb, pb);
  }
}

// The walk of a warp's 32 rays over its own stack (stack_cap entries of the
// block's shared memory: code, key bits, lane mask, -).
template <bool kDirect>
__device__ __forceinline__ void ranged_walk(
    const float* __restrict__ nodes, const int* __restrict__ entries,
    const float* __restrict__ runs, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t_init,
    const unsigned char* __restrict__ active, float* __restrict__ t_out,
    int* __restrict__ prim_out, int* __restrict__ iters_out,
    int* __restrict__ err, int n, int stack_cap, int max_iters, float eps) {
  extern __shared__ int4 s_stacks[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int4* __restrict__ stack = s_stacks + warp * stack_cap;
  const int i = blockIdx.x * kThreadsPk + threadIdx.x;
  float o[3], d[3], inv[3], roinv[3], tb;
  const bool act = packet_lane(ro, rd, t_init, active, i, n, o, d, inv, roinv, tb);
  int pb = -1;
  const unsigned root = __ballot_sync(kFullMask, act);
  int sp = -1, iters = 0;   // warp-uniform
  if (root) {
    if (lane == 0) stack[0] = make_int4(0, 0, (int)root, 0);
    sp = 0;
  }
  __syncwarp();
  while (sp >= 0) {
    if (iters >= max_iters) {
      if (lane == 0) atomicOr(err, kErrIters);
      break;
    }
    ++iters;
    const int4 e = stack[sp];
    --sp;
    const bool mine = (((unsigned)e.z >> lane) & 1u) &&
                      __int_as_float(e.y) < __fadd_rn(tb, eps);
    if (!__any_sync(kFullMask, mine)) continue;   // stale for every lane
    int ent_c;
    unsigned mask_c, key_c;
    ranged_node_step<kDirect>(nodes, entries, runs, e.x, mine, o, d, inv, roinv, eps,
                              tb, pb, ent_c, mask_c, key_c);
    // lane c ranks its node child among the entered ones by (key, slot) and
    // pushes it, the nearest on top
    const bool node = mask_c != 0u && ent_c >= 0;
    const unsigned inner = __ballot_sync(kFullMask, node);
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const unsigned kj = __shfl_sync(kFullMask, key_c, j);
      if (((inner >> j) & 1u) && (kj < key_c || (kj == key_c && j < lane))) ++rank;
    }
    const int nn = __popc(inner);
    if (sp + nn >= stack_cap) {
      if (lane == 0) atomicOr(err, kErrStack);
      break;
    }
    __syncwarp();   // every lane has read the popped entry
    if (node) stack[sp + nn - rank] = make_int4(ent_c, (int)key_c, (int)mask_c, 0);
    sp += nn;
    __syncwarp();   // the pushes are visible to every lane
  }
  if (i < n) {
    t_out[i] = tb;
    prim_out[i] = pb;
    iters_out[i] = iters;
  }
}

// K5a: the walk with v1's slab form.
__global__ void __launch_bounds__(kThreadsPk)
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
  ranged_walk<true>(nodes, entries, runs, ro, rd, t_init, active, t_out, prim_out,
                    iters_out, err, n, stack_cap, max_iters, eps);
}

// K5b: the walk with the hoisted slab form.
__global__ void __launch_bounds__(kThreadsPk)
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
  ranged_walk<false>(nodes, entries, runs, ro, rd, t_init, active, t_out, prim_out,
                     iters_out, err, n, stack_cap, max_iters, eps);
}

}  // namespace

// Plain C entry for ctypes. nodes/entries/runs: the packed tables (f32 —
// or bf16 when node_bf16 — / i32 / f32, 128 columns); ro, rd: f32[n,3];
// t_init: f32[n]; active: bool[n] (one byte each); seeds, seed_codes: null,
// or K2r's per-ray words i32[n, 4] and the treelet codes i32[64] (ops
// RaySeeds); t_out: f32[n]; prim_out, iters_out:
// i32[n]; err: one i32, zero on entry (bit 1: stack overflow, bit 2: pop
// backstop). leaf_kind 0 = triangles, 1 = spheres; version 2 = K2/K3, 1 =
// K5a, 3 = K5b (triangles only). Seeds and bf16 nodes are K2's modes
// (version 2, triangles): K2r, K2h, and both. stack_cap: at most kMaxStack
// for K2/K3; K5a and K5b size their shared memory by it. All contiguous on
// the current device. Launches on `stream` and returns cudaGetLastError()
// (0 on success) without synchronising, or cudaErrorInvalidValue for a
// version, leaf kind, mode or stack it does not take.
extern "C" int lpt_packet_traverse(const void* nodes, const void* entries,
                                   const void* runs, const void* ro,
                                   const void* rd, const void* t_init,
                                   const void* active, const void* seeds,
                                   const void* seed_codes, void* t_out, void* prim_out,
                                   void* iters_out, void* err, int n, int stack_cap, int max_iters,
                                   float eps, int leaf_kind, int version,
                                   int node_bf16, void* stream) {
  const bool seeded = seeds != nullptr;
  if (version < 1 || version > 3 || leaf_kind < 0 || leaf_kind > 1 ||
      (version != 2 && leaf_kind != 0) || stack_cap < 1 ||
      (version == 2 && stack_cap > kMaxStack) ||
      ((seeded || node_bf16) && (version != 2 || leaf_kind != 0)) ||
      (seeded && seed_codes == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* nf = (const float*)nodes;
  const int* ei = (const int*)entries;
  const float* rf = (const float*)runs;
  const float* rof = (const float*)ro;
  const float* rdf = (const float*)rd;
  const float* tif = (const float*)t_init;
  const unsigned char* ac = (const unsigned char*)active;
  const int* sd = (const int*)seeds;
  const int* sc = (const int*)seed_codes;
  float* to = (float*)t_out;
  int* po = (int*)prim_out;
  int* io = (int*)iters_out;
  int* er = (int*)err;
  const int grid = (n + kThreads - 1) / kThreads;
  if (version != 2) {
    const auto walk = version == 1 ? packet_walk_v1_kernel : packet_walk_v3_kernel;
    const size_t smem = sizeof(int4) * kWarpsPk * (size_t)stack_cap;
    if (smem > 48 * 1024) {   // above the default limit: ask for it, or fail
      const cudaError_t e = cudaFuncSetAttribute(
          (const void*)walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    walk<<<(n + kThreadsPk - 1) / kThreadsPk, kThreadsPk, smem, s>>>(
        nf, ei, rf, rof, rdf, tif, ac, to, po, io, er, n, stack_cap, max_iters, eps);
  } else if (leaf_kind == 1) {
    packet_traverse_kernel<kSpheres, false, false><<<grid, kThreads, 0, s>>>(
        nodes, ei, rf, rof, rdf, tif, ac, sd, sc, to, po, io, er, n, stack_cap, max_iters,
        eps);
  } else {
    const auto k2 = seeded ? (node_bf16 ? packet_traverse_kernel<kTriPairs, true, true>
                                        : packet_traverse_kernel<kTriPairs, true, false>)
                           : (node_bf16 ? packet_traverse_kernel<kTriPairs, false, true>
                                        : packet_traverse_kernel<kTriPairs, false, false>);
    k2<<<grid, kThreads, 0, s>>>(nodes, ei, rf, rof, rdf, tif, ac, sd, sc, to, po, io, er,
                                 n, stack_cap, max_iters, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
