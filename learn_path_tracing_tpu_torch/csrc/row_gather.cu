// Row gathers for NVIDIA Hopper (sm_90a): out[j] = tab[idx[j]].
//
// Replaces the two TPU kernels of scripts/profile_gather2.py:
//   K6a  vmem_kernel (via vmem_gather): the whole table staged in VMEM and a
//        scalar loop over the 1,024 indices of each grid step;
//   K6b  dma_kernel (via dma_gather): the table left in HBM and a ring of K
//        outstanding row DMAs (K = 8, 16 or 32) into the output block.
// On the mesh path they carry the two row gathers of every hit lane's
// attribute stage: the triangle-attribute row (f32, 128 B) and the strip
// atlas's pair row (bf16 material rows of 512 B, f32 environment rows of
// 1,008 B), plus the atlas's 16-byte info row.
//
// Semantics, shared with the plain version ops/row_gather.py::gather_plain
// (those of jnp.take(tab, idx, axis=0)): an index in [-R, 0) wraps to
// idx + R; any other index outside [0, R) gives a fill row, every 32-bit
// word of it `fill` (NaN for f32 and bf16, INT32_MIN for i32). The kernels
// copy bytes, so the result equals the plain version bit for bit.
//
// Bound: bytes. Each output row is one table row read and one row written,
// plus the index; there is no arithmetic to speak of. Rows are moved as
// 16-byte vectors (the wrapper checks the row width and the alignment),
// table loads go through the read-only path (__ldg).
//
// K6a (rows of at most 128 bytes): one thread per 16-byte vector of the
// output, the VECS threads of a row side by side, so a warp moves 32 / VECS
// rows (four 128-byte rows) in one instruction. The TPU stages the 3 MB
// table in VMEM; Hopper's 227 KB of shared memory cannot hold it and its
// 50 MB L2 holds it anyway, so nothing is staged.
//
// K6b (wider rows): one warp per group of kRowsPerWarp rows, 16 bytes a lane
// per step. Each warp issues the loads of all its rows before any store:
// rows in flight per warp, and many warps per SM, take the place of the
// TPU's ring of outstanding row DMAs.
//
// This version is written to be right and simple; cp.async or TMA staging
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 8;   // K6b: rows whose loads a warp has in flight
constexpr int kNarrowMaxVecs = 8; // K6a: rows of at most 8 x 16 = 128 bytes

// The table row of a raw index, or -1 for a fill row.
template <typename Index>
__device__ __forceinline__ long long resolve(Index raw, long long rows) {
  long long r = (long long)raw;
  if (r < 0) r += rows;
  return (r >= 0 && r < rows) ? r : -1;
}

__device__ __forceinline__ int4 fill_vec(unsigned fill) {
  const int f = (int)fill;
  return make_int4(f, f, f, f);
}

template <int VECS, typename Index>
__global__ void __launch_bounds__(kThreads)
row_gather_narrow_kernel(const int4* __restrict__ tab, const Index* __restrict__ idx,
                         int4* __restrict__ out, long long n, long long rows,
                         unsigned fill) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * VECS) return;
  const long long j = t / VECS;
  const int q = (int)(t - j * VECS);
  const long long r = resolve(__ldg(idx + j), rows);
  out[t] = r >= 0 ? __ldg(tab + r * VECS + q) : fill_vec(fill);
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
row_gather_wide_kernel(const int4* __restrict__ tab, const Index* __restrict__ idx,
                       int4* __restrict__ out, long long n, long long rows, int vecs,
                       unsigned fill) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long j0 = warp * kRowsPerWarp;
  if (j0 >= n) return;
  // every lane reads the group's indices (one broadcast transaction each);
  // -2 marks a slot past the end of the output
  long long r[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k)
    r[k] = j0 + k < n ? resolve(__ldg(idx + j0 + k), rows) : -2;

  for (int q0 = 0; q0 < vecs; q0 += 32) {
    const int q = q0 + lane;
    const bool in_row = q < vecs;
    int4 v[kRowsPerWarp];
    // all loads first ...
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)
      v[k] = (in_row && r[k] >= 0) ? __ldg(tab + r[k] * vecs + q) : fill_vec(fill);
    // ... then the stores
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)
      if (in_row && r[k] != -2) out[(j0 + k) * vecs + q] = v[k];
  }
}

template <typename Index>
cudaError_t launch(const void* tab, const void* idx, void* out, long long n,
                   long long rows, int vecs, unsigned fill, int wide,
                   cudaStream_t stream) {
  const int4* t = (const int4*)tab;
  const Index* i = (const Index*)idx;
  int4* o = (int4*)out;
  if (wide) {
    const long long warps = (n + kRowsPerWarp - 1) / kRowsPerWarp;
    const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
    row_gather_wide_kernel<Index><<<(unsigned)blocks, kThreads, 0, stream>>>(
        t, i, o, n, rows, vecs, fill);
    return cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((n * vecs + kThreads - 1) / kThreads);
  switch (vecs) {
#define LPT_NARROW_CASE(V)                                                     \
  case V:                                                                      \
    row_gather_narrow_kernel<V, Index><<<blocks, kThreads, 0, stream>>>(       \
        t, i, o, n, rows, fill);                                               \
    break;
    LPT_NARROW_CASE(1) LPT_NARROW_CASE(2) LPT_NARROW_CASE(3) LPT_NARROW_CASE(4)
    LPT_NARROW_CASE(5) LPT_NARROW_CASE(6) LPT_NARROW_CASE(7) LPT_NARROW_CASE(8)
#undef LPT_NARROW_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. tab: [rows, vecs * 16 bytes], 16-byte aligned;
// idx: int32 (idx64 = 0) or int64 (idx64 = 1) [n]; out: [n, vecs * 16
// bytes]; all contiguous on the current device, n >= 1. wide = 0 takes K6a
// (vecs <= 8), wide = 1 K6b. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// the kernels do not take, without synchronising.
extern "C" int lpt_row_gather(const void* tab, const void* idx, void* out, long long n,
                              long long rows, int vecs, int idx64, unsigned fill,
                              int wide, void* stream) {
  if (n < 1 || vecs < 1 || (!wide && vecs > kNarrowMaxVecs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(idx64 ? launch<long long>(tab, idx, out, n, rows, vecs, fill, wide, s)
                     : launch<int>(tab, idx, out, n, rows, vecs, fill, wide, s));
}

extern "C" const char* lpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
