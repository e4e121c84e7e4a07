// Native SAH BVH builder — C ABI, loaded from python via ctypes
// (learn_path_tracing_tpu_torch/accel/native.py, which builds it at first
// use).
//
// Bit-for-bit replica of accel/bvh.py's numpy build_bvh (itself a
// re-implementation of the reference's sweep SAH,
// legacy/PT_in_one_weekend/11_bvh.py:233-329): per node,
// per axis, stable sort of primitive centroids, prefix/suffix AABB sweeps
// in f32, cost = n0*area0 + n1*area1 accumulated in f64, strict-less
// minimum over (axis, split); split while depth < max_depth and
// count > max_leaf. Node ordering matches the python builder exactly
// (children appended in build order), so the two builders are
// interchangeable — tests/test_torch_native_bvh.py asserts array equality.
//
// The float semantics are those of the numpy builder only without
// multiply-add contraction and without host-specific code generation:
// native.py compiles it with -ffp-contract=off and no -march flag.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

static inline double half_area(const Vec3& lo, const Vec3& hi) {
  // matches _half_area: f32 size clamped at 0, products/sums in f64 after
  // f32 subtraction (numpy computes size in f32 then promotes)
  float sx = std::max(hi.x - lo.x, 0.0f);
  float sy = std::max(hi.y - lo.y, 0.0f);
  float sz = std::max(hi.z - lo.z, 0.0f);
  return double(sx) * double(sy) + double(sy) * double(sz) +
         double(sz) * double(sx);
}

struct Builder {
  const Vec3* plow;
  const Vec3* phigh;
  const float* centroid;  // [n,3]
  int n;
  int max_depth, max_leaf;

  std::vector<int32_t> left, right, data;
  std::vector<Vec3> lo, hi;
  std::vector<std::vector<int64_t>> leaves;

  // scratch
  std::vector<int64_t> order;
  std::vector<Vec3> pre_lo, pre_hi, suf_lo, suf_hi;

  void split(const std::vector<int64_t>& idx, std::vector<int64_t>& out_l,
             std::vector<int64_t>& out_r, Vec3& laabb_lo, Vec3& laabb_hi,
             Vec3& raabb_lo, Vec3& raabb_hi) {
    const size_t m = idx.size();
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1;
    size_t best_i = 0;
    std::vector<int64_t> best_order;

    for (int axis = 0; axis < 3; ++axis) {
      order = idx;
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t a, int64_t b) {
                         return centroid[a * 3 + axis] < centroid[b * 3 + axis];
                       });
      pre_lo.resize(m);
      pre_hi.resize(m);
      suf_lo.resize(m);
      suf_hi.resize(m);
      pre_lo[0] = plow[order[0]];
      pre_hi[0] = phigh[order[0]];
      for (size_t i = 1; i < m; ++i) {
        pre_lo[i] = vmin(pre_lo[i - 1], plow[order[i]]);
        pre_hi[i] = vmax(pre_hi[i - 1], phigh[order[i]]);
      }
      suf_lo[m - 1] = plow[order[m - 1]];
      suf_hi[m - 1] = phigh[order[m - 1]];
      for (size_t i = m - 1; i-- > 0;) {
        suf_lo[i] = vmin(suf_lo[i + 1], plow[order[i]]);
        suf_hi[i] = vmax(suf_hi[i + 1], phigh[order[i]]);
      }
      // candidate split after position i (left = order[:i+1])
      double axis_best = std::numeric_limits<double>::infinity();
      size_t axis_i = 0;
      for (size_t i = 0; i + 1 < m; ++i) {
        double c = double(i + 1) * half_area(pre_lo[i], pre_hi[i]) +
                   double(m - i - 1) * half_area(suf_lo[i + 1], suf_hi[i + 1]);
        if (c < axis_best) {
          axis_best = c;
          axis_i = i;
        }
      }
      if (axis_best < best_cost) {
        best_cost = axis_best;
        best_axis = axis;
        best_i = axis_i;
        best_order = order;
      }
    }
    (void)best_axis;
    // recompute the chosen axis' sweeps cheaply from best_order
    const auto& ord = best_order;
    Vec3 L = plow[ord[0]], H = phigh[ord[0]];
    for (size_t i = 1; i <= best_i; ++i) {
      L = vmin(L, plow[ord[i]]);
      H = vmax(H, phigh[ord[i]]);
    }
    laabb_lo = L;
    laabb_hi = H;
    Vec3 L2 = plow[ord[best_i + 1]], H2 = phigh[ord[best_i + 1]];
    for (size_t i = best_i + 2; i < m; ++i) {
      L2 = vmin(L2, plow[ord[i]]);
      H2 = vmax(H2, phigh[ord[i]]);
    }
    raabb_lo = L2;
    raabb_hi = H2;
    out_l.assign(ord.begin(), ord.begin() + best_i + 1);
    out_r.assign(ord.begin() + best_i + 1, ord.end());
  }

  void build() {
    Vec3 rl = plow[0], rh = phigh[0];
    for (int i = 1; i < n; ++i) {
      rl = vmin(rl, plow[i]);
      rh = vmax(rh, phigh[i]);
    }
    left.push_back(-1);
    right.push_back(-1);
    lo.push_back(rl);
    hi.push_back(rh);
    data.push_back(-1);

    std::vector<int> depth{0};
    std::vector<std::vector<int64_t>> sets;
    {
      std::vector<int64_t> all(n);
      for (int i = 0; i < n; ++i) all[i] = i;
      sets.push_back(std::move(all));
    }

    for (size_t i = 0; i < sets.size(); ++i) {
      if (depth[i] < max_depth && sets[i].size() > size_t(max_leaf)) {
        std::vector<int64_t> li, ri;
        Vec3 llo, lhi, rlo2, rhi2;
        split(sets[i], li, ri, llo, lhi, rlo2, rhi2);
        left[i] = int32_t(sets.size());
        left.push_back(-1);
        right.push_back(-1);
        lo.push_back(llo);
        hi.push_back(lhi);
        data.push_back(-1);
        depth.push_back(depth[i] + 1);
        sets.push_back(std::move(li));
        right[i] = int32_t(sets.size());
        left.push_back(-1);
        right.push_back(-1);
        lo.push_back(rlo2);
        hi.push_back(rhi2);
        data.push_back(-1);
        depth.push_back(depth[i] + 1);
        sets.push_back(std::move(ri));
        sets[i].clear();
        sets[i].shrink_to_fit();
      } else {
        data[i] = int32_t(leaves.size());
        leaves.push_back(std::move(sets[i]));
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Output buffers must be sized: nodes <= 2n,
// cut <= n+1, prim == n. out_counts = {n_nodes, n_leaves}.
int lpt_build_bvh(const float* plow, const float* phigh,
                  const float* centroid, int64_t n, int32_t max_depth,
                  int32_t max_leaf, int32_t* out_left, int32_t* out_right,
                  float* out_low, float* out_high, int32_t* out_data,
                  int32_t* out_cut, int32_t* out_prim, int64_t* out_counts) {
  if (n <= 0) return 1;
  Builder b;
  b.plow = reinterpret_cast<const Vec3*>(plow);
  b.phigh = reinterpret_cast<const Vec3*>(phigh);
  b.centroid = centroid;
  b.n = int(n);
  b.max_depth = max_depth;
  b.max_leaf = max_leaf;
  b.build();

  const size_t m = b.left.size();
  std::memcpy(out_left, b.left.data(), m * 4);
  std::memcpy(out_right, b.right.data(), m * 4);
  std::memcpy(out_data, b.data.data(), m * 4);
  std::memcpy(out_low, b.lo.data(), m * 12);
  std::memcpy(out_high, b.hi.data(), m * 12);

  out_cut[0] = 0;
  size_t p = 0;
  for (size_t k = 0; k < b.leaves.size(); ++k) {
    for (int64_t v : b.leaves[k]) out_prim[p++] = int32_t(v);
    out_cut[k + 1] = int32_t(p);
  }
  out_counts[0] = int64_t(m);
  out_counts[1] = int64_t(b.leaves.size());
  return 0;
}

}  // extern "C"
