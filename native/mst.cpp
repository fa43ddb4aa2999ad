// Native MST + single-linkage builders for annembed_tpu.estimators.hdbscan.
//
// The MST union loop and the dendrogram build are inherently sequential
// (each union depends on all previous ones), so they live here on the
// C++ side — the analogue of the reference keeping its
// hdbscan/kruskal (kruskal.rs) on the CPU — while all graph-side array
// work stays on device.  C ABI, consumed via ctypes with a
// numpy/Python fallback in estimators/hdbscan.py.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

// Path-halving union-find (mirrors the Python UnionFind semantics).
struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int32_t> rank;
  explicit UnionFind(int64_t n) : parent(n), rank(n, 0) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int64_t find(int64_t i) {
    while (parent[i] != i) {
      parent[i] = parent[parent[i]];
      i = parent[i];
    }
    return i;
  }
  bool unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return false;
    if (rank[ra] < rank[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    if (rank[ra] == rank[rb]) ++rank[ra];
    return true;
  }
};

}  // namespace

extern "C" {

// Kruskal MST/forest of a kNN graph.
//   idx:  (n, k) int32 neighbour ids
//   dist: (n, k) float32 weights
//   out:  caller-allocated (n-1) * 3 doubles; rows [src, dst, w],
//         weight-ascending (stable in edge order, matching numpy's
//         stable argsort tie behaviour)
//   out_m: number of MST rows written (n - #components)
// Returns 0 on success.
int32_t annembed_kruskal(const int32_t* idx, const float* dist, int64_t n,
                         int64_t k, double* out, int64_t* out_m) {
  if (n <= 0 || k <= 0) {
    *out_m = 0;
    return 0;
  }
  const int64_t e = n * k;
  // validate neighbour ids: an out-of-range id (stale/corrupt
  // checkpoint) would index UnionFind storage out of bounds — OOB
  // reads plus path-halving OOB WRITES — and silently return a
  // plausible-looking MST; fail with rc=2 instead (the Python wrapper
  // falls back to the checked numpy path, which raises)
  for (int64_t i = 0; i < e; ++i) {
    if (idx[i] < 0 || idx[i] >= n) {
      *out_m = 0;
      return 2;
    }
  }
  std::vector<int64_t> order(e);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [dist](int64_t a, int64_t b) {
    return dist[a] < dist[b];
  });
  UnionFind uf(n);
  int64_t m = 0;
  for (int64_t oi = 0; oi < e && m < n - 1; ++oi) {
    const int64_t ei = order[oi];
    const int64_t s = ei / k;
    const int64_t d = idx[ei];
    if (uf.unite(s, d)) {
      out[m * 3 + 0] = static_cast<double>(s);
      out[m * 3 + 1] = static_cast<double>(d);
      out[m * 3 + 2] = static_cast<double>(dist[ei]);
      ++m;
    }
  }
  *out_m = m;
  return 0;
}

// scipy-style linkage matrix from weight-ascending MST rows.
//   mst:     (m, 3) doubles [src, dst, w]
//   linkage: caller-allocated (m, 4) doubles; row i merges condensed
//            labels [a, b] at distance w into cluster n + i of the
//            written size (same contract as Python single_linkage)
int32_t annembed_linkage(const double* mst, int64_t m, int64_t n,
                         double* linkage) {
  UnionFind uf(n);
  std::vector<int64_t> label_of_root(n);
  std::iota(label_of_root.begin(), label_of_root.end(), 0);
  std::vector<int64_t> size_of_label(n + m, 1);
  for (int64_t row = 0; row < m; ++row) {
    const int64_t a = static_cast<int64_t>(mst[row * 3 + 0]);
    const int64_t b = static_cast<int64_t>(mst[row * 3 + 1]);
    const double w = mst[row * 3 + 2];
    const int64_t ra = uf.find(a), rb = uf.find(b);
    if (ra == rb) return 1;  // malformed MST (cycle)
    const int64_t la = label_of_root[ra], lb = label_of_root[rb];
    const int64_t nl = n + row;
    size_of_label[nl] = size_of_label[la] + size_of_label[lb];
    linkage[row * 4 + 0] = static_cast<double>(la);
    linkage[row * 4 + 1] = static_cast<double>(lb);
    linkage[row * 4 + 2] = w;
    linkage[row * 4 + 3] = static_cast<double>(size_of_label[nl]);
    uf.unite(ra, rb);
    label_of_root[uf.find(ra)] = nl;
  }
  return 0;
}

// Condensed tree at min_cluster_size from a linkage matrix (the
// faithful native port of estimators/hdbscan.py::condensed_tree,
// including its forest handling; outputs are identical).
//   linkage: (m, 4) doubles [a, b, w, size]
//   rows:    caller-allocated (n + 2m + 2) * 4 doubles
//            [parent, child, lambda, size]
//   out_r:   rows written
int32_t annembed_condense(const double* linkage, int64_t m, int64_t n,
                          int64_t min_cluster_size, double min_edge,
                          double* rows, int64_t* out_r) {
  *out_r = 0;
  if (m <= 0 || min_cluster_size < 2) return m <= 0 ? 0 : 1;
  auto node_size = [&](int64_t v) -> int64_t {
    return v < n ? 1 : static_cast<int64_t>(linkage[(v - n) * 4 + 3]);
  };
  int64_t r = 0;
  auto emit = [&](int64_t parent, int64_t child, double lam, int64_t size) {
    rows[r * 4 + 0] = static_cast<double>(parent);
    rows[r * 4 + 1] = static_cast<double>(child);
    rows[r * 4 + 2] = lam;
    rows[r * 4 + 3] = static_cast<double>(size);
    ++r;
  };
  // points of a subtree, via explicit stack
  std::vector<int64_t> pt_stack;
  auto emit_subtree_points = [&](int64_t v, int64_t parent, double lam) {
    pt_stack.push_back(v);
    while (!pt_stack.empty()) {
      const int64_t u = pt_stack.back();
      pt_stack.pop_back();
      if (u < n) {
        emit(parent, u, lam, 1);
      } else {
        pt_stack.push_back(static_cast<int64_t>(linkage[(u - n) * 4 + 0]));
        pt_stack.push_back(static_cast<int64_t>(linkage[(u - n) * 4 + 1]));
      }
    }
  };
  // forest roots: internal nodes never referenced as a child
  std::vector<bool> referenced(n + m, false);
  for (int64_t i = 0; i < m; ++i) {
    referenced[static_cast<int64_t>(linkage[i * 4 + 0])] = true;
    referenced[static_cast<int64_t>(linkage[i * 4 + 1])] = true;
  }
  std::vector<int64_t> roots;
  for (int64_t i = 0; i < m; ++i)
    if (!referenced[n + i]) roots.push_back(n + i);
  int64_t next_label = n + 1;
  std::vector<std::pair<int64_t, int64_t>> stack;  // (node, condensed label)
  if (roots.size() == 1) {
    stack.emplace_back(roots[0], n);
  } else {
    for (const int64_t rt : roots) {
      if (node_size(rt) < min_cluster_size) continue;
      const double lam_top = 1.0 / std::max(linkage[(rt - n) * 4 + 2],
                                            min_edge);
      emit(n, next_label, lam_top, node_size(rt));
      stack.emplace_back(rt, next_label);
      ++next_label;
    }
  }
  while (!stack.empty()) {
    const auto [v, label] = stack.back();
    stack.pop_back();
    const int64_t left = static_cast<int64_t>(linkage[(v - n) * 4 + 0]);
    const int64_t right = static_cast<int64_t>(linkage[(v - n) * 4 + 1]);
    const double lam = 1.0 / std::max(linkage[(v - n) * 4 + 2], min_edge);
    const int64_t sl = node_size(left), sr = node_size(right);
    if (sl >= min_cluster_size && sr >= min_cluster_size) {
      emit(label, next_label, lam, sl);
      stack.emplace_back(left, next_label);
      ++next_label;
      emit(label, next_label, lam, sr);
      stack.emplace_back(right, next_label);
      ++next_label;
    } else {
      if (sl >= min_cluster_size) stack.emplace_back(left, label);
      else emit_subtree_points(left, label, lam);
      if (sr >= min_cluster_size) stack.emplace_back(right, label);
      else emit_subtree_points(right, label, lam);
    }
  }
  *out_r = r;
  return 0;
}

}  // extern "C"
