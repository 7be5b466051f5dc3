// KdTree + kNN for 3D point clouds (C++17, no external deps).
//
// The exact kNN behind the scale init of the frozen Gaussian scene: build
// a tree, then batch kNN queries returning indices and SQUARED distances
// (the small_gicp convention the method was written against). Median-split
// build over index arrays, bounded-heap kNN with branch-and-bound
// traversal; queries run in parallel with OpenMP (knn_capi.cc).
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

namespace gsl {

struct KdTree {
  // Flat node layout: internal nodes store split axis/value; leaves store an
  // index range into `order`.
  struct Node {
    float split_val = 0.f;
    int32_t axis = -1;       // -1 => leaf
    int32_t left = -1, right = -1;
    int32_t begin = 0, end = 0;  // leaf range in `order`
  };

  const double* pts = nullptr;  // (n, 3) row-major, not owned
  int64_t n = 0;
  std::vector<int32_t> order;
  std::vector<Node> nodes;
  static constexpr int kLeafSize = 16;

  void build(const double* points, int64_t num) {
    pts = points;
    n = num;
    order.resize(n);
    std::iota(order.begin(), order.end(), 0);
    nodes.clear();
    nodes.reserve(2 * (n / kLeafSize + 1));
    if (n > 0) build_range(0, (int32_t)n);
  }

  int32_t build_range(int32_t begin, int32_t end) {
    int32_t id = (int32_t)nodes.size();
    nodes.emplace_back();
    if (end - begin <= kLeafSize) {
      nodes[id].begin = begin;
      nodes[id].end = end;
      return id;
    }
    // pick widest axis
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (int32_t i = begin; i < end; ++i) {
      const double* p = pts + 3 * order[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], p[a]);
        hi[a] = std::max(hi[a], p[a]);
      }
    }
    int axis = 0;
    double w = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > w) { w = hi[a] - lo[a]; axis = a; }
    int32_t mid = (begin + end) / 2;
    std::nth_element(order.begin() + begin, order.begin() + mid,
                     order.begin() + end, [&](int32_t a, int32_t b) {
                       return pts[3 * a + axis] < pts[3 * b + axis];
                     });
    nodes[id].axis = axis;
    nodes[id].split_val = (float)pts[3 * order[mid] + axis];
    int32_t l = build_range(begin, mid);
    int32_t r = build_range(mid, end);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  // k nearest neighbors of query q; writes k (index, sq_dist) pairs sorted
  // ascending. Returns number found (== min(k, n)).
  int knn(const double* q, int k, int32_t* out_idx, double* out_d2) const {
    if (n == 0 || k <= 0) return 0;
    k = std::min<int64_t>(k, n);
    // max-heap over (d2, idx): stack storage for small k — this runs once
    // per source point per GN iteration (nearest) and once per point in
    // normal estimation; a per-query std::vector is millions of
    // malloc/free pairs that also serialize on the allocator under OpenMP
    constexpr int KSTACK = 128;
    std::pair<double, int32_t> sbuf[KSTACK];
    std::vector<std::pair<double, int32_t>> vbuf;
    std::pair<double, int32_t>* heap = sbuf;
    if (k > KSTACK) {
      vbuf.resize(k);
      heap = vbuf.data();
    }
    int hs = 0;
    double worst = std::numeric_limits<double>::infinity();

    // iterative traversal with explicit stack of (node, min possible d2)
    struct Item { int32_t node; double bound; };
    Item stack[128];
    int sp = 0;
    stack[sp++] = {0, 0.0};
    while (sp > 0) {
      Item it = stack[--sp];
      if (it.bound >= worst) continue;
      const Node& nd = nodes[it.node];
      if (nd.axis < 0) {
        for (int32_t i = nd.begin; i < nd.end; ++i) {
          const double* p = pts + 3 * order[i];
          double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
          double d2 = dx * dx + dy * dy + dz * dz;
          if (hs < k) {
            heap[hs++] = {d2, order[i]};
            std::push_heap(heap, heap + hs);
            if (hs == k) worst = heap[0].first;
          } else if (d2 < worst) {
            std::pop_heap(heap, heap + hs);
            heap[hs - 1] = {d2, order[i]};
            std::push_heap(heap, heap + hs);
            worst = heap[0].first;
          }
        }
        continue;
      }
      double diff = q[nd.axis] - nd.split_val;
      int32_t near = diff <= 0 ? nd.left : nd.right;
      int32_t far = diff <= 0 ? nd.right : nd.left;
      double far_bound = diff * diff;
      if (sp < 126) {
        if (far_bound < worst) stack[sp++] = {far, far_bound};
        stack[sp++] = {near, 0.0};
      }
    }
    std::sort_heap(heap, heap + hs);
    for (int i = 0; i < hs; ++i) {
      out_d2[i] = heap[i].first;
      out_idx[i] = heap[i].second;
    }
    return hs;
  }

  // nearest neighbor with early-out distance bound; returns idx or -1
  int32_t nearest(const double* q, double max_d2, double* out_d2) const {
    int32_t idx;
    double d2;
    if (knn(q, 1, &idx, &d2) == 0 || d2 > max_d2) return -1;
    *out_d2 = d2;
    return idx;
  }
};

}  // namespace gsl
