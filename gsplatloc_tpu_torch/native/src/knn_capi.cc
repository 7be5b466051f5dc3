// C API of the exact kNN, for ctypes (gsplatloc_tpu_torch/native).
//
// Build the KdTree over an (n, 3) float64 cloud and answer a batch of kNN
// queries: k indices and SQUARED distances per query, ascending, the query
// itself included when it is a tree point. Queries run in parallel with
// OpenMP; each writes only its own output rows, so the result does not
// depend on the thread count. The thread count rides the parallel region's
// num_threads clause, never omp_set_num_threads: the OpenMP runtime is
// shared with PyTorch in the same process, and setting its global thread
// count would change torch's own.

#include <cmath>
#include <cstdint>
#include <vector>

#include "kdtree.h"

using gsl::KdTree;

extern "C" {

struct GsKdTree {
  std::vector<double> pts;  // owned copy
  KdTree tree;
};

GsKdTree* gs_kdtree_build(const double* points, int64_t n) {
  auto* t = new GsKdTree();
  t->pts.assign(points, points + 3 * n);
  t->tree.build(t->pts.data(), n);
  return t;
}

void gs_kdtree_free(GsKdTree* t) { delete t; }

void gs_kdtree_batch_knn(const GsKdTree* t, const double* queries, int64_t nq,
                         int32_t k, int32_t num_threads, int32_t* out_idx,
                         double* out_sq_dists) {
  const int nt = num_threads > 0 ? num_threads : 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(nt)
#endif
  for (int64_t i = 0; i < nq; ++i) {
    int found = t->tree.knn(queries + 3 * i, k, out_idx + (size_t)i * k,
                            out_sq_dists + (size_t)i * k);
    for (int j = found; j < k; ++j) {
      out_idx[(size_t)i * k + j] = -1;
      out_sq_dists[(size_t)i * k + j] = INFINITY;
    }
  }
}

}  // extern "C"
