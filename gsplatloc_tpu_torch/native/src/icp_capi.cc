// C API of the registration library, for ctypes (gsplatloc_tpu_torch/native):
// normal/covariance estimation, voxel-grid downsampling, tangent-plane colour
// gradients, and ICP / PLANE_ICP / GICP / colored ICP registration over a
// KdTree built by knn_capi.cc. Every parallel loop writes only its own
// points' outputs or joins partials in a fixed order (registration.cc), so
// results do not depend on scheduling. The thread count rides each parallel
// region's num_threads clause, never omp_set_num_threads (the OpenMP runtime
// is shared with PyTorch in the same process).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

#include "capi.h"
#include "registration.h"

using gsl::Mat4;

extern "C" {

// Normals + covariances from k-NN PCA (small_gicp estimate_normals_covariances
// parity: covariance regularized toward the plane model, normal = smallest
// eigenvector). Uses closed-form symmetric 3x3 eigen-decomposition.
static void eig3_sym(const double a[9], double vals[3], double vecs[9]);

void gs_estimate_normals_covs(const GsKdTree* t, int32_t k,
                              int32_t num_threads, double* out_normals,
                              double* out_covs) {
  const int64_t n = t->tree.n;
  const int nt = num_threads > 0 ? num_threads : 1;
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
    std::vector<int32_t> idx(k);
    std::vector<double> d2(k);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
      int found = t->tree.knn(t->pts.data() + 3 * i, k, idx.data(), d2.data());
      double mean[3] = {0, 0, 0};
      for (int j = 0; j < found; ++j) {
        const double* p = t->pts.data() + 3 * idx[j];
        for (int a = 0; a < 3; ++a) mean[a] += p[a];
      }
      for (int a = 0; a < 3; ++a) mean[a] /= std::max(found, 1);
      double C[9] = {0};
      for (int j = 0; j < found; ++j) {
        const double* p = t->pts.data() + 3 * idx[j];
        double d[3] = {p[0] - mean[0], p[1] - mean[1], p[2] - mean[2]};
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) C[3 * a + b] += d[a] * d[b];
      }
      for (int a = 0; a < 9; ++a) C[a] /= std::max(found, 1);
      double vals[3], vecs[9];
      eig3_sym(C, vals, vecs);
      // normal = eigenvector of smallest eigenvalue (vals ascending)
      double* nrm = out_normals + 3 * i;
      nrm[0] = vecs[0];
      nrm[1] = vecs[3];
      nrm[2] = vecs[6];
      // GICP plane-regularized covariance: R diag(eps,1,1) R^T
      if (out_covs) {
        const double e0 = 1e-3;
        double D[3] = {e0, 1.0, 1.0};
        double* Co = out_covs + 9 * i;
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) {
            double s = 0;
            for (int c = 0; c < 3; ++c)
              s += vecs[3 * a + c] * D[c] * vecs[3 * b + c];
            Co[3 * a + b] = s;
          }
      }
    }
  }
}

// Voxel-grid downsample: keep the centroid of each voxel. Returns count.
int64_t gs_voxel_downsample(const double* points, int64_t n, double resolution,
                            double* out_points, int64_t max_out) {
  struct Key {
    int64_t x, y, z;
    bool operator==(const Key& o) const {
      return x == o.x && y == o.y && z == o.z;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return (size_t)(k.x * 73856093LL ^ k.y * 19349669LL ^ k.z * 83492791LL);
    }
  };
  std::unordered_map<Key, std::pair<double[3], int64_t>, KeyHash> grid;
  grid.reserve(n / 4);
  const double inv = 1.0 / resolution;
  for (int64_t i = 0; i < n; ++i) {
    const double* p = points + 3 * i;
    Key key{(int64_t)std::floor(p[0] * inv), (int64_t)std::floor(p[1] * inv),
            (int64_t)std::floor(p[2] * inv)};
    auto& cell = grid[key];
    cell.first[0] += p[0];
    cell.first[1] += p[1];
    cell.first[2] += p[2];
    cell.second += 1;
  }
  int64_t m = 0;
  for (auto& kv : grid) {
    if (m >= max_out) break;
    double* o = out_points + 3 * m;
    for (int a = 0; a < 3; ++a) o[a] = kv.second.first[a] / kv.second.second;
    ++m;
  }
  return m;
}

// Per-target-point intensity gradients on the tangent plane (colored ICP
// precompute): least squares over kNN with the normal-direction constrained
// to zero (Park et al.).
void gs_estimate_color_gradients(const GsKdTree* t, const double* colors,
                                 const double* normals, int32_t k,
                                 int32_t num_threads, double* out_grads) {
  const int64_t n = t->tree.n;
  const int nt = num_threads > 0 ? num_threads : 1;
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
    std::vector<int32_t> idx(k);
    std::vector<double> d2(k);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
      const double* p = t->pts.data() + 3 * i;
      const double* nrm = normals + 3 * i;
      int found = t->tree.knn(p, k, idx.data(), d2.data());
      // solve min ||A g - b|| with rows (p_j' - p_i) (projected) and the
      // constraint row nrm (b = 0) for stability.
      double AtA[9] = {0}, Atb[3] = {0};
      for (int jj = 0; jj < found; ++jj) {
        int32_t j = idx[jj];
        if (j == i) continue;
        const double* pj = t->pts.data() + 3 * j;
        double d[3] = {pj[0] - p[0], pj[1] - p[1], pj[2] - p[2]};
        double dn = d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2];
        double row[3] = {d[0] - dn * nrm[0], d[1] - dn * nrm[1],
                         d[2] - dn * nrm[2]};
        double rhs = colors[j] - colors[i];
        for (int a = 0; a < 3; ++a) {
          Atb[a] += row[a] * rhs;
          for (int b = 0; b < 3; ++b) AtA[3 * a + b] += row[a] * row[b];
        }
      }
      // constraint: g . n = 0 (weight ~ number of neighbors)
      double wc = std::max(found, 1);
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) AtA[3 * a + b] += wc * nrm[a] * nrm[b];
      for (int a = 0; a < 3; ++a) AtA[3 * a + a] += 1e-9;
      gsl::Mat3 M;
      std::memcpy(M.data(), AtA, sizeof(AtA));
      bool ok;
      gsl::Mat3 inv = gsl::invert3(M, &ok);
      double* g = out_grads + 3 * i;
      if (!ok) { g[0] = g[1] = g[2] = 0; continue; }
      for (int a = 0; a < 3; ++a)
        g[a] = inv[3 * a] * Atb[0] + inv[3 * a + 1] * Atb[1] +
               inv[3 * a + 2] * Atb[2];
    }
  }
}

// Registration. type: 0=ICP, 1=PLANE_ICP, 2=GICP, 3=COLORED_ICP.
// target tree must be built over `target`. normals/covs may be null when the
// type doesn't need them. out_T: 4x4 row-major.
void gs_register(const GsKdTree* target_tree, const double* target, int64_t nt,
                 const double* source, int64_t ns,
                 const double* target_normals, const double* target_covs,
                 const double* source_covs, int32_t type, const double* init_T,
                 double max_corr_dist, int32_t max_iters, int32_t num_threads,
                 double* out_T, double* out_error, int32_t* out_iters,
                 int32_t* out_inliers) {
  Mat4 T0;
  std::memcpy(T0.data(), init_T, 16 * sizeof(double));
  auto res = gsl::register_gn(target, nt, target_tree->tree, source, ns,
                              target_normals, target_covs, source_covs,
                              (gsl::RegType)type, T0, max_corr_dist, max_iters,
                              num_threads);
  std::memcpy(out_T, res.T.data(), 16 * sizeof(double));
  *out_error = res.error;
  *out_iters = res.iterations;
  *out_inliers = res.inliers;
}

// Colored variant: extra intensity arrays + precomputed tangent gradients.
void gs_register_colored(
    const GsKdTree* target_tree, const double* target, int64_t nt,
    const double* source, int64_t ns, const double* target_normals,
    const double* target_colors, const double* target_color_grads,
    const double* source_colors, double lambda_geometric,
    const double* init_T, double max_corr_dist, int32_t max_iters,
    int32_t num_threads, double* out_T, double* out_error,
    int32_t* out_iters, int32_t* out_inliers) {
  Mat4 T0;
  std::memcpy(T0.data(), init_T, 16 * sizeof(double));
  gsl::ColoredData cd;
  cd.tgt_colors = target_colors;
  cd.tgt_color_grads = target_color_grads;
  cd.src_colors = source_colors;
  cd.lambda_geometric = lambda_geometric;
  auto res = gsl::register_gn(target, nt, target_tree->tree, source, ns,
                              target_normals, nullptr, nullptr,
                              gsl::kColoredICP, T0, max_corr_dist, max_iters,
                              num_threads, &cd);
  std::memcpy(out_T, res.T.data(), 16 * sizeof(double));
  *out_error = res.error;
  *out_iters = res.iterations;
  *out_inliers = res.inliers;
}

}  // extern "C"

// --- closed-form symmetric 3x3 eigendecomposition (ascending) ---
// Jacobi rotations: robust + tiny, no deps.
static void eig3_sym(const double a_in[9], double vals[3], double vecs[9]) {
  double A[9];
  std::memcpy(A, a_in, sizeof(A));
  double V[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  for (int sweep = 0; sweep < 32; ++sweep) {
    double off = std::fabs(A[1]) + std::fabs(A[2]) + std::fabs(A[5]);
    if (off < 1e-15) break;
    static const int pq[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (auto& idx : pq) {
      int p = idx[0], q = idx[1];
      double apq = A[3 * p + q];
      if (std::fabs(apq) < 1e-18) continue;
      double app = A[3 * p + p], aqq = A[3 * q + q];
      double theta = 0.5 * (aqq - app) / apq;
      double t = (theta >= 0 ? 1.0 : -1.0) /
                 (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
      double c = 1.0 / std::sqrt(t * t + 1.0);
      double s = t * c;
      for (int k = 0; k < 3; ++k) {
        double akp = A[3 * k + p], akq = A[3 * k + q];
        A[3 * k + p] = c * akp - s * akq;
        A[3 * k + q] = s * akp + c * akq;
      }
      for (int k = 0; k < 3; ++k) {
        double apk = A[3 * p + k], aqk = A[3 * q + k];
        A[3 * p + k] = c * apk - s * aqk;
        A[3 * q + k] = s * apk + c * aqk;
      }
      for (int k = 0; k < 3; ++k) {
        double vkp = V[3 * k + p], vkq = V[3 * k + q];
        V[3 * k + p] = c * vkp - s * vkq;
        V[3 * k + q] = s * vkp + c * vkq;
      }
    }
  }
  int order[3] = {0, 1, 2};
  double d[3] = {A[0], A[4], A[8]};
  // ascending insertion sort
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && d[order[j]] < d[order[j - 1]]; --j)
      std::swap(order[j], order[j - 1]);
  for (int i = 0; i < 3; ++i) {
    vals[i] = d[order[i]];
    for (int k = 0; k < 3; ++k) vecs[3 * k + i] = V[3 * k + order[i]];
  }
}
