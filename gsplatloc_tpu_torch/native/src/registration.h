// Gauss-Newton point-cloud registration: ICP / point-to-plane / GICP /
// colored ICP, the classical baselines of the ICP sweep (tracking/icp.py):
// nearest-neighbor correspondences within a max distance, SE(3)
// Gauss-Newton updates, a small fixed iteration budget (small_gicp's
// align() and Open3D's ICP family are what the baselines stand for).
//
// Deterministic: the source points are cut into num_threads fixed ranges,
// each range sums its own partial normal equations, and the partials are
// added in range order, so a run repeats bit for bit at a given thread
// count.
#pragma once

#include <array>
#include <cmath>
#include <cstring>

#include "kdtree.h"

namespace gsl {

using Mat4 = std::array<double, 16>;   // row-major 4x4
using Mat3 = std::array<double, 9>;    // row-major 3x3

inline void mat4_identity(Mat4& m) {
  m.fill(0.0);
  m[0] = m[5] = m[10] = m[15] = 1.0;
}

inline Mat4 mat4_mul(const Mat4& a, const Mat4& b) {
  Mat4 c{};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a[4 * i + k] * b[4 * k + j];
      c[4 * i + j] = s;
    }
  return c;
}

inline void transform_point(const Mat4& T, const double* p, double* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = T[4 * i] * p[0] + T[4 * i + 1] * p[1] + T[4 * i + 2] * p[2] +
             T[4 * i + 3];
}

// exp of se(3) twist [w, v] (rotation-first), Rodrigues.
inline Mat4 se3_exp(const double* xi) {
  const double wx = xi[0], wy = xi[1], wz = xi[2];
  const double vx = xi[3], vy = xi[4], vz = xi[5];
  double th2 = wx * wx + wy * wy + wz * wz;
  double th = std::sqrt(th2);
  double A, B, C;
  if (th < 1e-9) {
    A = 1.0 - th2 / 6.0;
    B = 0.5 - th2 / 24.0;
    C = 1.0 / 6.0 - th2 / 120.0;
  } else {
    A = std::sin(th) / th;
    B = (1.0 - std::cos(th)) / th2;
    C = (1.0 - A) / th2;
  }
  // R = I + A W + B W^2 ; V = I + B W + C W^2
  Mat3 W = {0, -wz, wy, wz, 0, -wx, -wy, wx, 0};
  Mat3 W2{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += W[3 * i + k] * W[3 * k + j];
      W2[3 * i + j] = s;
    }
  Mat4 T;
  mat4_identity(T);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T[4 * i + j] = (i == j ? 1.0 : 0.0) + A * W[3 * i + j] + B * W2[3 * i + j];
    }
  double V[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      V[3 * i + j] = (i == j ? 1.0 : 0.0) + B * W[3 * i + j] + C * W2[3 * i + j];
  T[3] = V[0] * vx + V[1] * vy + V[2] * vz;
  T[7] = V[3] * vx + V[4] * vy + V[5] * vz;
  T[11] = V[6] * vx + V[7] * vy + V[8] * vz;
  return T;
}

// Solve 6x6 SPD system H x = -g by Cholesky (in place). Returns false if
// not positive definite.
inline bool solve6(double H[36], double g[6], double x[6]) {
  double L[36] = {0};
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = H[6 * i + j];
      for (int k = 0; k < j; ++k) s -= L[6 * i + k] * L[6 * j + k];
      if (i == j) {
        if (s <= 1e-12) return false;
        L[6 * i + j] = std::sqrt(s);
      } else {
        L[6 * i + j] = s / L[6 * j + j];
      }
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double s = -g[i];
    for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
    y[i] = s / L[6 * i + i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
    x[i] = s / L[6 * i + i];
  }
  return true;
}

inline Mat3 invert3(const Mat3& m, bool* ok) {
  double det = m[0] * (m[4] * m[8] - m[5] * m[7]) -
               m[1] * (m[3] * m[8] - m[5] * m[6]) +
               m[2] * (m[3] * m[7] - m[4] * m[6]);
  Mat3 inv{};
  if (std::fabs(det) < 1e-18) {
    *ok = false;
    return inv;
  }
  double id = 1.0 / det;
  inv[0] = (m[4] * m[8] - m[5] * m[7]) * id;
  inv[1] = (m[2] * m[7] - m[1] * m[8]) * id;
  inv[2] = (m[1] * m[5] - m[2] * m[4]) * id;
  inv[3] = (m[5] * m[6] - m[3] * m[8]) * id;
  inv[4] = (m[0] * m[8] - m[2] * m[6]) * id;
  inv[5] = (m[2] * m[3] - m[0] * m[5]) * id;
  inv[6] = (m[3] * m[7] - m[4] * m[6]) * id;
  inv[7] = (m[1] * m[6] - m[0] * m[7]) * id;
  inv[8] = (m[0] * m[4] - m[1] * m[3]) * id;
  *ok = true;
  return inv;
}

enum RegType { kICP = 0, kPlaneICP = 1, kGICP = 2, kColoredICP = 3 };

struct RegResult {
  Mat4 T;          // T_target_source
  double error = 0;
  int iterations = 0;
  int inliers = 0;
  bool converged = false;
};

// target: points (+normals for PLANE/COLORED, +covs for GICP, +colors and
// color gradients for COLORED); source: points (+covs for GICP, +colors for
// COLORED). covs are 3x3 row-major per point; colors are scalar intensities.
struct ColoredData {
  const double* tgt_colors = nullptr;      // (nt,)
  const double* tgt_color_grads = nullptr; // (nt, 3) tangent-plane gradients
  const double* src_colors = nullptr;      // (ns,)
  double lambda_geometric = 0.968;         // Open3D default weighting
};

RegResult register_gn(const double* tgt, int64_t nt, const KdTree& tree,
                      const double* src, int64_t ns,
                      const double* tgt_normals, const double* tgt_covs,
                      const double* src_covs, RegType type,
                      const Mat4& init_T, double max_corr_dist, int max_iters,
                      int num_threads,
                      const ColoredData* colored = nullptr);

}  // namespace gsl
