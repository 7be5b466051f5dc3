#include "registration.h"

#include <vector>

namespace gsl {

namespace {

// skew(v) * M helpers for the jacobian d(Rp + t)/d[w, v] = [-[Tp]x | I]
inline void skew(const double* v, Mat3& S) {
  S = {0, -v[2], v[1], v[2], 0, -v[0], -v[1], v[0], 0};
}

struct Accum {
  double H[36] = {0};
  double g[6] = {0};
  double err = 0;
  int inliers = 0;

  void add(const Accum& o) {
    for (int i = 0; i < 36; ++i) H[i] += o.H[i];
    for (int i = 0; i < 6; ++i) g[i] += o.g[i];
    err += o.err;
    inliers += o.inliers;
  }

  // rank-1 (or rank-3) update from residual r (dim d), jacobian J (d x 6),
  // weight W (d x d) — specialized below.
};

}  // namespace

RegResult register_gn(const double* tgt, int64_t nt, const KdTree& tree,
                      const double* src, int64_t ns,
                      const double* tgt_normals, const double* tgt_covs,
                      const double* src_covs, RegType type,
                      const Mat4& init_T, double max_corr_dist, int max_iters,
                      int num_threads, const ColoredData* colored) {
  RegResult res;
  res.T = init_T;
  const double max_d2 = max_corr_dist * max_corr_dist;
  (void)nt;

  // the thread count rides the parallel region's num_threads clause, never
  // omp_set_num_threads: the OpenMP runtime is shared with PyTorch in the
  // same process, and its global thread count is torch's own
  const int nparts = num_threads > 0 ? num_threads : 1;
  std::vector<Accum> parts(nparts);

  for (int iter = 0; iter < max_iters; ++iter) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(nparts)
#endif
    for (int part = 0; part < nparts; ++part) {
      Accum local;
      const int64_t lo = ns * part / nparts, hi = ns * (part + 1) / nparts;
      for (int64_t i = lo; i < hi; ++i) {
        const double* p = src + 3 * i;
        double tp[3];
        transform_point(res.T, p, tp);
        double d2;
        int32_t j = tree.nearest(tp, max_d2, &d2);
        if (j < 0) continue;
        const double* q = tgt + 3 * j;
        double r3[3] = {tp[0] - q[0], tp[1] - q[1], tp[2] - q[2]};
        // J = [ -[tp]x | I ]  (left perturbation on T)
        Mat3 S;
        skew(tp, S);
        double J[3][6];
        for (int a = 0; a < 3; ++a) {
          for (int b = 0; b < 3; ++b) J[a][b] = -S[3 * a + b];
          for (int b = 0; b < 3; ++b) J[a][3 + b] = (a == b) ? 1.0 : 0.0;
        }
        if (type == kICP) {
          for (int a = 0; a < 3; ++a) {
            for (int b = 0; b < 6; ++b) {
              local.g[b] += J[a][b] * r3[a];
              for (int c = b; c < 6; ++c)
                local.H[6 * b + c] += J[a][b] * J[a][c];
            }
          }
          local.err += r3[0] * r3[0] + r3[1] * r3[1] + r3[2] * r3[2];
        } else if (type == kPlaneICP) {
          const double* nrm = tgt_normals + 3 * j;
          double rn = nrm[0] * r3[0] + nrm[1] * r3[1] + nrm[2] * r3[2];
          double Jn[6];
          for (int b = 0; b < 6; ++b)
            Jn[b] = nrm[0] * J[0][b] + nrm[1] * J[1][b] + nrm[2] * J[2][b];
          for (int b = 0; b < 6; ++b) {
            local.g[b] += Jn[b] * rn;
            for (int c = b; c < 6; ++c) local.H[6 * b + c] += Jn[b] * Jn[c];
          }
          local.err += rn * rn;
        } else if (type == kColoredICP) {
          // Park et al. colored registration: point-to-plane term + color
          // term on the target tangent plane (Open3D weighting
          // lambda_geometric for the geometric part).
          const double* nrm = tgt_normals + 3 * j;
          const double lam = colored->lambda_geometric;
          const double sg = std::sqrt(lam);
          const double sc = std::sqrt(1.0 - lam);
          // geometric point-to-plane
          double rn = nrm[0] * r3[0] + nrm[1] * r3[1] + nrm[2] * r3[2];
          double Jn[6];
          for (int b = 0; b < 6; ++b)
            Jn[b] = sg * (nrm[0] * J[0][b] + nrm[1] * J[1][b] +
                          nrm[2] * J[2][b]);
          double rg = sg * rn;
          for (int b = 0; b < 6; ++b) {
            local.g[b] += Jn[b] * rg;
            for (int c = b; c < 6; ++c) local.H[6 * b + c] += Jn[b] * Jn[c];
          }
          local.err += rg * rg;
          // color term: predicted intensity on the tangent plane at q
          const double* grad = colored->tgt_color_grads + 3 * j;
          double c_t = colored->tgt_colors[j];
          double c_s = colored->src_colors[i];
          // projection of tp onto the tangent plane: tp - n (n . (tp - q))
          double proj[3];
          for (int a = 0; a < 3; ++a) proj[a] = tp[a] - nrm[a] * rn;
          double pred = c_t + grad[0] * (proj[0] - q[0]) +
                        grad[1] * (proj[1] - q[1]) +
                        grad[2] * (proj[2] - q[2]);
          double rc = sc * (pred - c_s);
          // d pred / d tp = grad^T (I - n n^T)
          double gn = grad[0] * nrm[0] + grad[1] * nrm[1] + grad[2] * nrm[2];
          double geff[3];
          for (int a = 0; a < 3; ++a) geff[a] = grad[a] - gn * nrm[a];
          double Jc[6];
          for (int b = 0; b < 6; ++b)
            Jc[b] = sc * (geff[0] * J[0][b] + geff[1] * J[1][b] +
                          geff[2] * J[2][b]);
          for (int b = 0; b < 6; ++b) {
            local.g[b] += Jc[b] * rc;
            for (int c = b; c < 6; ++c) local.H[6 * b + c] += Jc[b] * Jc[c];
          }
          local.err += rc * rc;
        } else {  // GICP: W = (C_q + R C_p R^T)^-1
          const double* Cq = tgt_covs + 9 * j;
          const double* Cp = src_covs + 9 * i;
          // RCpRT
          const double* R0 = res.T.data();
          double RC[9], RCR[9];
          for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b) {
              double s = 0;
              for (int k = 0; k < 3; ++k) s += R0[4 * a + k] * Cp[3 * k + b];
              RC[3 * a + b] = s;
            }
          for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b) {
              double s = 0;
              for (int k = 0; k < 3; ++k) s += RC[3 * a + k] * R0[4 * b + k];
              RCR[3 * a + b] = s;
            }
          Mat3 M;
          for (int a = 0; a < 9; ++a) M[a] = Cq[a] + RCR[a];
          bool ok;
          Mat3 Wm = invert3(M, &ok);
          if (!ok) continue;
          double Wr[3];
          for (int a = 0; a < 3; ++a)
            Wr[a] = Wm[3 * a] * r3[0] + Wm[3 * a + 1] * r3[1] +
                    Wm[3 * a + 2] * r3[2];
          double WJ[3][6];
          for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 6; ++b)
              WJ[a][b] = Wm[3 * a] * J[0][b] + Wm[3 * a + 1] * J[1][b] +
                         Wm[3 * a + 2] * J[2][b];
          for (int b = 0; b < 6; ++b) {
            double s = 0;
            for (int a = 0; a < 3; ++a) s += J[a][b] * Wr[a];
            local.g[b] += s;
            for (int c = b; c < 6; ++c) {
              double h = 0;
              for (int a = 0; a < 3; ++a) h += J[a][b] * WJ[a][c];
              local.H[6 * b + c] += h;
            }
          }
          local.err += r3[0] * Wr[0] + r3[1] * Wr[1] + r3[2] * Wr[2];
        }
        local.inliers += 1;
      }
      parts[part] = local;
    }
    // the partials joined in range order (not as threads finish)
    Accum total;
    for (const Accum& p : parts) total.add(p);

    // symmetrize H
    for (int b = 0; b < 6; ++b)
      for (int c = 0; c < b; ++c) total.H[6 * b + c] = total.H[6 * c + b];
    // Levenberg damping floor for stability
    for (int b = 0; b < 6; ++b) total.H[6 * b + b] += 1e-9;

    double dx[6];
    if (total.inliers < 6 || !solve6(total.H, total.g, dx)) {
      res.error = total.err;
      res.inliers = total.inliers;
      res.iterations = iter;
      return res;
    }
    res.T = mat4_mul(se3_exp(dx), res.T);
    res.error = total.err;
    res.inliers = total.inliers;
    res.iterations = iter + 1;
    double step2 = 0;
    for (int b = 0; b < 6; ++b) step2 += dx[b] * dx[b];
    if (step2 < 1e-12) {
      res.converged = true;
      break;
    }
  }
  return res;
}

}  // namespace gsl
