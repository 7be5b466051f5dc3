// Shared per-slot pose-path math of every kernel in this directory:
// projection of an isotropic splat with the current camera (project_parts),
// the 8-row packing with the validity gate (project8_rows), the tile-local
// sigma polynomial (coeff_mat / sub_alpha) and the chain from d_sigma
// moments to the 12 pose partials (pose_chain).
//
// The operation ORDER follows the plain PyTorch forms in
// ops/fused_tracking.py and ops/fused_subtile.py term by term, and the
// library is compiled with -fmad=false: the alpha / transmittance / sigma
// gates are knife edges, and only identical rounding keeps a kernel and its
// plain version on the same side of them.
#pragma once

#include <cuda_runtime.h>

namespace gsl {

constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.999;
constexpr float ONE_MINUS_ALPHA_MAX = (float)(1.0 - 0.999);
constexpr float T_EPS = (float)1e-4;
constexpr float SIG_EPS = (float)1e-2;
constexpr float EPS2D = (float)0.3;
constexpr float FOV_CLAMP = (float)(1.3 * 0.5);

// pixel layout: 16x16 sub-tiles inside 16x128 macro tiles, flattened
// sub-tile-major (global row-major sub-tile order, r*SUB_W + c inside)
constexpr int SUB_H = 16;
constexpr int SUB_W = 16;
constexpr int P_SUB = SUB_H * SUB_W;
constexpr int N_SUB_X = 8;
constexpr int CHUNK = 128;

struct Cam {
    float fx, fy, cx, cy;
    float r[9];
    float t[3];
    float w, h;
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ cam) {
    Cam c;
    c.fx = __ldg(cam + 0);
    c.fy = __ldg(cam + 1);
    c.cx = __ldg(cam + 2);
    c.cy = __ldg(cam + 3);
#pragma unroll
    for (int i = 0; i < 9; ++i) c.r[i] = __ldg(cam + 4 + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) c.t[i] = __ldg(cam + 13 + i);
    c.w = __ldg(cam + 16);
    c.h = __ldg(cam + 17);
    return c;
}

struct Proj {
    float qx, qy, qz, zs, iz, u, v;
    float j00, j02, j11, j12, txc, tyc;
    float a, b, c, inv_det, ca, cb, cc;
    float x, y, z, s2, opa;
    bool det_ok, lim_ok_x, lim_ok_y;
};

__device__ __forceinline__ Proj project_parts(float x, float y, float z,
                                              float s2, float opa,
                                              const Cam& cam) {
    Proj p;
    p.x = x; p.y = y; p.z = z; p.s2 = s2; p.opa = opa;
    p.qx = cam.r[0] * x + cam.r[1] * y + cam.r[2] * z + cam.t[0];
    p.qy = cam.r[3] * x + cam.r[4] * y + cam.r[5] * z + cam.t[1];
    p.qz = cam.r[6] * x + cam.r[7] * y + cam.r[8] * z + cam.t[2];
    p.zs = (fabsf(p.qz) < (float)1e-8) ? (float)1e-8 : p.qz;
    p.iz = 1.0f / p.zs;
    p.u = cam.fx * p.qx * p.iz + cam.cx;
    p.v = cam.fy * p.qy * p.iz + cam.cy;

    // EWA jacobian with the 1.3x field-of-view clamp
    const float lim_x = FOV_CLAMP * cam.w / cam.fx;
    const float lim_y = FOV_CLAMP * cam.h / cam.fy;
    const float rx = p.qx * p.iz;
    const float ry = p.qy * p.iz;
    p.txc = p.zs * fminf(fmaxf(rx, -lim_x), lim_x);
    p.tyc = p.zs * fminf(fmaxf(ry, -lim_y), lim_y);
    const float iz2 = p.iz * p.iz;
    p.j00 = cam.fx * p.iz;
    p.j02 = -cam.fx * p.txc * iz2;
    p.j11 = cam.fy * p.iz;
    p.j12 = -cam.fy * p.tyc * iz2;

    // cov2d = J (s2*I) J^T + EPS2D*I
    p.a = s2 * (p.j00 * p.j00 + p.j02 * p.j02) + EPS2D;
    p.b = s2 * (p.j02 * p.j12);
    p.c = s2 * (p.j11 * p.j11 + p.j12 * p.j12) + EPS2D;
    const float det = p.a * p.c - p.b * p.b;
    const float det_s = (det == 0.0f) ? (float)1e-12 : det;
    p.inv_det = 1.0f / det_s;
    p.ca = p.c * p.inv_det;
    p.cb = -p.b * p.inv_det;
    p.cc = p.a * p.inv_det;
    p.det_ok = det > 0.0f;
    p.lim_ok_x = fabsf(rx) < lim_x;
    p.lim_ok_y = fabsf(ry) < lim_y;
    return p;
}

// [u, v, ca, cb, cc, qz, opa, ok]
__device__ __forceinline__ void project8_rows(const Proj& p, float near_p,
                                              float far_p, float out[8]) {
    out[0] = p.u; out[1] = p.v;
    out[2] = p.ca; out[3] = p.cb; out[4] = p.cc;
    out[5] = p.qz; out[6] = p.opa;
    out[7] = (p.det_ok && (p.qz > near_p) && (p.qz < far_p)) ? 1.0f : 0.0f;
}

// Tile-local sigma polynomial of one projected slot against the sub-tile
// origin (x0, y0): coef = [c0, cx, cy, cxx, cxy, cyy, qz, opa*ok].
__device__ __forceinline__ void coeff_mat(const float p8[8], float x0,
                                          float y0, float coef[8]) {
    const float u = p8[0], v = p8[1];
    const float ca = p8[2], cb = p8[3], cc = p8[4];
    const float ul = u - x0;
    const float vl = v - y0;
    coef[0] = 0.5f * (ca * ul * ul + cc * vl * vl) + cb * ul * vl;
    coef[1] = -(ca * ul + cb * vl);
    coef[2] = -(cc * vl + cb * ul);
    coef[3] = 0.5f * ca;
    coef[4] = cb;
    coef[5] = 0.5f * cc;
    coef[6] = p8[5];
    coef[7] = p8[6] * p8[7];
}

// Gated alpha of one slot at one pixel from the polynomial coefficients;
// (xl, yl) are the tile-local pixel-centre coordinates and xx, xy, yy their
// products. Returns 0 when a gate rejects the pair.
__device__ __forceinline__ float sub_alpha(float c0, float cx, float cy,
                                           float cxx, float cxy, float cyy,
                                           float opaok, float xl, float yl,
                                           float xx, float xy, float yy) {
    const float sigma = c0 + cx * xl + cy * yl + cxx * xx + cxy * xy + cyy * yy;
    const float alpha = fminf(opaok * expf(-sigma), ALPHA_MAX);
    const bool ok = (sigma >= -SIG_EPS) && (alpha >= ALPHA_MIN);
    return ok ? alpha : 0.0f;
}

// Chain from the frame-local pixel moments of d_sigma (m0, m_x, ... about
// the origin (x0, y0)) and the direct depth term to the pose partial
// out[12] = [dR (9, row major), dt (3)], ACCUMULATED into out. Isotropic
// scene: M = S = s2*I, so the off-diagonal entries are folded away.
__device__ __forceinline__ void pose_chain(const Proj& p, const Cam& cam,
                                           float m0, float m_x, float m_y,
                                           float m_xx, float m_xy, float m_yy,
                                           float d_z_direct, float x0,
                                           float y0, float out[12]) {
    const float fx = cam.fx, fy = cam.fy;
    const float u_l = p.u - x0;
    const float v_l = p.v - y0;
    const float s1 = m_x - u_l * m0;
    const float s2m = m_y - v_l * m0;
    const float d_ca = 0.5f * (m_xx - 2.0f * u_l * m_x + u_l * u_l * m0);
    const float d_cb = m_xy - u_l * m_y - v_l * m_x + u_l * v_l * m0;
    const float d_cc = 0.5f * (m_yy - 2.0f * v_l * m_y + v_l * v_l * m0);
    const float d_u = -(p.ca * s1 + p.cb * s2m);
    const float d_v = -(p.cc * s2m + p.cb * s1);

    const float idet = p.inv_det;
    const float d_idet = d_ca * p.c + d_cb * (-p.b) + d_cc * p.a;
    const float d_det = -d_idet * idet * idet;
    const float d_a = d_cc * idet + d_det * p.c;
    const float d_b = -d_cb * idet - 2.0f * d_det * p.b;
    const float d_c = d_ca * idet + d_det * p.a;

    const float j00 = p.j00, j02 = p.j02, j11 = p.j11, j12 = p.j12;
    const float m = p.s2;  // m00 = m11 = m22; m01 = m02 = m12 = 0
    const float d_m00 = d_a * j00 * j00;
    const float d_m01 = d_b * j00 * j11;
    const float d_m02 = d_a * 2.0f * j00 * j02 + d_b * j00 * j12;
    const float d_m11 = d_c * j11 * j11;
    const float d_m12 = d_b * j02 * j11 + d_c * 2.0f * j11 * j12;
    const float d_m22 = d_a * j02 * j02 + d_b * j02 * j12 + d_c * j12 * j12;
    const float d_j00 = d_a * (2.0f * j00 * m);
    const float d_j02 = d_a * (2.0f * j02 * m) + d_b * (j12 * m);
    const float d_j11 = d_c * (2.0f * j11 * m);
    const float d_j12 = d_c * (2.0f * j12 * m) + d_b * (j02 * m);

    const float iz = p.iz;
    const float iz2 = iz * iz;
    const float iz3 = iz2 * iz;
    float d_qx = d_u * fx * iz;
    float d_qy = d_v * fy * iz;
    float d_qz = -(d_u * fx * p.qx + d_v * fy * p.qy) * iz2 + d_z_direct;
    d_qz = d_qz - d_j00 * fx * iz2 - d_j11 * fy * iz2;
    d_qz = d_qz + d_j02 * fx * (2.0f * p.txc * iz3)
                + d_j12 * fy * (2.0f * p.tyc * iz3);
    const float d_txc = -d_j02 * fx * iz2;
    const float d_tyc = -d_j12 * fy * iz2;
    d_qx = d_qx + (p.lim_ok_x ? d_txc : 0.0f);
    d_qz = d_qz + (p.lim_ok_x ? 0.0f : d_txc * p.txc * iz);
    d_qy = d_qy + (p.lim_ok_y ? d_tyc : 0.0f);
    d_qz = d_qz + (p.lim_ok_y ? 0.0f : d_tyc * p.tyc * iz);

    // dR = (G + G^T) R S with S = s2*I: rs[j][k] = r[j][k] * s2
    const float g[3][3] = {
        {2.0f * d_m00, d_m01, d_m02},
        {d_m01, 2.0f * d_m11, d_m12},
        {d_m02, d_m12, 2.0f * d_m22},
    };
    const float d_q[3] = {d_qx, d_qy, d_qz};
    const float pw[3] = {p.x, p.y, p.z};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            float acc = 0.0f;
#pragma unroll
            for (int j = 0; j < 3; ++j) acc = acc + g[i][j] * (cam.r[3 * j + k] * m);
            out[3 * i + k] += acc + d_q[i] * pw[k];
        }
        out[9 + i] += d_q[i];
    }
}

// Pixel centre of flat index f in the sub-tile-major layout of a band whose
// first pixel row is row0_px (0 for the whole image; a band of a tile mesh
// renders its rows at their global y). Every term is an exact small integer
// or half, so a band's rows are bit-equal to the same rows of the image.
__device__ __forceinline__ void pixel_center(long long f, int n_tx,
                                             float row0_px, float& px,
                                             float& py) {
    const long long st = f / P_SUB;
    const int within = (int)(f - st * P_SUB);
    const int n_gx = n_tx * N_SUB_X;
    const int gy = (int)(st / n_gx);
    const int gx = (int)(st - (long long)gy * n_gx);
    const int r = within / SUB_W;
    const int c = within - r * SUB_W;
    px = (float)(gx * SUB_W + c) + 0.5f;
    py = (float)(gy * SUB_H + r) + 0.5f + row0_px;
}

}  // namespace gsl
