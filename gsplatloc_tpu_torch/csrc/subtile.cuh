// Footprint box of one slot in a 16x16 sub-tile walk (the sub-tile layout
// of project.cuh: one block per sub-tile, 256 threads of one pixel each,
// warp w holding pixel rows 2w and 2w+1), shared by the walks that skip
// the pairs outside it: subtile_fwd (subtile_fwd.cu), kcover_select
// (kcover_select.cu) and subtile_bwd (subtile_bwd.cu).
#pragma once

#include "rasterize.cuh"

namespace gsl {

constexpr int N_SUB_WARPS = P_SUB / 32;  // 8, two pixel rows each

// Footprint box of one slot in a 16x16 sub-tile walk, and the warps of the
// block (warp w: pixel rows 2w and 2w+1) that it meets. The plain version
// is ops/fused_subtile.py _subtile_box, in the same f32 operation order.
//
// subtile_box(coef, ul, vl): coef = coeff_mat's [c0, cx, cy, cxx, cxy, cyy,
// qz, opa*ok] and (ul, vl) = (u - x0, v - y0), the f32 values coeff_mat
// computed. Returns the inclusive rectangle [c_lo, c_hi] x [r_lo, r_hi]
// (clamped to the sub-tile) outside which sub_alpha returns exactly 0 at
// every pixel centre (xl, yl) = (c + 0.5, r + 0.5) under the kernel's own
// f32 arithmetic; an empty box is {SUB_W, -1, SUB_H, -1}, the whole
// sub-tile {0, SUB_W-1, 0, SUB_H-1}.
//
// Margins (u = 2^-24). Let Q(p) = cxx dx^2 + cxy dx dy + cyy dy^2, dx =
// xl - ul, dy = yl - vl, in exact arithmetic on the f32 values: cxx =
// ca/2, cxy = cb, cyy = cc/2 exactly, so Q >= 0 with its minimum 0 at
// (ul, vl) whenever the form is positive definite, which is exactly when
// the conic is (4 cxx cyy - cxy^2 = ca cc - cb^2). The kernel's sigma_f is
// the expanded polynomial in f32, and it differs from Q(p) by
//  - the evaluation error: six terms, each through at most one product and
//    five sums, so <= 6.01u (|c0| + 16(|cx| + |cy|) + 256(cxx + |cxy| +
//    cyy)) with xl, yl <= 15.5 and xl^2, xl*yl, yl^2 <= 240.25 (exact);
//  - the rounding of the coefficients c0, cx, cy from (ul, vl, ca, cb,
//    cc): <= 4.01u (cxx ul^2 + cyy vl^2 + |cxy ul vl|) for c0 and 2.01u
//    (2 cxx |ul| + |cxy| |vl|) for cx (cy alike), times xl, yl < 16.
// That error is bounded by the magnitudes of the terms, not by sigma: a
// centre far from the sub-tile's origin cancels large terms, and sigma_f
// can come out below 0 (down to -err; the gate sigma >= -SIG_EPS exists
// for that). err = 64u * (the sum of those magnitudes) + 2^-20 covers both
// with room for its own f32 evaluation (the absolute 2^-20 covers a
// subnormal ca/2). A pair passes only if opa*expf(-sigma_f) >= ALPHA_MIN
// in f32, i.e. sigma_f <= ln(255 opa) + 4u-ish; with lf = logf(255 opa)
// (1 ulp), S = lf + |lf| 2^-20 + 2^-20 + err bounds Q(p) at every passing
// pixel. S < 0 (an opacity so low that even sigma_f = -err fails the gate)
// is empty: below ALPHA_MIN the box is empty, and the -SIG_EPS slack lets
// an opacity a little below ALPHA_MIN through only where err allows. On
// the ellipse Q <= S, |dx| <= sqrt(4 S cyy / det) and |dy| <= sqrt(4 S cxx
// / det) with det = 4 cxx cyy - cxy^2; det_lo = det - 2^-20 * 4 cxx cyy
// bounds det from below (its three roundings are within 3u of 4 cxx cyy),
// and 2^-16 of the half extents and of |ul| + 1 covers the rounding of the
// box arithmetic (as rasterize.cuh footprint_box). Cases: a non-finite
// coefficient or centre, and a form that is not positive definite (or
// det_lo <= 0) keep the whole sub-tile; so does err > 1/4, an error margin
// not small against ln(255 opa) <= ln 255 (a centre or a curvature so large
// that the f32 polynomial has lost the gate's resolution), where the gate
// decides as before; opa*ok == 0 is empty whatever the other fields hold
// (the walks skip such a slot), and so is opa*ok < 0. A NaN opacity keeps
// the whole sub-tile: fminf drops the NaN and its alpha passes the gates.
constexpr float SUB_BOX_ERR_REL = 1.0f / 262144.0f;  // 2^-18 = 64u
constexpr float SUB_BOX_ERR_ABS = 1.0f / 1048576.0f;  // 2^-20
constexpr float SUB_BOX_ERR_MAX = 0.25f;

__device__ __forceinline__ PixBox subtile_box(const float coef[8], float ul,
                                              float vl) {
    const PixBox whole = {0, SUB_W - 1, 0, SUB_H - 1};
    const PixBox empty = {SUB_W, -1, SUB_H, -1};
    const float c0 = coef[0], cx = coef[1], cy = coef[2];
    const float cxx = coef[3], cxy = coef[4], cyy = coef[5], opa = coef[7];
    // the walks skip such a slot (whatever its other fields hold)
    if (opa == 0.0f) return empty;
    if (!(isfinite(c0) && isfinite(cx) && isfinite(cy) && isfinite(cxx)
          && isfinite(cxy) && isfinite(cyy) && isfinite(opa) && isfinite(ul)
          && isfinite(vl)))
        return whole;
    if (opa < 0.0f) return empty;
    const float k1 = 4.0f * (cxx * cyy);
    const float det_lo = (k1 - cxy * cxy) - k1 * BOX_DET_REL;
    if (!(cxx > 0.0f && cyy > 0.0f && det_lo > 0.0f)) return whole;
    const float au = fabsf(ul), av = fabsf(vl), axy = fabsf(cxy);
    const float mag =
        fabsf(c0) + 16.0f * (fabsf(cx) + fabsf(cy))
        + 256.0f * (cxx + axy + cyy)
        + (cxx * (au * au) + cyy * (av * av) + axy * (au * av))
        + 16.0f * ((2.0f * cxx) * au + (2.0f * cyy) * av + axy * (au + av));
    const float err = mag * SUB_BOX_ERR_REL + SUB_BOX_ERR_ABS;
    if (!(err <= SUB_BOX_ERR_MAX)) return whole;
    const float lf = logf(opa * 255.0f);
    const float s = (lf + fabsf(lf) * BOX_L_REL + BOX_L_REL) + err;
    if (!(s >= 0.0f)) return empty;
    const float s4 = (4.0f * s) / det_lo;
    const float hx = sqrtf(s4 * cyy);
    const float hy = sqrtf(s4 * cxx);
    const float ex = hx + hx * BOX_REL + (au + 1.0f) * BOX_REL;
    const float ey = hy + hy * BOX_REL + (av + 1.0f) * BOX_REL;
    const float c_lo = fmaxf(ceilf(ul - ex - 0.5f), 0.0f);
    const float c_hi = fminf(floorf(ul + ex - 0.5f), (float)(SUB_W - 1));
    const float r_lo = fmaxf(ceilf(vl - ey - 0.5f), 0.0f);
    const float r_hi = fminf(floorf(vl + ey - 0.5f), (float)(SUB_H - 1));
    if (!(c_lo <= c_hi && r_lo <= r_hi)) return empty;
    return {(int)c_lo, (int)c_hi, (int)r_lo, (int)r_hi};
}

// The warps of a sub-tile block whose two pixel rows a box meets, as a bit
// mask (bit w: rows 2w and 2w+1).
__device__ __forceinline__ unsigned sub_box_warps(const PixBox& b) {
    if (b.c_lo > b.c_hi || b.r_lo > b.r_hi) return 0u;
    return (2u << (b.r_hi >> 1)) - (1u << (b.r_lo >> 1));
}

// The box as one word: bits 0-15 its columns c_lo..c_hi, bits 16-31 its
// rows r_lo..r_hi; 0 for an empty box. Warp w meets the box iff bits 2w
// and 2w+1 of the row half are not both 0 (bit w of sub_box_warps).
__device__ __forceinline__ unsigned sub_box_mask(const PixBox& b) {
    if (b.c_lo > b.c_hi || b.r_lo > b.r_hi) return 0u;
    const unsigned cols = (2u << b.c_hi) - (1u << b.c_lo);
    const unsigned rows = (2u << b.r_hi) - (1u << b.r_lo);
    return cols | (rows << 16);
}

// Whether the warp meets the box of mask m.
__device__ __forceinline__ bool sub_mask_meets_warp(unsigned m, int warp) {
    return ((m >> (16 + 2 * warp)) & 3u) != 0u;
}

// Whether the pixel (row, col) of the sub-tile lies in the box of mask m.
__device__ __forceinline__ bool sub_mask_holds(unsigned m, int row, int col) {
    return ((m >> col) & (m >> (16 + row)) & 1u) != 0u;
}

}  // namespace gsl
