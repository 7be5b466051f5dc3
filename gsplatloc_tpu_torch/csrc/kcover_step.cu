// K-cover step kernels: the per-step render of the tracking loop and its
// backward to the 12 pose scalars.
//
// kcover_step_fwd replaces the Pallas kernel _kcover_step_fwd_kernel and
// kcover_step_bwd replaces _kcover_step_bwd_kernel (both in the JAX
// package's ops/kcover.py).
//
// Bound on this card: bytes. Each kernel streams the (5, K, M_out) cover
// buffer once; the arithmetic per record (projection, one expf, the pose
// chain in the backward) is far below the card's f32 rate for those bytes.
// Design: one thread per pixel, the K loop in registers; thread p reads
// kbuf[r, k, p], so a warp reads 128 contiguous bytes per row. A pixel
// stops reading its list once its transmittance is dead (every later
// record then contributes exactly 0), which removes most of the stream on
// opaque scenes.
//
// The backward makes one sweep. The adjoint needs, at record k, the suffix
// sum of w*phi over the records after k (phi = g_d*qz + g_a). Its total is
// g_d*depth_acc + g_a*alpha, the two rows the forward wrote, so the suffix
// is that total minus the running sum: each record is read, projected and
// evaluated once, with no sweep that only totals. (The reference's
// sub-tile backward takes its total the same way.) The forward's totals
// are summed in another order than the running sum, so at the last live
// record the suffix is a rounding residue of the total, not exactly 0: a
// relative error of the f32 order, like every other suffix. The record
// whose INCLUSIVE transmittance crosses T_EPS is not live; its exact
// suffix is 0 and so is its d_alpha. It is gated off by `live` (as the
// sub-tile backward gates it), so it contributes exactly what the
// two-sweep form gave it, 0, rather than the residue times 1/(1-alpha).
// Both kernels take row0_px, the first global pixel row of the band they
// render (0 for the whole image): a band of a tile mesh
// (parallel/sharded.py) holds the cover records of its own pixels only and
// evaluates them at their global pixel centres, as the reference's step
// kernels read row0_px from their scalar vector.
// The 12 pose partials are reduced warp -> block -> (n_blocks, 12)
// scratch, and a second kernel adds the block rows in a fixed order in
// double: no float atomics, so a run is bitwise repeatable (reduce.cuh;
// the sub-tile pose chain shares it).
#include "project.cuh"
#include "reduce.cuh"

namespace gsl {

constexpr int STEP_THREADS = REDUCE_THREADS;

struct StepEval {
    Proj pr;
    float alpha_raw, alpha, w, t_excl, om;
    bool ok, live;
};

// forward math of one (k, pixel) record given the entry transmittance
__device__ __forceinline__ StepEval step_eval(const float* __restrict__ kbuf,
                                              int k, int k_cover,
                                              long long m_out, long long f,
                                              const Cam& cam, float px,
                                              float py, float near_p,
                                              float far_p, float t_in) {
    StepEval e;
    const float x = kbuf[((long long)(0 * k_cover + k)) * m_out + f];
    const float y = kbuf[((long long)(1 * k_cover + k)) * m_out + f];
    const float z = kbuf[((long long)(2 * k_cover + k)) * m_out + f];
    const float s2 = kbuf[((long long)(3 * k_cover + k)) * m_out + f];
    const float opa = kbuf[((long long)(4 * k_cover + k)) * m_out + f];
    e.pr = project_parts(x, y, z, s2, opa, cam);
    const bool ok_r = e.pr.det_ok && (e.pr.qz > near_p) && (e.pr.qz < far_p);
    const float dx = px - e.pr.u;
    const float dy = py - e.pr.v;
    const float sigma = 0.5f * (e.pr.ca * dx * dx + e.pr.cc * dy * dy)
                        + e.pr.cb * dx * dy;
    e.alpha_raw = opa * expf(-sigma);
    float alpha = fminf(e.alpha_raw, ALPHA_MAX);
    e.ok = (sigma >= -SIG_EPS) && (alpha >= ALPHA_MIN) && ok_r;
    alpha = e.ok ? alpha : 0.0f;
    e.alpha = alpha;
    e.t_excl = t_in;
    e.om = 1.0f - alpha;
    // the slot whose INCLUSIVE transmittance crosses T_EPS is excluded
    e.live = (t_in * e.om) > T_EPS;
    e.w = e.live ? t_in * alpha : 0.0f;
    return e;
}

__global__ void __launch_bounds__(STEP_THREADS)
kcover_step_fwd_kernel(const float* __restrict__ cam_p,
                       const float* __restrict__ kbuf,
                       float* __restrict__ out, int k_cover, long long m_out,
                       int n_tx, float row0_px, float near_p, float far_p) {
    const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= m_out) return;
    const Cam cam = load_cam(cam_p);
    float px, py;
    pixel_center(f, n_tx, row0_px, px, py);
    float t = 1.0f, dacc = 0.0f, aacc = 0.0f;
    for (int k = 0; k < k_cover; ++k) {
        const StepEval e = step_eval(kbuf, k, k_cover, m_out, f, cam, px, py,
                                     near_p, far_p, t);
        dacc = dacc + e.w * e.pr.qz;
        aacc = aacc + e.w;
        t = t * e.om;
        if (!(t > T_EPS)) break;  // dead: every later record weighs 0
    }
    out[f] = dacc;
    out[m_out + f] = aacc;
}

__global__ void __launch_bounds__(STEP_THREADS)
kcover_step_bwd_kernel(const float* __restrict__ cam_p,
                       const float* __restrict__ kbuf,
                       const float* __restrict__ fwd,
                       const float* __restrict__ gd,
                       const float* __restrict__ ga,
                       float* __restrict__ scratch, int k_cover,
                       long long m_out, int n_tx, float row0_px, float near_p,
                       float far_p) {
    const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const Cam cam = load_cam(cam_p);
    float part[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) part[j] = 0.0f;

    if (f < m_out) {
        float px, py;
        pixel_center(f, n_tx, row0_px, px, py);
        const float g_d = gd[f];
        const float g_a = ga[f];
        // total of w * phi over the live records, from the forward's rows
        const float g_tot = g_d * fwd[f] + g_a * fwd[m_out + f];
        float t = 1.0f, run = 0.0f;
        for (int k = 0; k < k_cover; ++k) {
            const StepEval e = step_eval(kbuf, k, k_cover, m_out, f, cam, px,
                                         py, near_p, far_p, t);
            const float phi = g_d * e.pr.qz + g_a;
            run = run + e.w * phi;
            const float suffix = g_tot - run;
            const float inv_om = 1.0f / fmaxf(e.om, ONE_MINUS_ALPHA_MAX);
            float d_alpha = (e.live ? e.t_excl * phi : 0.0f) - suffix * inv_om;
            d_alpha = (e.ok && e.live && (e.alpha_raw < ALPHA_MAX)) ? d_alpha
                                                                    : 0.0f;
            const float d_sigma = d_alpha * (-e.alpha);
            const float qz_bar = e.w * g_d;
            if (d_sigma != 0.0f || qz_bar != 0.0f) {
                // the record meets exactly one pixel: its moment frame is
                // that pixel, so the only nonzero moment is m0 = d_sigma
                pose_chain(e.pr, cam, d_sigma, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                           qz_bar, px, py, part);
            }
            t = t * e.om;
            if (!(t > T_EPS)) break;
        }
    }

    block_sum12(part, scratch);
}

// Sum the (n_blocks, 12) block partials in a fixed order, in double.
// One block of 12 warps: warp j owns scalar j, lane l adds rows l, l+32, ...
// in ascending order, then a fixed shuffle tree joins the 32 lanes.
__global__ void sum12_kernel(const float* __restrict__ scratch,
                             float* __restrict__ out, int n_blocks) {
    const int j = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    double acc = 0.0;
    for (int b = lane; b < n_blocks; b += 32)
        acc = acc + (double)scratch[(long long)b * 12 + j];
#pragma unroll
    for (int ofs = 16; ofs > 0; ofs >>= 1)
        acc = acc + __shfl_down_sync(0xffffffffu, acc, ofs);
    if (lane == 0) out[j] = (float)acc;
}

int launch_sum12(const float* scratch, float* out, int n_blocks,
                 cudaStream_t stream) {
    sum12_kernel<<<1, 12 * 32, 0, stream>>>(scratch, out, n_blocks);
    return (int)cudaGetLastError();
}

}  // namespace gsl

extern "C" int gsl_kcover_step_fwd(const void* cam, const void* kbuf,
                                   void* out, int k_cover, long long m_out,
                                   int n_tx, float row0_px, float near_p,
                                   float far_p, void* stream) {
    const int threads = gsl::STEP_THREADS;
    const long long blocks = (m_out + threads - 1) / threads;
    gsl::kcover_step_fwd_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)cam, (const float*)kbuf, (float*)out, k_cover, m_out,
        n_tx, row0_px, near_p, far_p);
    return (int)cudaGetLastError();
}

extern "C" int gsl_kcover_step_bwd(const void* cam, const void* kbuf,
                                   const void* fwd, const void* gd,
                                   const void* ga,
                                   void* scratch, void* out, int k_cover,
                                   long long m_out, int n_tx, float row0_px,
                                   float near_p, float far_p, int n_blocks,
                                   void* stream) {
    const int threads = gsl::STEP_THREADS;
    const long long blocks = (m_out + threads - 1) / threads;
    if (blocks != n_blocks) return (int)cudaErrorInvalidValue;
    gsl::kcover_step_bwd_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)cam, (const float*)kbuf, (const float*)fwd,
        (const float*)gd, (const float*)ga, (float*)scratch, k_cover, m_out,
        n_tx, row0_px, near_p, far_p);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    return gsl::launch_sum12((const float*)scratch, (float*)out, n_blocks,
                             (cudaStream_t)stream);
}
