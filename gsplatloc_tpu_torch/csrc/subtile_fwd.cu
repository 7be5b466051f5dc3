// Sub-tile forward render: the projection phase over the whole slot buffer
// and the per-sub-tile front-to-back compositing walk.
//
// project8 replaces the Pallas kernel _project8_kernel (launched by
// _project8_pallas) and subtile_fwd replaces _subtile_fwd_kernel (launched
// by _subtile_fwd_impl), both in the JAX package's ops/fused_subtile.py.
//
// project8 — bound: bytes (reads (5 live of 8, M_pad), writes (8, M_pad));
// one thread per slot, every access coalesced along the slot axis.
//
// subtile_fwd — bound: bytes (one read of the walked projected slots and
// two output rows; the operations — the staging of every walked slot, and
// per (slot, pixel) pair inside the slot's footprint box six multiply-adds,
// one expf and the compositing — take less time at the card's f32 rate).
// Design: one block per 16x16 sub-tile, 256 threads of one pixel each;
// warp w holds pixel rows 2w and 2w+1. The block stages one 128-slot chunk
// of its chunk-padded segment at a time into shared memory, each slot once:
// its tile-local sigma polynomial coefficients and its footprint box
// (subtile_box, subtile.cuh) as a column / row bit mask. Each warp turns
// the staged masks into its own list with a ballot (the slots whose box
// meets its two rows) and walks the list in slot order; a lane whose pixel
// lies outside a slot's box, or is dead, skips the alpha, and a warp with
// no live pixel skips its lists. Each pixel composites with its own
// transmittance. The walk stops at the first chunk boundary where every
// pixel's transmittance is <= T_EPS (a block vote); the number of chunks
// walked is written per segment, in the same 128-slot unit the reference
// counts in.
//
// The cull changes no bit: outside its box sub_alpha is exactly 0, and a
// pair with alpha 0 leaves T as it was and adds qz*0 and +0 to the sums
// (qz is finite wherever opa*ok != 0, and the sums start at +0.0f, so they
// never become -0.0f); a dead pixel's w is 0 and only its liveness is
// read, and T only falls.
#include "subtile.cuh"

namespace gsl {

__global__ void __launch_bounds__(256)
project8_kernel(const float* __restrict__ cam_p,
                const float* __restrict__ slot3d, float* __restrict__ out,
                long long m_pad, float near_p, float far_p) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m_pad) return;
    const Cam cam = load_cam(cam_p);
    const Proj pr = project_parts(slot3d[i], slot3d[m_pad + i],
                                  slot3d[2 * m_pad + i], slot3d[3 * m_pad + i],
                                  slot3d[4 * m_pad + i], cam);
    float p8[8];
    project8_rows(pr, near_p, far_p, p8);
#pragma unroll
    for (int r = 0; r < 8; ++r) out[(long long)r * m_pad + i] = p8[r];
}

__global__ void __launch_bounds__(P_SUB)
subtile_fwd_kernel(const int* __restrict__ meta,
                   const float* __restrict__ proj8, float* __restrict__ out,
                   int* __restrict__ chunks_done, long long m_pad,
                   long long m_out, int n_tx) {
    __shared__ float s_coef[8][CHUNK];
    __shared__ unsigned s_mask[CHUNK];

    const int st = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int start = meta[1 + st];
    const int end = meta[2 + st];
    const int n_chunks = (end - start) / CHUNK;
    const int n_gx = n_tx * N_SUB_X;
    const int gy = st / n_gx;
    const int gx = st - gy * n_gx;
    const float x0 = (float)(gx * SUB_W);
    const float y0 = (float)((gy + meta[0]) * SUB_H);

    const int row = tid / SUB_W;
    const int col = tid % SUB_W;
    const float yl = (float)row + 0.5f;
    const float xl = (float)col + 0.5f;
    const float xx = xl * xl, xy = xl * yl, yy = yl * yl;

    float t = 1.0f, dacc = 0.0f, aacc = 0.0f;
    int c_done = 0;
    for (int c = 0; c < n_chunks; ++c) {
        // chunk-granular early stop; also the barrier that protects the
        // staged chunk of the previous round
        if (__syncthreads_or(t > T_EPS ? 1 : 0) == 0) break;
        if (tid < CHUNK) {
            const long long i = (long long)start + (long long)c * CHUNK + tid;
            float p8[8], coef[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) p8[r] = proj8[(long long)r * m_pad + i];
            coeff_mat(p8, x0, y0, coef);
#pragma unroll
            for (int r = 0; r < 8; ++r) s_coef[r][tid] = coef[r];
            s_mask[tid] = sub_box_mask(subtile_box(coef, p8[0] - x0,
                                                   p8[1] - y0));
        }
        __syncthreads();
        if (__any_sync(0xffffffffu, t > T_EPS)) {
            for (int g = 0; g < CHUNK; g += 32) {
                unsigned todo = __ballot_sync(
                    0xffffffffu, sub_mask_meets_warp(s_mask[g + lane], warp));
                while (todo != 0u) {
                    const int j = g + __ffs(todo) - 1;
                    todo &= todo - 1u;
                    if (!(sub_mask_holds(s_mask[j], row, col) && t > T_EPS))
                        continue;
                    const float alpha = sub_alpha(
                        s_coef[0][j], s_coef[1][j], s_coef[2][j],
                        s_coef[3][j], s_coef[4][j], s_coef[5][j],
                        s_coef[7][j], xl, yl, xx, xy, yy);
                    const float t_incl = t * (1.0f - alpha);
                    const float w = (t_incl > T_EPS) ? t * alpha : 0.0f;
                    dacc = dacc + s_coef[6][j] * w;
                    aacc = aacc + w;
                    t = t_incl;
                }
            }
        }
        c_done += 1;
    }
    const long long pix = (long long)st * P_SUB + tid;
    out[pix] = dacc;
    out[m_out + pix] = aacc;
    if (tid == 0) chunks_done[st] = c_done;
}

}  // namespace gsl

extern "C" int gsl_project8(const void* cam, const void* slot3d, void* out,
                            long long m_pad, float near_p, float far_p,
                            void* stream) {
    const int threads = 256;
    const long long blocks = (m_pad + threads - 1) / threads;
    gsl::project8_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)cam, (const float*)slot3d, (float*)out, m_pad, near_p,
        far_p);
    return (int)cudaGetLastError();
}

extern "C" int gsl_subtile_fwd(const void* meta, const void* proj8, void* out,
                               void* chunks_done, int n_seg, long long m_pad,
                               long long m_out, int n_tx, void* stream) {
    if ((long long)n_seg * gsl::P_SUB != m_out)
        return (int)cudaErrorInvalidValue;
    gsl::subtile_fwd_kernel<<<n_seg, gsl::P_SUB, 0, (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)proj8, (float*)out,
        (int*)chunks_done, m_pad, m_out, n_tx);
    return (int)cudaGetLastError();
}
