// Sub-tile backward of the kcover=0 tracking path: the alpha replay with
// the compositing adjoint, emitting per-slot pixel moments, and the chain
// from those moments to the 12 pose partials.
//
// subtile_bwd replaces the Pallas kernel _subtile_bwd_kernel (the
// pallas_call in _subtile_vjp_bwd) and subtile_chain replaces _chain_kernel
// (launched by _chain_pallas), both in the JAX package's
// ops/fused_subtile.py.
//
// subtile_bwd — bound: operations (every walked slot meets the 256 pixels
// of its sub-tile: the forward's polynomial sigma, one expf and the
// compositing, then the adjoint and the moment sums; the bytes are one read
// of the walked projected slots and four pixel rows, one write of the
// (8, M_pad) moments). Design: the forward walk's block shape — one block
// per 16x16 sub-tile, one thread per pixel, 128-slot chunks staged in
// shared memory as tile-local polynomial coefficients. Each pixel thread
// carries its transmittance T, and the running sum of w*phi; the suffix
// sum the adjoint needs is the forward total minus that running sum, so
// there is no reverse walk. Per 16 slots each thread stages its d_sigma and
// w*g_d in shared memory; then lane (slot, row) of each warp sums one pixel
// row of one slot in a fixed order (d_sigma, x*d_sigma, x^2*d_sigma and
// w*g_d: the y moments follow from the row's y), the warp joins its two
// rows, and the 8 warp partials are added in a fixed order. No float
// atomics, so a result repeats bit for bit. Row 7 carries the sub-tile
// origin packed as sub_row*ENC_Y + sub_col; the chunks the early stop skips
// are written as zero, all 8 rows, as is every slot outside
// [meta[1], meta[n_seg+1]).
//
// subtile_chain — bound: bytes (one read of the 8 moment rows over the
// walked range and of the 5 record rows of the slots with a nonzero
// moment; the projection and pose chain per slot are far below the f32
// rate for those bytes). One thread per slot decodes its origin from row 7,
// recomputes project_parts and runs pose_chain; the 12 partials go through
// the fixed-order reduction shared with kcover_step_bwd (reduce.cuh).
#include "project.cuh"
#include "reduce.cuh"

namespace gsl {

constexpr int ENC_Y = 4096;
constexpr int FLUSH = 16;            // slots per moment flush
constexpr int N_MOM = 7;             // 6 moments of d_sigma + sum of w*g_d
constexpr int ROW_STRIDE = P_SUB + 1;  // padded (slot, pixel) staging row

__global__ void __launch_bounds__(P_SUB)
subtile_bwd_kernel(const int* __restrict__ meta,
                   const float* __restrict__ proj8,
                   const float* __restrict__ px_in, float* __restrict__ mom,
                   long long m_pad, long long m_out, int n_tx) {
    __shared__ float s_coef[8][CHUNK];
    __shared__ float s_ds[FLUSH][ROW_STRIDE];
    __shared__ float s_wg[FLUSH][ROW_STRIDE];
    __shared__ float s_part[P_SUB / 32][FLUSH][N_MOM];

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
    const float enc = (float)((gy + meta[0]) * ENC_Y + gx);

    const float yl = (float)(tid / SUB_W) + 0.5f;
    const float xl = (float)(tid % SUB_W) + 0.5f;
    const float xx = xl * xl, xy = xl * yl, yy = yl * yl;

    const long long pix = (long long)st * P_SUB + tid;
    // pixel rows: forward depth_acc and alpha totals, the two cotangents
    const float g_d = px_in[2 * m_out + pix];
    const float g_a = px_in[3 * m_out + pix];
    const float g_tot = g_d * px_in[pix] + g_a * px_in[m_out + pix];

    // reduction role of this thread: one pixel row of one slot per flush
    const int red_slot = lane & (FLUSH - 1);
    const int red_row = 2 * warp + (lane >> 4);
    const float red_y = (float)red_row + 0.5f;

    float t = 1.0f, run = 0.0f;
    int c = 0;
    for (; c < n_chunks; ++c) {
        // chunk-granular early stop; also the barrier that protects the
        // staged chunk of the previous round
        if (__syncthreads_or(t > T_EPS ? 1 : 0) == 0) break;
        const long long base = (long long)start + (long long)c * CHUNK;
        if (tid < CHUNK) {
            float p8[8], coef[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
                p8[r] = proj8[(long long)r * m_pad + base + tid];
            coeff_mat(p8, x0, y0, coef);
#pragma unroll
            for (int r = 0; r < 8; ++r) s_coef[r][tid] = coef[r];
        }
        __syncthreads();
        for (int sb = 0; sb < CHUNK; sb += FLUSH) {
            for (int jj = 0; jj < FLUSH; ++jj) {
                const int j = sb + jj;
                const float opaok = s_coef[7][j];
                float ds = 0.0f, wg = 0.0f;
                if (opaok != 0.0f) {
                    const float alpha = sub_alpha(
                        s_coef[0][j], s_coef[1][j], s_coef[2][j],
                        s_coef[3][j], s_coef[4][j], s_coef[5][j], opaok, xl,
                        yl, xx, xy, yy);
                    const float one_minus = 1.0f - alpha;
                    const float t_incl = t * one_minus;
                    const bool live = t_incl > T_EPS;
                    const float w = live ? t * alpha : 0.0f;
                    const float phi = g_d * s_coef[6][j] + g_a;
                    run = run + w * phi;
                    const float suffix = g_tot - run;
                    const float inv_om =
                        1.0f / fmaxf(one_minus, ONE_MINUS_ALPHA_MAX);
                    float d_alpha = t * phi - suffix * inv_om;
                    d_alpha = (live && alpha > 0.0f) ? d_alpha : 0.0f;
                    d_alpha = (alpha >= ALPHA_MAX) ? 0.0f : d_alpha;
                    ds = d_alpha * (-alpha);
                    wg = w * g_d;
                    t = t_incl;
                }
                s_ds[jj][tid] = ds;
                s_wg[jj][tid] = wg;
            }
            __syncthreads();
            float s0 = 0.0f, sx = 0.0f, sxx = 0.0f, swg = 0.0f;
#pragma unroll
            for (int cc = 0; cc < SUB_W; ++cc) {
                const int p = red_row * SUB_W + cc;
                const float v = s_ds[red_slot][p];
                const float x = (float)cc + 0.5f;
                s0 = s0 + v;
                sx = sx + v * x;
                sxx = sxx + v * (x * x);
                swg = swg + s_wg[red_slot][p];
            }
            float m[N_MOM] = {s0, sx, red_y * s0, sxx, red_y * sx,
                              (red_y * red_y) * s0, swg};
#pragma unroll
            for (int k = 0; k < N_MOM; ++k) {
                // lanes 0-15 (row 2*warp) take the row below (lanes 16-31)
                m[k] = m[k] + __shfl_down_sync(0xffffffffu, m[k], 16);
                if (lane < FLUSH) s_part[warp][red_slot][k] = m[k];
            }
            __syncthreads();
            if (tid < FLUSH * N_MOM) {
                const int k = tid / FLUSH;
                const int jj = tid - k * FLUSH;
                float v = 0.0f;
#pragma unroll
                for (int w = 0; w < P_SUB / 32; ++w) v = v + s_part[w][jj][k];
                mom[(long long)k * m_pad + base + sb + jj] = v;
            } else if (tid < FLUSH * (N_MOM + 1)) {
                const int jj = tid - FLUSH * N_MOM;
                mom[7LL * m_pad + base + sb + jj] = enc;
            }
        }
    }
    // the chunks the early stop skipped hold no gradient: write zeros
    for (long long i = (long long)start + (long long)c * CHUNK + tid; i < end;
         i += P_SUB) {
#pragma unroll
        for (int r = 0; r < 8; ++r) mom[(long long)r * m_pad + i] = 0.0f;
    }
}

// zero every moment column outside the walked range [meta[1], meta[n_seg+1])
__global__ void zero_outside_kernel(const int* __restrict__ meta,
                                    float* __restrict__ mom, int n_seg,
                                    long long m_pad) {
    const long long lo = meta[1];
    const long long hi = meta[n_seg + 1];
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < m_pad; i += (long long)gridDim.x * blockDim.x) {
        if (i >= lo && i < hi) continue;
#pragma unroll
        for (int r = 0; r < 8; ++r) mom[(long long)r * m_pad + i] = 0.0f;
    }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
subtile_chain_kernel(const float* __restrict__ cam_p,
                     const float* __restrict__ slot3d,
                     const float* __restrict__ mom,
                     const int* __restrict__ meta,
                     float* __restrict__ scratch, int n_seg,
                     long long m_pad) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const Cam cam = load_cam(cam_p);
    float part[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) part[j] = 0.0f;
    if (i < m_pad && i >= meta[1] && i < meta[n_seg + 1]) {
        float mv[N_MOM];
        bool any = false;
#pragma unroll
        for (int r = 0; r < N_MOM; ++r) {
            mv[r] = mom[(long long)r * m_pad + i];
            any = any || (mv[r] != 0.0f);
        }
        if (any) {
            // decode the sub-tile origin packed in row 7 by subtile_bwd
            const float enc = mom[7LL * m_pad + i];
            const float ty = floorf(enc * (1.0f / (float)ENC_Y));
            const float x0 = (enc - (float)ENC_Y * ty) * (float)SUB_W;
            const float y0 = ty * (float)SUB_H;
            const Proj pr = project_parts(
                slot3d[i], slot3d[m_pad + i], slot3d[2 * m_pad + i],
                slot3d[3 * m_pad + i], slot3d[4 * m_pad + i], cam);
            pose_chain(pr, cam, mv[0], mv[1], mv[2], mv[3], mv[4], mv[5],
                       mv[6], x0, y0, part);
        }
    }
    block_sum12(part, scratch);
}

}  // namespace gsl

extern "C" int gsl_subtile_bwd(const void* meta, const void* proj8,
                               const void* px_in, void* mom, int n_seg,
                               long long m_pad, long long m_out, int n_tx,
                               void* stream) {
    if ((long long)n_seg * gsl::P_SUB != m_out)
        return (int)cudaErrorInvalidValue;
    gsl::subtile_bwd_kernel<<<n_seg, gsl::P_SUB, 0, (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)proj8, (const float*)px_in,
        (float*)mom, m_pad, m_out, n_tx);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const long long want = (m_pad + 255) / 256;
    const int blocks = (int)(want < 1024 ? want : 1024);
    gsl::zero_outside_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int*)meta, (float*)mom, n_seg, m_pad);
    return (int)cudaGetLastError();
}

extern "C" int gsl_subtile_chain(const void* cam, const void* slot3d,
                                 const void* mom, const void* meta,
                                 void* scratch, void* out, int n_seg,
                                 long long m_pad, int n_blocks,
                                 void* stream) {
    const long long blocks =
        (m_pad + gsl::REDUCE_THREADS - 1) / gsl::REDUCE_THREADS;
    if (blocks != n_blocks) return (int)cudaErrorInvalidValue;
    gsl::subtile_chain_kernel<<<(unsigned)blocks, gsl::REDUCE_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const float*)cam, (const float*)slot3d, (const float*)mom,
        (const int*)meta, (float*)scratch, n_seg, m_pad);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    return gsl::launch_sum12((const float*)scratch, (float*)out, n_blocks,
                             (cudaStream_t)stream);
}
