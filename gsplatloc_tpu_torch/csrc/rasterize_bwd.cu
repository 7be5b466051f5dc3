// General rasterizer backward: replay of the forward walk with the
// compositing adjoint, emitting per-slot gradients of record fields 0-9
// [d_mx, d_my, d_a, d_b, d_c, d_depth, d_opa, d_r, d_g, d_b].
//
// Replaces the Pallas kernel _bwd_kernel (launched by _composite_bwd) in
// the JAX package's ops/rasterize_pallas.py.
//
// Bound: operations. Every walked slot meets the 2048 pixels of its tile:
// the forward's alpha, then for each pair that passes the gates the
// adjoint (phi, the running sum, the suffix divide) and 10 products summed
// per slot. The bytes are one read of the walked record columns, of the
// five forward images and five cotangents, and one write of the
// (16, M_pad) gradient buffer.
//
// Design: the forward's block shape (rasterize.cuh). Each pixel thread
// carries T and the running sum of w*phi; the suffix sum the adjoint needs
// is the forward total g_tot = sum_ch total_ch*g_ch minus that running
// sum, so one forward sweep suffices. The walk covers exactly the chunks
// the forward walked (its chunks_done). Per slot, the 10 sums over the
// tile's pixels are taken in the direct form (sum d_sigma*dx, d_sigma*dy,
// d_sigma*dx*dx, d_sigma*dx*dy, d_sigma*dy*dy — no expansion into
// moments about an origin, which loses digits to cancellation), plus
// sum d_alpha*alpha and sum w*g for r, g, b, depth. They are reduced in a
// fixed order: each thread over its 8 pixels, then a warp by shuffles
// (skipped when no lane holds a nonzero term), then FLUSH slots at a time
// the 8 warp partials in warp order through shared memory. Each slot
// column belongs to exactly one tile, so the tile's block owns it: no
// float atomics, and a result repeats bit for bit. The wrapper zero-fills
// the buffer; the kernel writes rows 0-9 of the walked in-segment columns.
#include "rasterize.cuh"

namespace gsl {

constexpr int N_SUMS = 10;
constexpr int FLUSH = 32;  // slots whose warp partials are held at once
constexpr int N_WARPS = RAST_THREADS / 32;

__global__ void __launch_bounds__(RAST_THREADS)
rasterize_bwd_kernel(const int* __restrict__ meta,
                     const float* __restrict__ rec,
                     const int* __restrict__ chunks_done,
                     const float* __restrict__ px_in,
                     float* __restrict__ grad, int n_tx, long long m_pad,
                     long long plane, int wp) {
    __shared__ float s_rec[N_FIELDS][CHUNK];
    __shared__ float s_part[N_WARPS][FLUSH][N_SUMS + 1];

    const int tile = blockIdx.x;
    const int ti = tile / n_tx;
    const int tj = tile - ti * n_tx;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int col = tid % TILE_W;
    const int row0 = (tid / TILE_W) * PX_PER_THREAD;
    const int start = meta[1 + tile];
    const int end = meta[2 + tile];
    const int base = (start / CHUNK) * CHUNK;
    const int n_done = chunks_done[tile];

    const float px = (float)(tj * TILE_W + col) + 0.5f;
    float py[PX_PER_THREAD], t[PX_PER_THREAD], run[PX_PER_THREAD];
    float g_tot[PX_PER_THREAD], gc[5][PX_PER_THREAD];
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        py[p] = (float)((ti + meta[0]) * TILE_H + row0 + p) + 0.5f;
        t[p] = 1.0f;
        run[p] = 0.0f;
        const long long pix =
            (long long)(ti * TILE_H + row0 + p) * wp + tj * TILE_W + col;
#pragma unroll
        for (int k = 0; k < 5; ++k) gc[k][p] = px_in[(5 + k) * plane + pix];
        g_tot[p] = gc[0][p] * px_in[pix] + gc[1][p] * px_in[plane + pix]
                   + gc[2][p] * px_in[2 * plane + pix]
                   + gc[3][p] * px_in[3 * plane + pix]
                   + gc[4][p] * px_in[4 * plane + pix];
    }

    for (int c = 0; c < n_done; ++c) {
        const long long col0 = (long long)base + (long long)c * CHUNK;
        __syncthreads();  // the previous chunk's readers are done
        stage_records(rec, col0, m_pad, s_rec);
        __syncthreads();
        const int j_lo = max(start - (int)col0, 0);
        const int j_hi = min(end - (int)col0, CHUNK);
        for (int sb = 0; sb < CHUNK; sb += FLUSH) {
            for (int jj = 0; jj < FLUSH; ++jj) {
                const int j = sb + jj;
                float acc[N_SUMS];
#pragma unroll
                for (int k = 0; k < N_SUMS; ++k) acc[k] = 0.0f;
                if (j >= j_lo && j < j_hi) {
                    const float dx = px - s_rec[0][j];
                    const float my = s_rec[1][j];
                    const float ca = s_rec[2][j], cb = s_rec[3][j];
                    const float cc = s_rec[4][j], dep = s_rec[5][j];
                    const float opa = s_rec[6][j];
                    const float cr = s_rec[7][j], cg = s_rec[8][j];
                    const float cbl = s_rec[9][j];
#pragma unroll
                    for (int p = 0; p < PX_PER_THREAD; ++p) {
                        if (!(t[p] > T_EPS)) continue;
                        const float dy = py[p] - my;
                        const float alpha = tile_alpha(dx, dy, ca, cb, cc, opa);
                        if (alpha == 0.0f) continue;
                        const float one_minus = 1.0f - alpha;
                        const float t_incl = t[p] * one_minus;
                        const bool live = t_incl > T_EPS;
                        const float w = live ? t[p] * alpha : 0.0f;
                        const float phi = cr * gc[0][p] + cg * gc[1][p]
                                          + cbl * gc[2][p] + dep * gc[3][p]
                                          + gc[4][p];
                        run[p] = run[p] + w * phi;
                        const float suffix = g_tot[p] - run[p];
                        const float inv_om =
                            1.0f / fmaxf(one_minus, ONE_MINUS_ALPHA_MAX);
                        float d_alpha = t[p] * phi - suffix * inv_om;
                        d_alpha = live ? d_alpha : 0.0f;
                        d_alpha = (alpha >= ALPHA_MAX) ? 0.0f : d_alpha;
                        const float ds = d_alpha * (-alpha);
                        acc[0] = acc[0] + ds * dx;
                        acc[1] = acc[1] + ds * dy;
                        acc[2] = acc[2] + ds * dx * dx;
                        acc[3] = acc[3] + ds * dx * dy;
                        acc[4] = acc[4] + ds * dy * dy;
                        acc[5] = acc[5] + d_alpha * alpha;
                        acc[6] = acc[6] + w * gc[0][p];
                        acc[7] = acc[7] + w * gc[1][p];
                        acc[8] = acc[8] + w * gc[2][p];
                        acc[9] = acc[9] + w * gc[3][p];
                        t[p] = t_incl;
                    }
                }
                bool nz = false;
#pragma unroll
                for (int k = 0; k < N_SUMS; ++k) nz = nz || (acc[k] != 0.0f);
                if (__any_sync(0xffffffffu, nz)) {
#pragma unroll
                    for (int k = 0; k < N_SUMS; ++k) {
#pragma unroll
                        for (int ofs = 16; ofs > 0; ofs >>= 1)
                            acc[k] = acc[k]
                                     + __shfl_down_sync(0xffffffffu, acc[k], ofs);
                    }
                }
                if (lane == 0) {
#pragma unroll
                    for (int k = 0; k < N_SUMS; ++k) s_part[warp][jj][k] = acc[k];
                }
            }
            __syncthreads();
            const int j = sb + tid;
            if (tid < FLUSH && j >= j_lo && j < j_hi) {
                float s[N_SUMS];
#pragma unroll
                for (int k = 0; k < N_SUMS; ++k) {
                    float v = 0.0f;
#pragma unroll
                    for (int w = 0; w < N_WARPS; ++w) v = v + s_part[w][tid][k];
                    s[k] = v;
                }
                const float ca = s_rec[2][j], cb = s_rec[3][j];
                const float cc = s_rec[4][j], opa = s_rec[6][j];
                float g[N_FIELDS];
                g[0] = -(ca * s[0] + cb * s[1]);
                g[1] = -(cc * s[1] + cb * s[0]);
                g[2] = 0.5f * s[2];
                g[3] = s[3];
                g[4] = 0.5f * s[4];
                g[5] = s[9];
                g[6] = s[5] / fmaxf(opa, 1e-12f);
                g[7] = s[6];
                g[8] = s[7];
                g[9] = s[8];
                const long long cidx = col0 + j;
#pragma unroll
                for (int r = 0; r < N_FIELDS; ++r)
                    grad[(long long)r * m_pad + cidx] = g[r];
            }
            __syncthreads();  // s_part is reused by the next FLUSH slots
        }
    }
}

}  // namespace gsl

extern "C" int gsl_rasterize_bwd(const void* meta, const void* rec,
                                 const void* chunks_done, const void* px_in,
                                 void* grad, int n_ty, int n_tx,
                                 long long m_pad, void* stream) {
    const int n_tiles = n_ty * n_tx;
    if (n_tiles <= 0) return 0;
    const int wp = n_tx * gsl::TILE_W;
    const long long plane = (long long)n_ty * gsl::TILE_H * wp;
    gsl::rasterize_bwd_kernel<<<n_tiles, gsl::RAST_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)rec, (const int*)chunks_done,
        (const float*)px_in, (float*)grad, n_tx, m_pad, plane, wp);
    return (int)cudaGetLastError();
}
