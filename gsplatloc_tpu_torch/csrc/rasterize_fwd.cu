// General rasterizer forward: front-to-back compositing of depth-sorted
// slot records over 16x128 pixel tiles into five images [r, g, b,
// depth_acc, alpha] and a per-tile count of 128-slot chunks walked.
//
// Replaces the Pallas kernel _fwd_kernel (launched by _composite_fwd_impl)
// in the JAX package's ops/rasterize_pallas.py.
//
// Bound: operations. Every walked slot meets the 2048 pixels of its tile:
// the conic sigma, one expf and the gates per (slot, pixel), the
// compositing where alpha passes. The bytes are one read of the walked
// record columns (10 fields) and one write of the five images.
//
// Design: one block per tile, 256 threads of 8 pixels (one column, 8
// rows: a warp's 32 threads write 32 neighbouring pixels of a row). The
// block stages one 128-slot chunk of records in shared memory and every
// thread composites the chunk's in-segment slots against its own pixels
// with the plain version's recurrence: t_incl = T*(1-alpha), w = T*alpha
// while t_incl > T_EPS, the channels accumulate c*w. A pixel whose T is at
// or below T_EPS has nothing left to add and is skipped; a gated-off slot
// (alpha 0) is an exact no-op and is skipped too. Between chunks a block
// vote (__syncthreads_or on "some pixel has T > T_EPS") gives the
// reference's chunk-granular stop; chunks are counted from
// floor(start/128)*128, so the first chunk may hold the previous tile's
// slots, which the segment bounds skip. The Hillis-Steele scans, the
// (C, 16) transpose and the MXU payload product of the TPU kernel have no
// counterpart here: they exist only because of Mosaic.
#include "rasterize.cuh"

namespace gsl {

__global__ void __launch_bounds__(RAST_THREADS)
rasterize_fwd_kernel(const int* __restrict__ meta,
                     const float* __restrict__ rec, float* __restrict__ out,
                     int* __restrict__ chunks_done, int n_tx, long long m_pad,
                     long long plane, int wp) {
    __shared__ float s_rec[N_FIELDS][CHUNK];

    const int tile = blockIdx.x;
    const int ti = tile / n_tx;
    const int tj = tile - ti * n_tx;
    const int tid = threadIdx.x;
    const int col = tid % TILE_W;
    const int row0 = (tid / TILE_W) * PX_PER_THREAD;
    const int start = meta[1 + tile];
    const int end = meta[2 + tile];
    const int base = (start / CHUNK) * CHUNK;
    const int n_chunks = (end - base + CHUNK - 1) / CHUNK;

    const float px = (float)(tj * TILE_W + col) + 0.5f;
    float py[PX_PER_THREAD];
    float t[PX_PER_THREAD];
    float acc[5][PX_PER_THREAD];
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        py[p] = (float)((ti + meta[0]) * TILE_H + row0 + p) + 0.5f;
        t[p] = 1.0f;
#pragma unroll
        for (int k = 0; k < 5; ++k) acc[k][p] = 0.0f;
    }

    int c = 0;
    for (; c < n_chunks; ++c) {
        int alive = 0;
#pragma unroll
        for (int p = 0; p < PX_PER_THREAD; ++p) alive |= (t[p] > T_EPS);
        // chunk-granular early stop; also the barrier that protects the
        // staged chunk of the previous round
        if (__syncthreads_or(alive) == 0) break;
        const long long col0 = (long long)base + (long long)c * CHUNK;
        stage_records(rec, col0, m_pad, s_rec);
        __syncthreads();
        const int j_lo = max(start - (int)col0, 0);
        const int j_hi = min(end - (int)col0, CHUNK);
        for (int j = j_lo; j < j_hi; ++j) {
            const float dx = px - s_rec[0][j];
            const float my = s_rec[1][j];
            const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j];
            const float opa = s_rec[6][j];
#pragma unroll
            for (int p = 0; p < PX_PER_THREAD; ++p) {
                if (!(t[p] > T_EPS)) continue;
                const float alpha = tile_alpha(dx, py[p] - my, ca, cb, cc, opa);
                if (alpha == 0.0f) continue;
                const float t_incl = t[p] * (1.0f - alpha);
                const float w = (t_incl > T_EPS) ? t[p] * alpha : 0.0f;
                acc[0][p] = acc[0][p] + s_rec[7][j] * w;
                acc[1][p] = acc[1][p] + s_rec[8][j] * w;
                acc[2][p] = acc[2][p] + s_rec[9][j] * w;
                acc[3][p] = acc[3][p] + s_rec[5][j] * w;
                acc[4][p] = acc[4][p] + w;
                t[p] = t_incl;
            }
        }
    }
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        const long long pix =
            (long long)(ti * TILE_H + row0 + p) * wp + tj * TILE_W + col;
#pragma unroll
        for (int k = 0; k < 5; ++k) out[k * plane + pix] = acc[k][p];
    }
    if (tid == 0) chunks_done[tile] = c;
}

}  // namespace gsl

extern "C" int gsl_rasterize_fwd(const void* meta, const void* rec, void* out,
                                 void* chunks_done, int n_ty, int n_tx,
                                 long long m_pad, void* stream) {
    const int n_tiles = n_ty * n_tx;
    if (n_tiles <= 0) return 0;
    const int wp = n_tx * gsl::TILE_W;
    const long long plane = (long long)n_ty * gsl::TILE_H * wp;
    gsl::rasterize_fwd_kernel<<<n_tiles, gsl::RAST_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)rec, (float*)out, (int*)chunks_done,
        n_tx, m_pad, plane, wp);
    return (int)cudaGetLastError();
}
