// General rasterizer forward: front-to-back compositing of depth-sorted
// slot records over 16x128 pixel tiles into five images [r, g, b,
// depth_acc, alpha] and a per-tile count of 128-slot chunks walked.
//
// Replaces the Pallas kernel _fwd_kernel (launched by _composite_fwd_impl)
// in the JAX package's ops/rasterize_pallas.py.
//
// Bound: bytes (as chip_smoke.py counts it). One read of the walked record
// columns (10 fields) and one write of the five images; the operations,
// counted only over the (slot, pixel) pairs inside each walked slot's
// alpha-gate footprint, take less time at the card's f32 rate.
//
// Design: one block per tile, 256 threads of 8 pixels (rasterize.cuh: a
// thread holds one column and 8 rows, warp w the 32x8 pixel rectangle of
// columns 32*(w % 4) .. +31 and rows 8*(w / 4) .. +7). Every pixel runs the
// plain version's recurrence in depth order: t_incl = T*(1-alpha), w =
// T*alpha while t_incl > T_EPS, the channels accumulate c*w; a dead pixel
// (T <= T_EPS) and a gated-off pair (alpha 0) are exact no-ops and are
// skipped.
//
// Footprint cull: each slot's footprint box (rasterize.cuh footprint_box)
// bounds the pixels whose alpha can pass the gates. A warp walks only the
// slots whose box meets its rectangle (box_warps), and a lane outside the
// box's columns or a pixel row outside its rows skips the alpha: every
// skipped pair has alpha 0, which the walk skipped before as well, so the
// per-pixel recurrences and the images are unchanged bit for bit. About
// 0.5 % of the pairs the unculled walk met are left on the smoke's scene.
//
// Warps that walk on their own: no pixel belongs to two warps and the
// forward sums nothing across pixels, so the warps never wait for each
// other. Each warp walks its tile's segment 32 slots at a time: its lanes
// stage the 32 slots' records and boxes in the warp's part of shared
// memory (the next 32 slots' records are read while these are walked), a
// ballot on the warp's box_warps bit lists the slots it meets, and it
// walks them in depth order. The walk counts 128-slot chunks from
// floor(start/128)*128 (the first chunk may hold the previous tile's
// slots, which the segment bounds skip); a warp stops at the first chunk
// boundary at which none of its 256 pixels is alive. T only falls, so the
// largest of the 8 warps' stops is the chunk at which the whole tile
// first had no live pixel: the chunks_done of the reference's block-wide
// vote, which the backward walk and the plain version share. Reading the
// next group's records during the walk measured faster; fewer registers
// for more blocks per SM (spills) and the three colour sums in shared
// memory did not. The Hillis-
// Steele scans, the (C, 16) transpose and the MXU payload product of the
// TPU kernel have no counterpart here: they exist only because of Mosaic.
#include "rasterize.cuh"

namespace gsl {

__global__ void __launch_bounds__(RAST_THREADS)
rasterize_fwd_kernel(const int* __restrict__ meta,
                     const float* __restrict__ rec, float* __restrict__ out,
                     int* __restrict__ chunks_done, int n_tx, long long m_pad,
                     long long plane, int wp) {
    // each warp's 32 staged slots: fields 0-9 and box
    __shared__ float s_rec[N_RAST_WARPS][N_FIELDS][32];
    __shared__ int s_box[N_RAST_WARPS][4][32];
    __shared__ int s_stop[N_RAST_WARPS];  // each warp's stop, in chunks

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
    const int n_groups = (end - base + CHUNK - 1) / CHUNK * GROUPS_PER_CHUNK;
    const float x0 = (float)(tj * TILE_W);
    const float y0 = (float)((ti + meta[0]) * TILE_H);

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

    // this lane's slot of the next group (columns at or past m_pad read 0)
    float nxt[N_FIELDS];
    {
        const long long cl = (long long)base + lane;
#pragma unroll
        for (int k = 0; k < N_FIELDS; ++k)
            nxt[k] = (cl < m_pad) ? rec[k * m_pad + cl] : 0.0f;
    }
    int q = 0;
    for (; q < n_groups; ++q) {
        if (q % GROUPS_PER_CHUNK == 0) {
            // a chunk boundary: the warp stops once none of its pixels is
            // alive
            bool alive = false;
#pragma unroll
            for (int p = 0; p < PX_PER_THREAD; ++p)
                alive = alive || (t[p] > T_EPS);
            if (!__any_sync(0xffffffffu, alive)) break;
        }
        const long long cl = (long long)base + (long long)q * 32 + lane;
        float cur[N_FIELDS];
#pragma unroll
        for (int k = 0; k < N_FIELDS; ++k) cur[k] = nxt[k];
        if (q + 1 < n_groups) {
            const long long cn = cl + 32;
#pragma unroll
            for (int k = 0; k < N_FIELDS; ++k)
                nxt[k] = (cn < m_pad) ? rec[k * m_pad + cn] : 0.0f;
        }
        PixBox bx = {TILE_W, -1, TILE_H, -1};
        if (cl >= start && cl < end)
            bx = footprint_box(cur[0], cur[1], cur[2], cur[3], cur[4], cur[6],
                               x0, y0);
        __syncwarp();  // the previous group's readers are done
#pragma unroll
        for (int k = 0; k < N_FIELDS; ++k) s_rec[warp][k][lane] = cur[k];
        s_box[warp][0][lane] = bx.c_lo;
        s_box[warp][1][lane] = bx.c_hi;
        s_box[warp][2][lane] = bx.r_lo;
        s_box[warp][3][lane] = bx.r_hi;
        unsigned todo =
            __ballot_sync(0xffffffffu, (box_warps(bx) >> warp) & 1u);
        __syncwarp();
        while (todo != 0u) {
            const int b = __ffs(todo) - 1;
            todo &= todo - 1u;
            if (col < s_box[warp][0][b] || col > s_box[warp][1][b]) continue;
            const int p_lo = s_box[warp][2][b] - row0;
            const int p_hi = s_box[warp][3][b] - row0;
            const float dx = px - s_rec[warp][0][b];
            const float my = s_rec[warp][1][b];
            const float ca = s_rec[warp][2][b], cb = s_rec[warp][3][b];
            const float cc = s_rec[warp][4][b], dep = s_rec[warp][5][b];
            const float opa = s_rec[warp][6][b];
            const float cr = s_rec[warp][7][b], cg = s_rec[warp][8][b];
            const float cbl = s_rec[warp][9][b];
#pragma unroll
            for (int p = 0; p < PX_PER_THREAD; ++p) {
                // a row outside the box (the same for the warp)
                if (p < p_lo || p > p_hi) continue;
                if (!(t[p] > T_EPS)) continue;
                const float alpha = tile_alpha(dx, py[p] - my, ca, cb, cc, opa);
                if (alpha == 0.0f) continue;
                const float t_incl = t[p] * (1.0f - alpha);
                const float w = (t_incl > T_EPS) ? t[p] * alpha : 0.0f;
                acc[0][p] = acc[0][p] + cr * w;
                acc[1][p] = acc[1][p] + cg * w;
                acc[2][p] = acc[2][p] + cbl * w;
                acc[3][p] = acc[3][p] + dep * w;
                acc[4][p] = acc[4][p] + w;
                t[p] = t_incl;
            }
        }
    }
    if (lane == 0) s_stop[warp] = q / GROUPS_PER_CHUNK;
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        const long long pix =
            (long long)(ti * TILE_H + row0 + p) * wp + tj * TILE_W + col;
#pragma unroll
        for (int k = 0; k < 5; ++k) out[k * plane + pix] = acc[k][p];
    }
    __syncthreads();
    if (tid == 0) {
        // the tile's walk ends with its last warp
        int c = 0;
#pragma unroll
        for (int w = 0; w < N_RAST_WARPS; ++w) c = max(c, s_stop[w]);
        chunks_done[tile] = c;
    }
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
