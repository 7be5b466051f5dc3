// General rasterizer backward: replay of the forward walk with the
// compositing adjoint, emitting per-slot gradients of record fields 0-9
// [d_mx, d_my, d_a, d_b, d_c, d_depth, d_opa, d_r, d_g, d_b].
//
// Replaces the Pallas kernel _bwd_kernel (launched by _composite_bwd) in
// the JAX package's ops/rasterize_pallas.py.
//
// Bound: bytes (as chip_smoke.py counts it). One read of the walked
// slots' 10 record fields, of the five forward images and five
// cotangents, and one write of the (16, M_pad) gradient buffer; the
// operations, counted only over the (slot, pixel) pairs inside each walked
// slot's alpha-gate footprint (the alpha of each, the adjoint of each pair
// that passes the gates), take less time at the card's f32 rate.
//
// Design: the forward's block shape (rasterize.cuh). Each pixel thread
// carries T and the running sum of w*phi; the suffix sum the adjoint needs
// is the forward total g_tot = sum_ch total_ch*g_ch minus that running
// sum, so one forward sweep suffices. The walk covers exactly the chunks
// the forward walked (its chunks_done).
//
// Footprint cull: each slot's footprint box (rasterize.cuh footprint_box,
// with the margin that keeps it conservative against this kernel's own f32
// sigma and expf) bounds the pixels whose alpha can pass the gates. A warp
// walks only the slots whose box meets its 32x8 pixel rectangle, and a
// lane outside the box's columns or a pixel row outside its rows skips the
// alpha. Every skipped pair has alpha 0, which the walk skipped before as
// well (T and the running sum move only on a nonzero alpha), so the
// per-pixel recurrences are unchanged. A box meets 1.05 warps on average
// on the smoke's scene: about 0.6 % of the walked (slot, pixel) pairs are
// left.
//
// Decoupled warps: depth-sorted slots come in spatial runs, so the slots
// of a chunk mostly meet one warp; a block barrier per chunk would make
// the other seven wait. So each warp walks the whole segment on its own,
// 32 slots at a time: its lanes stage the 32 slots' records and boxes in
// the warp's part of shared memory, it walks the slots it meets, and each
// lane then finishes its own slot. A slot that one warp meets gets its
// gradient from that warp; a slot that several warps meet is finished by
// the last of them to arrive, from the others' deposits (rasterize.cuh
// Pending: rings in dynamic shared memory, no block barrier; 20 % of the
// walked slots on the smoke's scene). Slots in the segment that no warp
// meets are written by warp 0.
//
// Per slot, the 10 sums over the tile's pixels are taken in the direct
// form (sum d_sigma*dx, d_sigma*dy, d_sigma*dx*dx, d_sigma*dx*dy,
// d_sigma*dy*dy — no expansion into moments about an origin, which loses
// digits to cancellation), plus sum d_alpha*alpha and sum w*g for r, g,
// b, depth. They are reduced in a fixed order: each thread over its 8
// pixels in row order, then a warp by shuffles (skipped when no lane holds
// a nonzero term), then the warp partials in warp order from +0.0f. That
// is the order of the full walk (every warp against every slot, a block
// sum over the 8 warps): a warp that does not meet a slot held +0.0f for
// it there, no partial or sum is ever -0.0f (every chain starts at +0.0f,
// and x + y is -0.0f only for two -0.0f), so leaving a +0.0f out changes no
// bit, and the gradients equal the full walk's bit for bit. Each slot
// column belongs to exactly one tile, so the tile's block owns it: no
// float atomics, and a result repeats bit for bit. The wrapper zero-fills
// the buffer; the kernel writes rows 0-9 of the walked in-segment columns.
#include "rasterize.cuh"

namespace gsl {

constexpr int N_SUMS = 10;

// Rows 0-9 of slot column cidx from its 10 sums over the tile's pixels.
__device__ __forceinline__ void write_grad(const float s[N_SUMS], float ca,
                                           float cb, float cc, float opa,
                                           float* __restrict__ grad,
                                           long long m_pad, long long cidx) {
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
#pragma unroll
    for (int r = 0; r < N_FIELDS; ++r) grad[(long long)r * m_pad + cidx] = g[r];
}

__global__ void __launch_bounds__(RAST_THREADS)
rasterize_bwd_kernel(const int* __restrict__ meta,
                     const float* __restrict__ rec,
                     const int* __restrict__ chunks_done,
                     const float* __restrict__ px_in,
                     float* __restrict__ grad, int n_tx, long long m_pad,
                     long long plane, int wp) {
    // each warp's 32 staged slots: fields 0-9 and box
    __shared__ float s_rec[N_RAST_WARPS][N_FIELDS][32];
    __shared__ int s_box[N_RAST_WARPS][4][32];
    // each warp's sums of the met slots of its group, per slot
    __shared__ float s_acc[N_RAST_WARPS][N_SUMS][32];
    extern __shared__ float4 s_dyn[];  // the pending multi-warp sums

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
    const float x0 = (float)(tj * TILE_W);
    const float y0 = (float)((ti + meta[0]) * TILE_H);

    const Pending<N_SUMS> pd = pending_init<N_SUMS>(s_dyn);
    __syncthreads();

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

    // Each warp walks the whole segment on its own, 32 slots at a time; no
    // barrier between the warps until the end.
    int n_multi = 0;  // multi-warp slots before this group (every warp's)
    int dcnt = 0;     // lane u < N_RAST_WARPS: warp u's deposits before it
    for (int q = 0; q < n_done * (CHUNK / 32); ++q) {
        const long long c0 = (long long)base + (long long)q * 32;
        const long long cl = c0 + lane;
        __syncwarp();  // the previous group's readers are done
        // stage slot cl in this lane, with its footprint box
        PixBox bx = {TILE_W, -1, TILE_H, -1};
#pragma unroll
        for (int k = 0; k < N_FIELDS; ++k)
            s_rec[warp][k][lane] = (cl < m_pad) ? rec[k * m_pad + cl] : 0.0f;
        const bool in_seg = cl >= start && cl < end;
        if (in_seg)
            bx = footprint_box(s_rec[warp][0][lane], s_rec[warp][1][lane],
                               s_rec[warp][2][lane], s_rec[warp][3][lane],
                               s_rec[warp][4][lane], s_rec[warp][6][lane],
                               x0, y0);
        s_box[warp][0][lane] = bx.c_lo;
        s_box[warp][1][lane] = bx.c_hi;
        s_box[warp][2][lane] = bx.r_lo;
        s_box[warp][3][lane] = bx.r_hi;
        const unsigned wset = box_warps(bx);
        const unsigned met = __ballot_sync(0xffffffffu, (wset >> warp) & 1u);
        if (warp == 0 && in_seg && wset == 0u) {
            // no pixel of the tile can take this slot: its sums are 0
            float s[N_SUMS];
#pragma unroll
            for (int k = 0; k < N_SUMS; ++k) s[k] = 0.0f;
            write_grad(s, s_rec[0][2][lane], s_rec[0][3][lane],
                       s_rec[0][4][lane], s_rec[0][6][lane], grad, m_pad, cl);
        }
        __syncwarp();
        unsigned todo = met;
        while (todo != 0u) {
            const int b = __ffs(todo) - 1;
            todo &= todo - 1u;
            float acc[N_SUMS];
#pragma unroll
            for (int k = 0; k < N_SUMS; ++k) acc[k] = 0.0f;
            if (col >= s_box[warp][0][b] && col <= s_box[warp][1][b]) {
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
                    const float dy = py[p] - my;
                    const float alpha = tile_alpha(dx, dy, ca, cb, cc, opa);
                    // a dead pixel or a gated-off pair changes nothing
                    const bool act = t[p] > T_EPS && alpha != 0.0f;
                    const float one_minus = 1.0f - alpha;
                    const float t_incl = t[p] * one_minus;
                    const bool live = t_incl > T_EPS;
                    const float w = live ? t[p] * alpha : 0.0f;
                    const float phi = cr * gc[0][p] + cg * gc[1][p]
                                      + cbl * gc[2][p] + dep * gc[3][p]
                                      + gc[4][p];
                    const float run_p = run[p] + w * phi;
                    const float suffix = g_tot[p] - run_p;
                    const float inv_om =
                        1.0f / fmaxf(one_minus, ONE_MINUS_ALPHA_MAX);
                    float d_alpha = t[p] * phi - suffix * inv_om;
                    d_alpha = live ? d_alpha : 0.0f;
                    d_alpha = (alpha >= ALPHA_MAX) ? 0.0f : d_alpha;
                    const float ds = d_alpha * (-alpha);
                    acc[0] = act ? acc[0] + ds * dx : acc[0];
                    acc[1] = act ? acc[1] + ds * dy : acc[1];
                    acc[2] = act ? acc[2] + ds * dx * dx : acc[2];
                    acc[3] = act ? acc[3] + ds * dx * dy : acc[3];
                    acc[4] = act ? acc[4] + ds * dy * dy : acc[4];
                    acc[5] = act ? acc[5] + d_alpha * alpha : acc[5];
                    acc[6] = act ? acc[6] + w * gc[0][p] : acc[6];
                    acc[7] = act ? acc[7] + w * gc[1][p] : acc[7];
                    acc[8] = act ? acc[8] + w * gc[2][p] : acc[8];
                    acc[9] = act ? acc[9] + w * gc[3][p] : acc[9];
                    run[p] = act ? run_p : run[p];
                    t[p] = act ? t_incl : t[p];
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
                for (int k = 0; k < N_SUMS; ++k) s_acc[warp][k][b] = acc[k];
            }
        }
        // each lane finishes its own slot if this warp met it
        int dix[N_RAST_WARPS], dix_w;
        const unsigned multi = group_multi(wset, dcnt, dix, dix_w);
        __syncwarp();
        if ((met >> lane) & 1u) {
            float acc[N_SUMS], s[N_SUMS];
#pragma unroll
            for (int k = 0; k < N_SUMS; ++k) acc[k] = s_acc[warp][k][lane];
            bool done = true;
            if (__popc(wset) == 1) {
                // this warp alone meets the slot: 0 + acc is its sum
#pragma unroll
                for (int k = 0; k < N_SUMS; ++k) s[k] = 0.0f + acc[k];
            } else {
                done = pending_deposit(
                    pd, warp, n_multi + __popc(multi & ((1u << lane) - 1u)),
                    wset, dix_w, dix, acc, s);
            }
            if (done)
                write_grad(s, s_rec[warp][2][lane], s_rec[warp][3][lane],
                           s_rec[warp][4][lane], s_rec[warp][6][lane], grad,
                           m_pad, cl);
        }
        n_multi += __popc(multi);
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
    constexpr size_t dyn = gsl::pending_bytes<gsl::N_SUMS>();
    const cudaError_t attr = cudaFuncSetAttribute(
        gsl::rasterize_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (attr != cudaSuccess) return (int)attr;
    gsl::rasterize_bwd_kernel<<<n_tiles, gsl::RAST_THREADS, dyn,
                                (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)rec, (const int*)chunks_done,
        (const float*)px_in, (float*)grad, n_tx, m_pad, plane, wp);
    return (int)cudaGetLastError();
}
