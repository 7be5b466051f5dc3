// Full-tile fused tracking render: the forward walk with in-kernel
// projection (fused_fwd), its replay with the compositing adjoint reduced
// to the 12 pose partials (fused_bwd), and the per-slot contribution probe
// that drives the slot-buffer compaction (fused_probe).
//
// fused_fwd replaces the Pallas kernel _fused_fwd_kernel (launched by
// _fused_fwd_impl), fused_bwd replaces _fused_bwd_kernel (launched by
// _fused_vjp_bwd) and fused_probe replaces _fused_probe_kernel (launched by
// fused_probe), all in the JAX package's ops/fused_tracking.py.
//
// Bound, counted over what this data needs: bytes for fused_fwd and
// fused_probe (one read of the walked slots' five record rows x, y, z, s2,
// opacity and of the pixel images, one write of the outputs), operations
// for fused_bwd (the pose chain of every slot with a nonzero sum), with the
// per-pair operations counted only over the (slot, pixel) pairs inside each
// slot's alpha-gate footprint. All three walk only the pixels of each
// slot's footprint box (below).
//
// In all three, the validity row is folded into the opacity (0 unless
// ok), which gates alpha to 0 exactly as the plain version's explicit gate
// does, and every pixel runs the plain version's sequential recurrence:
// t_incl = T*(1-alpha), w = T*alpha while t_incl > T_EPS, payload [qz, 1]
// in the forward. A dead pixel or a gated-off (slot, pixel) pair is an
// exact no-op and is skipped. Projection is project_parts / project8_rows
// of project.cuh, in the plain version's operation order, with the
// current camera; reads at or past M_pad return 0. The reference's
// Hillis-Steele scans, MXU payload products and speculative
// double-buffered DMA have no counterpart: they exist only for Mosaic.
//
// fused_fwd and fused_probe are one walk template, fused_walk_kernel, with
// a compile-time epilogue. It walks as rasterize_fwd.cu does (whose note
// says more): each
// warp on its own over the tile's segment, 32 slots at a time, its lanes
// projecting the 32 slots into the warp's part of shared memory with
// their footprint boxes (a slot that fails the ok gate, or whose opacity
// is below 1/255, has an empty box); the warp walks only the slots whose
// box meets its 32x8 pixel rectangle, skips the columns and rows outside
// a box, and stops at the first 128-slot chunk boundary at which none of
// its pixels is alive. The largest of the 8 warps' stops is the tile's
// chunks_done, the chunk of the reference's block-wide vote. Every slot
// is projected by all 8 warps: a block that projects each 128-slot chunk
// once and then lets its warps walk it needs a barrier per chunk, at
// which the warps wait for the busiest, and measured slower; so did
// reading the next 32 slots' rows during the walk. Capped at 64 registers
// so that 4 blocks share an SM and the 430 tiles of a 1200x680 frame run
// in one wave. (An earlier forward that skipped a whole slot on a zero
// opacity was miscompiled by nvcc 12.8 at -O3; an empty box is the same
// skip, and the kernel is held bit-equal to its plain version at full
// size.)
//
// fused_bwd: each pixel thread carries T and the running sum of w*phi
// (phi = g_d*qz + g_a); the suffix the adjoint needs is the forward total
// g_d*D + g_a*A minus that sum. It walks like rasterize_bwd.cu (whose note
// says more): each warp on its own over the whole segment, 32 slots at a
// time, its lanes projecting the 32 slots with the current camera into the
// warp's part of shared memory (opacity folded with ok) with their
// footprint boxes (a slot that fails the ok gate, or whose opacity is below
// 1/255, has an empty box); the warp walks only the slots whose box meets
// its 32x8 pixel rectangle, and skips the columns and rows outside a box,
// pairs whose alpha is 0 and that were exact no-ops before as well. Per
// slot, six sums over the tile's pixels in the direct form (d_sigma*dx,
// d_sigma*dy, d_sigma*dx^2, d_sigma*dx*dy, d_sigma*dy^2 with dx = px - u,
// and w*g_d): each thread over its 8 pixels in row order, the warp by
// shuffles (skipped when no lane holds a nonzero term), the warps that met
// the slot in warp order from +0.0f (the last of them to arrive sums the
// others' deposits, rasterize.cuh Pending), into a (6, M_pad) scratch.
// That is the order of the walk without the cull, in which every warp met
// every slot: leaving out a +0.0f changes no bit (no partial is ever
// -0.0f). After a block barrier, lane j of warp g runs pose_chain for slot
// j of the block's group g (8 groups of 32 slots at a time) with the slot's
// own (u, v) as the moment origin, the 32 slots' partials join by a fixed
// shuffle tree, thread 0 adds the groups in walk order, writes the tile's
// 12 partials to a (n_tiles, 12) scratch, and reduce.cuh's second pass sums
// the tiles in a fixed order in double. No float atomics: the pose partials
// equal the full walk's bit for bit, and a gradient and a tracking run
// repeat bit for bit.
//
// fused_probe runs fused_fwd's walk with the same recurrence (a pixel
// updates T = T*(1-alpha) wherever T > T_EPS and alpha != 0, so its T and
// its stops are fused_fwd's, and its chunks_done equals fused_fwd's) and
// no accumulators or image. A slot reaches a pixel exactly where that
// update happens. Per 32-slot group each lane keeps a bit mask of the
// staged slots that reached one of its 8 pixels, the warp ORs the masks
// (__reduce_or_sync), and the lane that staged a reached slot writes
// contrib = 1.0f at its column. A slot that several warps reach gets the
// same 1.0f from each: idempotent, deterministic, no float atomics. Only
// in-segment slots have a box, so a block writes only its own segment's
// walked columns; the wrapper zero-fills the buffer, so every other column,
// and every walked slot that reached no pixel, stays 0. A slot skipped by
// the cull has alpha 0 at every pixel it skips, and a warp that stopped
// has no live pixel left, so neither could have reached a pixel: contrib
// is the block-synchronous walk's, bit for bit.
#include "rasterize.cuh"
#include "reduce.cuh"

namespace gsl {

constexpr int N_PROJ = 7;   // staged rows: u, v, ca, cb, cc, qz, opacity*ok
constexpr int N_ISO = 5;    // record rows read: x, y, z, s2, opacity
constexpr int N_SUMS = 6;   // per-slot sums of the backward

// Slot col projected with the current camera: out = [u, v, ca, cb, cc,
// qz, opacity * ok] (reads at or past M_pad return 0).
__device__ __forceinline__ void project_slot(const float* __restrict__ slot3d,
                                             long long col, long long m_pad,
                                             const Cam& cam, float near_p,
                                             float far_p, float out[N_PROJ]) {
    float r[N_ISO];
#pragma unroll
    for (int k = 0; k < N_ISO; ++k)
        r[k] = (col < m_pad) ? slot3d[(long long)k * m_pad + col] : 0.0f;
    const Proj p = project_parts(r[0], r[1], r[2], r[3], r[4], cam);
    float p8[8];
    project8_rows(p, near_p, far_p, p8);
#pragma unroll
    for (int k = 0; k < 6; ++k) out[k] = p8[k];
    out[6] = (p8[7] != 0.0f) ? p8[6] : 0.0f;
}

struct TileWalk {
    int tile, ti, tj, col, row0, start, end, base, n_chunks;
    float px;
};

__device__ __forceinline__ TileWalk tile_walk(const int* __restrict__ meta,
                                              int n_tx) {
    TileWalk w;
    w.tile = blockIdx.x;
    w.ti = w.tile / n_tx;
    w.tj = w.tile - w.ti * n_tx;
    w.col = threadIdx.x % TILE_W;
    w.row0 = (threadIdx.x / TILE_W) * PX_PER_THREAD;
    w.start = meta[1 + w.tile];
    w.end = meta[2 + w.tile];
    w.base = (w.start / CHUNK) * CHUNK;
    w.n_chunks = (w.end - w.base + CHUNK - 1) / CHUNK;
    w.px = (float)(w.tj * TILE_W + w.col) + 0.5f;
    return w;
}

// The forward walk of one 16x128 tile (K7a, kProbe false: out is the
// (2, hp, wp) image) or the probe's (K7c, kProbe true: out is contrib, and a
// lane that staged a slot some lane of the warp reached writes 1.0f there).
template <bool kProbe>
__global__ void __launch_bounds__(RAST_THREADS, 4)
fused_walk_kernel(const int* __restrict__ meta,
                  const float* __restrict__ cam_p,
                  const float* __restrict__ slot3d, float* __restrict__ out,
                  int* __restrict__ chunks_done, int n_tx, long long m_pad,
                  long long plane, int wp, float near_p, float far_p) {
    // each warp's 32 staged slots: projected rows (opacity * ok) and box
    __shared__ float s_p[N_RAST_WARPS][N_PROJ][32];
    __shared__ int s_box[N_RAST_WARPS][4][32];
    __shared__ int s_stop[N_RAST_WARPS];  // each warp's stop, in chunks

    const TileWalk tw = tile_walk(meta, n_tx);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const Cam cam = load_cam(cam_p);
    const float x0 = (float)(tw.tj * TILE_W);
    const float y0 = (float)((tw.ti + meta[0]) * TILE_H);
    float py[PX_PER_THREAD], t[PX_PER_THREAD];
    float acc_d[PX_PER_THREAD], acc_a[PX_PER_THREAD];
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        py[p] = (float)((tw.ti + meta[0]) * TILE_H + tw.row0 + p) + 0.5f;
        t[p] = 1.0f;
        acc_d[p] = 0.0f;
        acc_a[p] = 0.0f;
    }

    // Each warp walks the segment on its own, 32 slots at a time, and stops
    // at the first chunk boundary at which none of its pixels is alive.
    const int n_groups = tw.n_chunks * GROUPS_PER_CHUNK;
    int q = 0;
    for (; q < n_groups; ++q) {
        if (q % GROUPS_PER_CHUNK == 0) {
            bool alive = false;
#pragma unroll
            for (int p = 0; p < PX_PER_THREAD; ++p)
                alive = alive || (t[p] > T_EPS);
            if (!__any_sync(0xffffffffu, alive)) break;
        }
        const long long cl = (long long)tw.base + (long long)q * 32 + lane;
        // project slot cl in this lane with the current camera (opacity
        // folded with ok), with its footprint box
        float o[N_PROJ];
        project_slot(slot3d, cl, m_pad, cam, near_p, far_p, o);
        PixBox bx = {TILE_W, -1, TILE_H, -1};
        if (cl >= tw.start && cl < tw.end)
            bx = footprint_box(o[0], o[1], o[2], o[3], o[4], o[6], x0, y0);
        __syncwarp();  // the previous group's readers are done
#pragma unroll
        for (int k = 0; k < N_PROJ; ++k) s_p[warp][k][lane] = o[k];
        s_box[warp][0][lane] = bx.c_lo;
        s_box[warp][1][lane] = bx.c_hi;
        s_box[warp][2][lane] = bx.r_lo;
        s_box[warp][3][lane] = bx.r_hi;
        unsigned todo =
            __ballot_sync(0xffffffffu, (box_warps(bx) >> warp) & 1u);
        __syncwarp();
        unsigned reached = 0u;  // K7c: the group's slots this lane reached
        while (todo != 0u) {
            const int b = __ffs(todo) - 1;
            todo &= todo - 1u;
            if (tw.col < s_box[warp][0][b] || tw.col > s_box[warp][1][b])
                continue;
            const int p_lo = s_box[warp][2][b] - tw.row0;
            const int p_hi = s_box[warp][3][b] - tw.row0;
            const float dx = tw.px - s_p[warp][0][b];
            const float v = s_p[warp][1][b];
            const float ca = s_p[warp][2][b], cb = s_p[warp][3][b];
            const float cc = s_p[warp][4][b], qz = s_p[warp][5][b];
            const float opa = s_p[warp][6][b];
            bool reach = false;
#pragma unroll
            for (int p = 0; p < PX_PER_THREAD; ++p) {
                // a row outside the box (the same for the warp)
                if (p < p_lo || p > p_hi) continue;
                if (!(t[p] > T_EPS)) continue;
                const float alpha = tile_alpha(dx, py[p] - v, ca, cb, cc, opa);
                if (alpha == 0.0f) continue;
                const float t_incl = t[p] * (1.0f - alpha);
                if constexpr (kProbe) {
                    reach = true;
                } else {
                    const float w = (t_incl > T_EPS) ? t[p] * alpha : 0.0f;
                    acc_d[p] = acc_d[p] + qz * w;
                    acc_a[p] = acc_a[p] + w;
                }
                t[p] = t_incl;
            }
            if (reach) reached |= 1u << b;
        }
        if constexpr (kProbe) {
            // the slots some lane reached; a reached slot is in the segment
            reached = __reduce_or_sync(0xffffffffu, reached);
            if ((reached >> lane) & 1u) out[cl] = 1.0f;
        }
    }
    if (lane == 0) s_stop[warp] = q / GROUPS_PER_CHUNK;
    if constexpr (!kProbe) {
#pragma unroll
        for (int p = 0; p < PX_PER_THREAD; ++p) {
            const long long pix = (long long)(tw.ti * TILE_H + tw.row0 + p)
                                  * wp + tw.tj * TILE_W + tw.col;
            out[pix] = acc_d[p];
            out[plane + pix] = acc_a[p];
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        // the tile's walk ends with its last warp
        int c = 0;
#pragma unroll
        for (int w = 0; w < N_RAST_WARPS; ++w) c = max(c, s_stop[w]);
        chunks_done[tw.tile] = c;
    }
}

__global__ void __launch_bounds__(RAST_THREADS)
fused_bwd_kernel(const int* __restrict__ meta, const float* __restrict__ cam_p,
                 const float* __restrict__ slot3d,
                 const int* __restrict__ chunks_done,
                 const float* __restrict__ px_in, float* __restrict__ sums,
                 float* __restrict__ scratch, int n_tx, long long m_pad,
                 long long plane, int wp, float near_p, float far_p) {
    // each warp's 32 staged slots: projected rows (opacity * ok) and box
    __shared__ float s_p[N_RAST_WARPS][N_PROJ][32];
    __shared__ int s_box[N_RAST_WARPS][4][32];
    // each warp's sums of the met slots of its group, per slot
    __shared__ float s_acc[N_RAST_WARPS][N_SUMS][32];
    __shared__ float s_grp[N_RAST_WARPS][12];  // 32 slots' joined partials
    extern __shared__ float4 s_dyn[];  // the pending multi-warp sums

    const TileWalk tw = tile_walk(meta, n_tx);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_done = chunks_done[tw.tile];
    const Cam cam = load_cam(cam_p);
    const float x0 = (float)(tw.tj * TILE_W);
    const float y0 = (float)((tw.ti + meta[0]) * TILE_H);

    const Pending<N_SUMS> pd = pending_init<N_SUMS>(s_dyn);
    __syncthreads();

    float py[PX_PER_THREAD], t[PX_PER_THREAD], run[PX_PER_THREAD];
    float gd[PX_PER_THREAD], ga[PX_PER_THREAD], g_tot[PX_PER_THREAD];
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        py[p] = (float)((tw.ti + meta[0]) * TILE_H + tw.row0 + p) + 0.5f;
        t[p] = 1.0f;
        run[p] = 0.0f;
        const long long pix = (long long)(tw.ti * TILE_H + tw.row0 + p) * wp
                              + tw.tj * TILE_W + tw.col;
        gd[p] = px_in[2 * plane + pix];
        ga[p] = px_in[3 * plane + pix];
        g_tot[p] = gd[p] * px_in[pix] + ga[p] * px_in[plane + pix];
    }

    // Each warp walks the whole segment on its own, 32 slots at a time; the
    // warps meet only at the pose chain after the walk.
    const int n_groups = n_done * (CHUNK / 32);
    int n_multi = 0;  // multi-warp slots before this group (every warp's)
    int dcnt = 0;     // lane u < N_RAST_WARPS: warp u's deposits before it
    for (int q = 0; q < n_groups; ++q) {
        const long long c0 = (long long)tw.base + (long long)q * 32;
        const long long cl = c0 + lane;
        __syncwarp();  // the previous group's readers are done
        // project slot cl in this lane with the current camera (opacity
        // folded with ok), with its footprint box
        {
            float o[N_PROJ];
            project_slot(slot3d, cl, m_pad, cam, near_p, far_p, o);
#pragma unroll
            for (int k = 0; k < N_PROJ; ++k) s_p[warp][k][lane] = o[k];
        }
        PixBox bx = {TILE_W, -1, TILE_H, -1};
        const bool in_seg = cl >= tw.start && cl < tw.end;
        if (in_seg)
            bx = footprint_box(s_p[warp][0][lane], s_p[warp][1][lane],
                               s_p[warp][2][lane], s_p[warp][3][lane],
                               s_p[warp][4][lane], s_p[warp][6][lane], x0, y0);
        s_box[warp][0][lane] = bx.c_lo;
        s_box[warp][1][lane] = bx.c_hi;
        s_box[warp][2][lane] = bx.r_lo;
        s_box[warp][3][lane] = bx.r_hi;
        const unsigned wset = box_warps(bx);
        const unsigned met = __ballot_sync(0xffffffffu, (wset >> warp) & 1u);
        if (warp == 0 && in_seg && wset == 0u) {
            // no pixel of the tile can take this slot: its sums are 0
#pragma unroll
            for (int k = 0; k < N_SUMS; ++k) sums[k * m_pad + cl] = 0.0f;
        }
        __syncwarp();
        unsigned todo = met;
        while (todo != 0u) {
            const int b = __ffs(todo) - 1;
            todo &= todo - 1u;
            float acc[N_SUMS];
#pragma unroll
            for (int k = 0; k < N_SUMS; ++k) acc[k] = 0.0f;
            if (tw.col >= s_box[warp][0][b] && tw.col <= s_box[warp][1][b]) {
                const int p_lo = s_box[warp][2][b] - tw.row0;
                const int p_hi = s_box[warp][3][b] - tw.row0;
                const float dx = tw.px - s_p[warp][0][b];
                const float v = s_p[warp][1][b];
                const float ca = s_p[warp][2][b], cb = s_p[warp][3][b];
                const float cc = s_p[warp][4][b], qz = s_p[warp][5][b];
                const float opa = s_p[warp][6][b];
#pragma unroll
                for (int p = 0; p < PX_PER_THREAD; ++p) {
                    // a row outside the box (the same for the warp)
                    if (p < p_lo || p > p_hi) continue;
                    const float dy = py[p] - v;
                    const float alpha = tile_alpha(dx, dy, ca, cb, cc, opa);
                    // a dead pixel or a gated-off pair changes nothing
                    const bool act = t[p] > T_EPS && alpha != 0.0f;
                    const float one_minus = 1.0f - alpha;
                    const float t_incl = t[p] * one_minus;
                    const bool live = t_incl > T_EPS;
                    const float w = live ? t[p] * alpha : 0.0f;
                    const float phi = gd[p] * qz + ga[p];
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
                    acc[5] = act ? acc[5] + w * gd[p] : acc[5];
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
            if (done) {
#pragma unroll
                for (int k = 0; k < N_SUMS; ++k) sums[k * m_pad + cl] = s[k];
            }
        }
        n_multi += __popc(multi);
    }
    __syncthreads();  // every walked slot's sums are in `sums`

    // The pose chain: 32 slots per warp, 8 groups at a time, joined in
    // walk order (the order of a walk in which every warp met every slot).
    float blk[12];  // the tile's partials, held by thread 0
#pragma unroll
    for (int k = 0; k < 12; ++k) blk[k] = 0.0f;
    for (int q0 = 0; q0 < n_groups; q0 += N_RAST_WARPS) {
        const int q = q0 + warp;
        float part[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) part[k] = 0.0f;
        const long long cl = (long long)tw.base + (long long)q * 32 + lane;
        if (q < n_groups && cl >= tw.start && cl < tw.end) {
            float s[N_SUMS];
            bool any = false;
#pragma unroll
            for (int k = 0; k < N_SUMS; ++k) {
                s[k] = sums[k * m_pad + cl];
                any = any || (s[k] != 0.0f);
            }
            if (any) {
                const Proj pr = project_parts(
                    slot3d[cl], slot3d[m_pad + cl], slot3d[2 * m_pad + cl],
                    slot3d[3 * m_pad + cl], slot3d[4 * m_pad + cl], cam);
                pose_chain(pr, cam, 0.0f, s[0], s[1], s[2], s[3], s[4], s[5],
                           pr.u, pr.v, part);
            }
        }
        // the 32 slots' partials joined by a fixed shuffle tree
#pragma unroll
        for (int k = 0; k < 12; ++k) {
            float v = part[k];
#pragma unroll
            for (int ofs = 16; ofs > 0; ofs >>= 1)
                v = v + __shfl_down_sync(0xffffffffu, v, ofs);
            if (lane == 0) s_grp[warp][k] = v;
        }
        __syncthreads();
        if (tid == 0) {
            for (int w = 0; w < N_RAST_WARPS && q0 + w < n_groups; ++w) {
#pragma unroll
                for (int k = 0; k < 12; ++k) blk[k] = blk[k] + s_grp[w][k];
            }
        }
        __syncthreads();
    }
    if (tid == 0) {
#pragma unroll
        for (int k = 0; k < 12; ++k)
            scratch[(long long)tw.tile * 12 + k] = blk[k];
    }
}

}  // namespace gsl

extern "C" int gsl_fused_fwd(const void* meta, const void* cam,
                             const void* slot3d, void* out, void* chunks_done,
                             int n_ty, int n_tx, long long m_pad, float near_p,
                             float far_p, void* stream) {
    const int n_tiles = n_ty * n_tx;
    if (n_tiles <= 0) return 0;
    const int wp = n_tx * gsl::TILE_W;
    const long long plane = (long long)n_ty * gsl::TILE_H * wp;
    gsl::fused_walk_kernel<false><<<n_tiles, gsl::RAST_THREADS, 0,
                                    (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)cam, (const float*)slot3d,
        (float*)out, (int*)chunks_done, n_tx, m_pad, plane, wp, near_p,
        far_p);
    return (int)cudaGetLastError();
}

extern "C" int gsl_fused_bwd(const void* meta, const void* cam,
                             const void* slot3d, const void* chunks_done,
                             const void* px_in, void* sums, void* scratch,
                             void* out,
                             int n_ty, int n_tx, long long m_pad, float near_p,
                             float far_p, void* stream) {
    const int n_tiles = n_ty * n_tx;
    if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
    const int wp = n_tx * gsl::TILE_W;
    const long long plane = (long long)n_ty * gsl::TILE_H * wp;
    constexpr size_t dyn = gsl::pending_bytes<gsl::N_SUMS>();
    const cudaError_t attr = cudaFuncSetAttribute(
        gsl::fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (attr != cudaSuccess) return (int)attr;
    gsl::fused_bwd_kernel<<<n_tiles, gsl::RAST_THREADS, dyn,
                            (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)cam, (const float*)slot3d,
        (const int*)chunks_done, (const float*)px_in, (float*)sums,
        (float*)scratch, n_tx, m_pad, plane, wp, near_p, far_p);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    return gsl::launch_sum12((const float*)scratch, (float*)out, n_tiles,
                             (cudaStream_t)stream);
}

extern "C" int gsl_fused_probe(const void* meta, const void* cam,
                               const void* slot3d, void* contrib,
                               void* chunks_done, int n_ty, int n_tx,
                               long long m_pad, float near_p, float far_p,
                               void* stream) {
    const int n_tiles = n_ty * n_tx;
    if (n_tiles <= 0) return 0;
    gsl::fused_walk_kernel<true><<<n_tiles, gsl::RAST_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)cam, (const float*)slot3d,
        (float*)contrib, (int*)chunks_done, n_tx, m_pad, 0, 0, near_p, far_p);
    return (int)cudaGetLastError();
}
