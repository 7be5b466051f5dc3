// Sub-tile backward of the kcover=0 tracking path: the alpha replay with
// the compositing adjoint, emitting per-slot pixel moments, and the chain
// from those moments to the 12 pose partials.
//
// subtile_bwd replaces the Pallas kernel _subtile_bwd_kernel (the
// pallas_call in _subtile_vjp_bwd) and subtile_chain replaces _chain_kernel
// (launched by _chain_pallas), both in the JAX package's
// ops/fused_subtile.py.
//
// subtile_bwd — bound: bytes (as chip_smoke.py counts it: one read of the
// walked projected slots and four pixel rows, one write of the (8, M_pad)
// moments; the operations — the staging of every walked slot, and per
// (slot, pixel) pair inside the slot's footprint box the forward's
// polynomial sigma, one expf, the compositing, the adjoint and the moment
// sums — take less time at the card's f32 rate). Design: one block per 16x16 sub-tile, 256 threads of one
// pixel each; warp w holds pixel rows 2w and 2w+1 (lane l: row 2w + l/16,
// column l % 16). Each pixel carries its transmittance T and the running
// sum of w*phi; the suffix sum the adjoint needs is the forward total
// g_d*depth_acc + g_a*alpha minus that running sum, so there is no reverse
// walk. The walk covers the chunks the forward walked (its chunks_done).
//
// Footprint cull: each slot's footprint box (subtile_box, subtile.cuh,
// conservative against this kernel's own f32 polynomial and expf) bounds
// the pixels whose alpha can pass the gates. A warp walks only the slots
// whose box meets its two rows, and a lane outside the box skips the
// alpha. A skipped pair has alpha 0, and a pair of a dead pixel has w = 0
// and d_alpha = 0: either adds only a signed zero to every sum below, and
// leaves T and the running sum as they were.
//
// Decoupled warps (as rasterize_bwd.cu): each warp walks the segment on
// its own, 32 slots at a time. Its lanes stage the 32 slots' polynomial
// coefficients and boxes in the warp's part of shared memory; a ballot
// lists the slots it meets. A warp stops evaluating at the first chunk
// boundary at which none of its 32 pixels is alive and walks on only to
// keep the bookkeeping below; T only falls, so the largest of the warps'
// stops is the forward's chunks_done, the block-wide vote.
//
// Moments, in the order of the unculled kernel: per slot and pixel row,
// d_sigma, x*d_sigma, x^2*d_sigma and w*g_d summed in column order from
// +0.0f (here only over the box's columns, read by shuffles), the six
// moments of the row formed (the y moments from the row's y), the warp's
// two rows added (row 2w first), and the warp partials added in warp order
// from +0.0f. Every chain starts at +0.0f, and x + y is -0.0f only for two
// -0.0f, so no partial is -0.0f; a column, row or warp that meets no pixel
// of the box held only signed zeros there, and leaving them out changes no
// bit: the moments equal the unculled walk's bit for bit. A slot that one
// warp meets gets its moments from that warp; a slot that several warps
// meet is finished by the last of them to arrive, from the others'
// deposits (rasterize.cuh Pending; smaller rings made the warps wait,
// larger ones cost blocks per SM: SUB_CAP_* measured best); slots no warp
// meets are written by warp 0. No float atomics, so a result repeats bit
// for bit. Row 7 carries the sub-tile origin packed as sub_row*ENC_Y +
// sub_col for every slot of a walked chunk; the chunks the walk skips are
// written as zero, all 8 rows, as is every slot outside [meta[1],
// meta[n_seg+1]).
//
// subtile_chain — bound: bytes (one read of the 7 moment rows over the
// walked range and of row 7 and the 5 record rows of the slots with a
// nonzero moment; the projection and pose chain per slot are far below
// the f32 rate for those bytes). A fixed grid of CHAIN_BLOCKS blocks of 256
// threads, the same on every card; the walked range [meta[1],
// meta[n_seg+1]) is read on the device and cut into CHAIN_BLOCKS
// contiguous shares of whole 256-slot rows (the last shares may be short
// or empty), so no thread touches a slot outside it. Thread j of block b
// takes the slots b0 + j, b0 + j + 256, ... of its share in slot order:
// a slot whose 7 moments are all zero is skipped before its record reads
// (its partials would be signed zeros); any other decodes its origin from
// row 7, recomputes project_parts and runs pose_chain into 12 float
// partials from +0.0f, which the thread adds to its 12 sums in double.
// Reads run ahead of the chain: the moments two slots ahead, row 7 and
// the record of the next slot (only if it has a moment) one slot ahead;
// that and the double sums take ~110 registers, so 2 blocks share an SM
// (more blocks with fewer registers spilled or kept the sums in shared
// memory, and measured slower). Reduction order, fixed: per warp a
// shuffle tree (lane l adds lane l + 16, 8, 4, 2, 1) in double, the 8
// warps in warp order into the block's row of a (CHAIN_BLOCKS, 12) double
// scratch; the last block to arrive (an integer ticket after a
// __threadfence; no float atomics) sums the rows: for scalar j, lane l
// adds rows l, l + 32, ... in ascending order and a shuffle tree joins the
// lanes, in double, rounded once to f32. Only the per-slot partials are
// rounded to f32 (as in the plain version) and the sums add no f32
// rounding of their own; the result repeats bit for bit.
#include "reduce.cuh"
#include "subtile.cuh"

namespace gsl {

static_assert(N_SUB_WARPS == N_RAST_WARPS, "Pending serves 8 warps");

constexpr int ENC_Y = 4096;
constexpr int N_MOM = 7;             // 6 moments of d_sigma + sum of w*g_d
constexpr int SUB_CAP_DEP = 128;     // Pending ring entries per warp
constexpr int SUB_CAP_CNT = 256;     // Pending counters
// subtile_chain: a fixed grid, whatever the card (2 blocks on each of an
// H100's 132 SMs), each block a fixed share of the walked range
constexpr int CHAIN_BLOCKS = 264;
constexpr int N_CHAIN_WARPS = REDUCE_THREADS / 32;
constexpr int CHAIN_ROWS_PER_LANE = (CHAIN_BLOCKS + 31) / 32;

__global__ void __launch_bounds__(P_SUB)
subtile_bwd_kernel(const int* __restrict__ meta,
                   const float* __restrict__ proj8,
                   const float* __restrict__ px_in,
                   const int* __restrict__ chunks_done,
                   float* __restrict__ mom, long long m_pad, long long m_out,
                   int n_tx) {
    // each warp's 32 staged slots: polynomial coefficients and box
    __shared__ float s_coef[N_SUB_WARPS][8][32];
    __shared__ int s_box[N_SUB_WARPS][4][32];
    // each warp's moments of the met slots of its group, per slot
    __shared__ float s_acc[N_SUB_WARPS][N_MOM][32];
    extern __shared__ float4 s_dyn[];  // the pending multi-warp sums

    const int st = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int start = meta[1 + st];
    const int end = meta[2 + st];
    const int n_done = chunks_done[st];
    const int n_gx = n_tx * N_SUB_X;
    const int gy = st / n_gx;
    const int gx = st - gy * n_gx;
    const float x0 = (float)(gx * SUB_W);
    const float y0 = (float)((gy + meta[0]) * SUB_H);
    const float enc = (float)((gy + meta[0]) * ENC_Y + gx);

    const Pending<N_MOM, SUB_CAP_DEP, SUB_CAP_CNT> pd =
        pending_init<N_MOM, SUB_CAP_DEP, SUB_CAP_CNT>(s_dyn);
    __syncthreads();

    // this lane's pixel: row 2*warp + lane/16, column lane % 16 (= tid)
    const int row = tid / SUB_W;
    const int col = tid % SUB_W;
    const int row_lane0 = lane & ~(SUB_W - 1);  // first lane of the row
    const float yl = (float)row + 0.5f;
    const float xl = (float)col + 0.5f;
    const float xx = xl * xl, xy = xl * yl, yy = yl * yl;

    const long long pix = (long long)st * P_SUB + tid;
    // pixel rows: forward depth_acc and alpha totals, the two cotangents
    const float g_d = px_in[2 * m_out + pix];
    const float g_a = px_in[3 * m_out + pix];
    const float g_tot = g_d * px_in[pix] + g_a * px_in[m_out + pix];

    float t = 1.0f, run = 0.0f;
    bool walking = true;  // some pixel of this warp is still alive
    int n_multi = 0;      // multi-warp slots before this group (every warp's)
    int dcnt = 0;         // lane u < N_SUB_WARPS: warp u's deposits before it
    for (int q = 0; q < n_done * GROUPS_PER_CHUNK; ++q) {
        if (walking && q % GROUPS_PER_CHUNK == 0)
            walking = __any_sync(0xffffffffu, t > T_EPS);
        const long long cl = (long long)start + (long long)q * 32 + lane;
        // stage slot cl in this lane, with its footprint box
        float p8[8], coef[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) p8[r] = proj8[(long long)r * m_pad + cl];
        coeff_mat(p8, x0, y0, coef);
        const PixBox bx = subtile_box(coef, p8[0] - x0, p8[1] - y0);
        __syncwarp();  // the previous group's readers are done
#pragma unroll
        for (int r = 0; r < 8; ++r) s_coef[warp][r][lane] = coef[r];
        s_box[warp][0][lane] = bx.c_lo;
        s_box[warp][1][lane] = bx.c_hi;
        s_box[warp][2][lane] = bx.r_lo;
        s_box[warp][3][lane] = bx.r_hi;
        const unsigned wset = sub_box_warps(bx);
        const unsigned met = __ballot_sync(0xffffffffu, (wset >> warp) & 1u);
        if (warp == 0 && wset == 0u) {
            // no pixel of the sub-tile can take this slot: its moments are 0
#pragma unroll
            for (int k = 0; k < N_MOM; ++k)
                mom[(long long)k * m_pad + cl] = 0.0f;
            mom[7LL * m_pad + cl] = enc;
        }
        __syncwarp();
        unsigned todo = met;
        while (todo != 0u) {
            const int b = __ffs(todo) - 1;
            todo &= todo - 1u;
            float m[N_MOM];
#pragma unroll
            for (int k = 0; k < N_MOM; ++k) m[k] = 0.0f;
            if (walking) {
                const int c_lo = s_box[warp][0][b], c_hi = s_box[warp][1][b];
                float ds = 0.0f, wg = 0.0f;
                if (col >= c_lo && col <= c_hi && row >= s_box[warp][2][b]
                    && row <= s_box[warp][3][b] && t > T_EPS) {
                    const float alpha = sub_alpha(
                        s_coef[warp][0][b], s_coef[warp][1][b],
                        s_coef[warp][2][b], s_coef[warp][3][b],
                        s_coef[warp][4][b], s_coef[warp][5][b],
                        s_coef[warp][7][b], xl, yl, xx, xy, yy);
                    const float one_minus = 1.0f - alpha;
                    const float t_incl = t * one_minus;
                    const bool live = t_incl > T_EPS;
                    const float w = live ? t * alpha : 0.0f;
                    const float phi = g_d * s_coef[warp][6][b] + g_a;
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
                // the row sums in column order, over the box's columns
                float s0 = 0.0f, sx = 0.0f, sxx = 0.0f, swg = 0.0f;
                for (int cc = c_lo; cc <= c_hi; ++cc) {
                    const float v = __shfl_sync(0xffffffffu, ds, row_lane0 + cc);
                    const float g = __shfl_sync(0xffffffffu, wg, row_lane0 + cc);
                    const float x = (float)cc + 0.5f;
                    s0 = s0 + v;
                    sx = sx + v * x;
                    sxx = sxx + v * (x * x);
                    swg = swg + g;
                }
                m[0] = s0;
                m[1] = sx;
                m[2] = yl * s0;
                m[3] = sxx;
                m[4] = yl * sx;
                m[5] = (yl * yl) * s0;
                m[6] = swg;
                // lane 0 (row 2*warp) takes the row below (lane 16)
#pragma unroll
                for (int k = 0; k < N_MOM; ++k)
                    m[k] = m[k] + __shfl_down_sync(0xffffffffu, m[k], 16);
            }
            if (lane == 0) {
#pragma unroll
                for (int k = 0; k < N_MOM; ++k) s_acc[warp][k][b] = m[k];
            }
        }
        // each lane finishes its own slot if this warp met it
        int dix[N_SUB_WARPS], dix_w;
        const unsigned multi = group_multi(wset, dcnt, dix, dix_w);
        __syncwarp();
        if ((met >> lane) & 1u) {
            float acc[N_MOM], s[N_MOM];
#pragma unroll
            for (int k = 0; k < N_MOM; ++k) acc[k] = s_acc[warp][k][lane];
            bool done = true;
            if (__popc(wset) == 1) {
                // this warp alone meets the slot: 0 + acc is its sum
#pragma unroll
                for (int k = 0; k < N_MOM; ++k) s[k] = 0.0f + acc[k];
            } else {
                done = pending_deposit(
                    pd, warp, n_multi + __popc(multi & ((1u << lane) - 1u)),
                    wset, dix_w, dix, acc, s);
            }
            if (done) {
#pragma unroll
                for (int k = 0; k < N_MOM; ++k)
                    mom[(long long)k * m_pad + cl] = s[k];
                mom[7LL * m_pad + cl] = enc;
            }
        }
        n_multi += __popc(multi);
    }
    // the chunks the walk skipped hold no gradient: write zeros
    for (long long i = (long long)start + (long long)n_done * CHUNK + tid;
         i < end; i += P_SUB) {
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

// Moment rows 0-6 of slot i (0 for a slot at or past end).
__device__ __forceinline__ void load_moments(const float* __restrict__ mom,
                                             long long m_pad, long long i,
                                             long long end,
                                             float mv[N_MOM]) {
#pragma unroll
    for (int r = 0; r < N_MOM; ++r)
        mv[r] = (i < end) ? mom[(long long)r * m_pad + i] : 0.0f;
}

__device__ __forceinline__ bool any_moment(const float mv[N_MOM]) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < N_MOM; ++r) any = any || (mv[r] != 0.0f);
    return any;
}

// Row 7 and the 5 record rows of slot i, read only if it has a moment.
__device__ __forceinline__ void load_record(const float* __restrict__ mom,
                                            const float* __restrict__ slot3d,
                                            long long m_pad, long long i,
                                            bool any, float rv[6]) {
    rv[0] = any ? mom[7LL * m_pad + i] : 0.0f;
#pragma unroll
    for (int r = 0; r < 5; ++r)
        rv[r + 1] = any ? slot3d[(long long)r * m_pad + i] : 0.0f;
}

__global__ void __launch_bounds__(REDUCE_THREADS, 2)
subtile_chain_kernel(const float* __restrict__ cam_p,
                     const float* __restrict__ slot3d,
                     const float* __restrict__ mom,
                     const int* __restrict__ meta,
                     double* __restrict__ scratch, int* __restrict__ ticket,
                     float* __restrict__ out, int n_seg, long long m_pad) {
    __shared__ Cam s_cam;
    __shared__ double s_warp[N_CHAIN_WARPS][12];
    __shared__ bool s_last;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) s_cam = load_cam(cam_p);
    // this block's share of the walked range: whole rows of 256 slots
    const long long lo = meta[1];
    const long long hi = meta[n_seg + 1];
    const long long rows = (hi - lo + REDUCE_THREADS - 1) / REDUCE_THREADS;
    const long long share =
        (rows + CHAIN_BLOCKS - 1) / CHAIN_BLOCKS * REDUCE_THREADS;
    const long long b0 = lo + (long long)blockIdx.x * share;
    const long long b1 = min(b0 + share, hi);
    __syncthreads();

    // this thread's slots b0 + tid + 256 k, in slot order, summed in
    // double. Reads run ahead of the chain: the moments two slots ahead,
    // the record of the next slot (if it has a moment) one slot ahead.
    double acc[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[j] = 0.0;
    long long i = b0 + tid;
    float m1[N_MOM], m2[N_MOM], r1[6];
    load_moments(mom, m_pad, i, b1, m1);
    load_moments(mom, m_pad, i + REDUCE_THREADS, b1, m2);
    bool any1 = any_moment(m1);
    load_record(mom, slot3d, m_pad, i, any1, r1);
    for (; i < b1; i += REDUCE_THREADS) {
        float mv[N_MOM], rv[6];
#pragma unroll
        for (int r = 0; r < N_MOM; ++r) {
            mv[r] = m1[r];
            m1[r] = m2[r];
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) rv[r] = r1[r];
        const bool any = any1;
        load_moments(mom, m_pad, i + 2 * REDUCE_THREADS, b1, m2);
        any1 = any_moment(m1);
        load_record(mom, slot3d, m_pad, i + REDUCE_THREADS, any1, r1);
        if (!any) continue;  // a zero column adds only signed zeros
        // decode the sub-tile origin packed in row 7 by subtile_bwd
        const float ty = floorf(rv[0] * (1.0f / (float)ENC_Y));
        const float x0 = (rv[0] - (float)ENC_Y * ty) * (float)SUB_W;
        const float y0 = ty * (float)SUB_H;
        const Proj pr = project_parts(rv[1], rv[2], rv[3], rv[4], rv[5],
                                      s_cam);
        float part[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) part[j] = 0.0f;
        pose_chain(pr, s_cam, mv[0], mv[1], mv[2], mv[3], mv[4], mv[5],
                   mv[6], x0, y0, part);
#pragma unroll
        for (int j = 0; j < 12; ++j) acc[j] = acc[j] + (double)part[j];
    }

    // the block's 256 sums: a fixed shuffle tree per warp, the warps in
    // order, into the block's scratch row
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        double v = acc[j];
#pragma unroll
        for (int ofs = 16; ofs > 0; ofs >>= 1)
            v = v + __shfl_down_sync(0xffffffffu, v, ofs);
        if (lane == 0) s_warp[warp][j] = v;
    }
    __syncthreads();
    if (tid < 12) {
        double v = 0.0;
#pragma unroll
        for (int w = 0; w < N_CHAIN_WARPS; ++w) v = v + s_warp[w][tid];
        scratch[(long long)blockIdx.x * 12 + tid] = v;
        __threadfence();  // the row is visible before the ticket is taken
    }
    __syncthreads();
    if (tid == 0)
        s_last = atomicAdd(ticket, 1) == CHAIN_BLOCKS - 1;
    __syncthreads();
    if (!s_last) return;

    // the last block to arrive: scalar j (warp j % 8) sums the blocks' rows
    // l, l + 32, ... in lane l in ascending order, then a fixed shuffle tree
    __threadfence();
    for (int j = warp; j < 12; j += N_CHAIN_WARPS) {
        double v = 0.0;
#pragma unroll
        for (int r = 0; r < CHAIN_ROWS_PER_LANE; ++r) {
            const int row = lane + 32 * r;
            if (row < CHAIN_BLOCKS)
                v = v + __ldcg(scratch + (long long)row * 12 + j);
        }
#pragma unroll
        for (int ofs = 16; ofs > 0; ofs >>= 1)
            v = v + __shfl_down_sync(0xffffffffu, v, ofs);
        if (lane == 0) out[j] = (float)v;
    }
    if (tid >= 12 && tid < 16) out[tid] = 0.0f;
}

}  // namespace gsl

extern "C" int gsl_subtile_bwd(const void* meta, const void* proj8,
                               const void* px_in, const void* chunks_done,
                               void* mom, int n_seg, long long m_pad,
                               long long m_out, int n_tx, void* stream) {
    if ((long long)n_seg * gsl::P_SUB != m_out)
        return (int)cudaErrorInvalidValue;
    constexpr size_t dyn =
        gsl::pending_bytes<gsl::N_MOM, gsl::SUB_CAP_DEP, gsl::SUB_CAP_CNT>();
    const cudaError_t attr = cudaFuncSetAttribute(
        gsl::subtile_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (attr != cudaSuccess) return (int)attr;
    gsl::subtile_bwd_kernel<<<n_seg, gsl::P_SUB, dyn, (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)proj8, (const float*)px_in,
        (const int*)chunks_done, (float*)mom, m_pad, m_out, n_tx);
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
                                 void* scratch, void* ticket, void* out,
                                 int n_seg, long long m_pad, int n_blocks,
                                 void* stream) {
    if (n_blocks != gsl::CHAIN_BLOCKS) return (int)cudaErrorInvalidValue;
    gsl::subtile_chain_kernel<<<gsl::CHAIN_BLOCKS, gsl::REDUCE_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const float*)cam, (const float*)slot3d, (const float*)mom,
        (const int*)meta, (double*)scratch, (int*)ticket, (float*)out, n_seg,
        m_pad);
    return (int)cudaGetLastError();
}
