// Shared layout, per-pixel alpha and per-slot footprint box of the tile
// walks (rasterize_fwd.cu, rasterize_bwd.cu, fused_tracking.cu): 16x128
// pixel tiles, one block per tile, 256 threads of 8 pixels each (thread tid
// holds column tid % 128 of rows 8*(tid / 128) .. +7, so warp w holds
// columns 32*(w % 4) .. +31 of rows 8*(w / 4) .. +7), walks that count
// 128-slot chunks from floor(start/128)*128 over the (16, M_pad)
// field-major record buffer, and each warp staging 32 slots at a time.
//
// The alpha follows the plain PyTorch version (ops/rasterize_tiles.py
// _chunk_alpha) term by term, and footprint_box its _footprint_box; the
// library is built with -fmad=false, so a kernel and its plain version land
// on the same side of every gate.
#pragma once

#include "project.cuh"

namespace gsl {

constexpr int TILE_H = 16;
constexpr int TILE_W = 128;
constexpr int RAST_THREADS = 256;
constexpr int PX_PER_THREAD = TILE_H * TILE_W / RAST_THREADS;  // 8
constexpr int N_FIELDS = 10;  // record fields read / gradient rows written
constexpr int GROUPS_PER_CHUNK = CHUNK / 32;  // a warp's 32-slot groups

// Gated alpha of one record at one pixel: sigma >= 0, alpha =
// min(opa * exp(-sigma), ALPHA_MAX) >= ALPHA_MIN, else 0. The clamp keeps
// a NaN (as torch.clamp_max does), which the gate then rejects.
__device__ __forceinline__ float tile_alpha(float dx, float dy, float ca,
                                            float cb, float cc, float opa) {
    const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
    const float e = opa * expf(-sigma);
    const float alpha = (e > ALPHA_MAX) ? ALPHA_MAX : e;
    return (sigma >= 0.0f && alpha >= ALPHA_MIN) ? alpha : 0.0f;
}

// Footprint box of one slot: the tile-local pixel rectangle [c_lo, c_hi] x
// [r_lo, r_hi] (inclusive, clamped to the tile) outside which tile_alpha
// is 0 at every pixel centre, so a walk may skip those pairs as the exact
// no-ops they are. mx, my: the centre; ca, cb, cc: the conic; opa: the
// opacity (K7a, K7b: opacity * ok); x0, y0: the tile's first pixel column and
// row. An empty box is {TILE_W, -1, TILE_H, -1}; the whole tile
// {0, TILE_W-1, 0, TILE_H-1}.
//
// A pair passes only if opa*expf(-sigma) >= ALPHA_MIN in f32, i.e. sigma
// <= L + 5.1u with L = ln(opa/ALPHA_MIN) (u = 2^-24: expf within 2 ulp, the
// product's rounding). The bound S on the EXACT quadratic form at the
// kernel's f32 (dx, dy) adds the f32 evaluation error of sigma: each of its
// terms is within 4u, and |cb dx dy| <= rho * 0.5 (ca dx^2 + cc dy^2), rho =
// |cb|/sqrt(ca cc), so exact - f32 <= 8u/(1-rho) * exact, and 1/(1-rho) <=
// 2 kappa with kappa = ca cc / det. Hence S = L' (1 + 64u kappa), with L'
// = L (1 + 2^-20) + 2^-20 covering logf's 1 ulp, opa * 255 for opa /
// ALPHA_MIN (the f32 ALPHA_MIN is 1/255 within 2^-24) and the 5.1u, and
// det_lo = det - 2^-20 ca cc a lower bound on the exact det. The half
// extents sqrt(2 S cc / det_lo) and sqrt(2 S ca / det_lo) bound |dx| and
// |dy| on that ellipse; 2^-16 of them and of the coordinates covers the
// rounding of dx = px - mx and of the box arithmetic (one reciprocal of
// det_lo serves kappa and both extents). Cases:
// a non-finite field, a conic that is not positive definite (or det_lo <=
// 0) and kappa > 2^16 (a needle so thin that f32 sigma has no relative
// accuracy) keep the whole tile, where the gate decides as before;
// opa < ALPHA_MIN (and opa*ok == 0) is empty, since expf(-sigma) <= 1 for
// sigma >= 0. The plain version is ops/rasterize_tiles.py _footprint_box,
// in the same f32 operation order.
constexpr float BOX_DET_REL = 1.0f / 1048576.0f;  // 2^-20
constexpr float BOX_L_REL = 1.0f / 1048576.0f;    // 2^-20
constexpr float BOX_KAPPA_MAX = 65536.0f;         // 2^16
constexpr float BOX_KAPPA_TERM = 1.0f / 262144.0f;  // 2^-18 = 64u
constexpr float BOX_REL = 1.0f / 65536.0f;        // 2^-16

struct PixBox {
    int c_lo, c_hi, r_lo, r_hi;
};

__device__ __forceinline__ PixBox footprint_box(float mx, float my, float ca,
                                                float cb, float cc, float opa,
                                                float x0, float y0) {
    const PixBox whole = {0, TILE_W - 1, 0, TILE_H - 1};
    const PixBox empty = {TILE_W, -1, TILE_H, -1};
    if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb)
          && isfinite(cc) && isfinite(opa)))
        return whole;
    if (opa < ALPHA_MIN) return empty;
    const float k1 = ca * cc;
    const float det_lo = (k1 - cb * cb) - k1 * BOX_DET_REL;
    if (!(ca > 0.0f && cc > 0.0f && det_lo > 0.0f)) return whole;
    const float inv_det = 1.0f / det_lo;
    const float kappa = k1 * inv_det;
    if (!(kappa <= BOX_KAPPA_MAX)) return whole;
    const float lf = logf(opa * 255.0f);
    const float s = (lf + lf * BOX_L_REL + BOX_L_REL)
                    * (1.0f + kappa * BOX_KAPPA_TERM);
    const float s2 = 2.0f * s * inv_det;
    const float hx = sqrtf(s2 * cc);
    const float hy = sqrtf(s2 * ca);
    const float ex = hx + hx * BOX_REL + (fabsf(mx) + x0 + 1.0f) * BOX_REL;
    const float ey = hy + hy * BOX_REL + (fabsf(my) + y0 + 1.0f) * BOX_REL;
    const float c_lo = fmaxf(ceilf(mx - ex - 0.5f - x0), 0.0f);
    const float c_hi = fminf(floorf(mx + ex - 0.5f - x0), (float)(TILE_W - 1));
    const float r_lo = fmaxf(ceilf(my - ey - 0.5f - y0), 0.0f);
    const float r_hi = fminf(floorf(my + ey - 0.5f - y0), (float)(TILE_H - 1));
    if (!(c_lo <= c_hi && r_lo <= r_hi)) return empty;
    return {(int)c_lo, (int)c_hi, (int)r_lo, (int)r_hi};
}

// The warps of a block whose pixel rectangle a box meets, as a bit mask
// (bit w: warp w holds columns 32*(w % 4) .. +31 of rows 8*(w / 4) .. +7).
__device__ __forceinline__ unsigned box_warps(const PixBox& b) {
    if (b.c_lo > b.c_hi || b.r_lo > b.r_hi) return 0u;
    const unsigned bands = (2u << (b.c_hi >> 5)) - (1u << (b.c_lo >> 5));
    return ((b.r_lo < 8) ? bands : 0u) | ((b.r_hi >= 8) ? bands << 4 : 0u);
}

// Sums of slots that several warps meet, while the decoupled walks
// (rasterize_bwd.cu, fused_tracking.cu fused_bwd) wait for the last of those
// warps. Each warp deposits its sums into its own ring (CAP_DEP entries,
// tagged with the slot's multi-warp index, -1 when free), and counts itself
// into the slot's counter (CAP_CNT entries, each serving the multi-warp
// index in `own`). The warp that completes the count sums the deposits in
// warp order and frees them. A warp waits only when its ring entry or the
// slot's counter is still held by an older slot; the warp furthest behind
// never does (every slot older than its position has all its deposits), so
// the walks cannot deadlock. NS: sums per slot; CD, CC: the capacities
// (the sub-tile walk of subtile_bwd.cu, 8 warps as well, takes smaller
// ones).
constexpr int N_RAST_WARPS = RAST_THREADS / 32;
constexpr int CAP_DEP = 192;
constexpr int CAP_CNT = 512;

template <int NS, int CD = CAP_DEP, int CC = CAP_CNT>
struct Pending {
    float (*dep)[CD][NS];  // [N_RAST_WARPS][CD][NS]
    int (*tag)[CD];        // [N_RAST_WARPS][CD]
    int* cnt;              // [CC]
    int* own;              // [CC]
};

template <int NS, int CD = CAP_DEP, int CC = CAP_CNT>
constexpr size_t pending_bytes() {
    return sizeof(float) * N_RAST_WARPS * CD * NS
           + sizeof(int) * (N_RAST_WARPS * CD + 2 * CC);
}

// Carve the tables out of dynamic shared memory and reset them (every
// thread of the block calls it; the caller then synchronises the block).
template <int NS, int CD = CAP_DEP, int CC = CAP_CNT>
__device__ __forceinline__ Pending<NS, CD, CC> pending_init(void* smem) {
    Pending<NS, CD, CC> pd;
    pd.dep = reinterpret_cast<float (*)[CD][NS]>(smem);
    int* ints = reinterpret_cast<int*>(
        static_cast<float*>(smem) + N_RAST_WARPS * CD * NS);
    pd.tag = reinterpret_cast<int (*)[CD]>(ints);
    pd.cnt = ints + N_RAST_WARPS * CD;
    pd.own = pd.cnt + CC;
    for (int i = threadIdx.x; i < N_RAST_WARPS * CD; i += blockDim.x)
        ints[i] = -1;
    for (int i = threadIdx.x; i < CC; i += blockDim.x) {
        pd.cnt[i] = 0;
        pd.own[i] = i;
    }
    return pd;
}

// A lane of warp w deposits warp w's sums acc of the slot with multi-warp
// index idx, met by the warps of ws, whose deposit in warp u's ring is
// number dix[u] (dix_w for w itself). Returns true, with the sum over ws's
// deposits in warp order from +0.0f in s, if w is the last to arrive.
template <int NS, int CD, int CC>
__device__ __forceinline__ bool pending_deposit(const Pending<NS, CD, CC>& pd,
                                                int w,
                                                int idx, unsigned ws,
                                                int dix_w,
                                                const int dix[N_RAST_WARPS],
                                                const float acc[NS],
                                                float s[NS]) {
    const int r = dix_w % CD;
    volatile int* tag = pd.tag[w];
    while (tag[r] != -1) __nanosleep(64);
    __threadfence_block();
#pragma unroll
    for (int k = 0; k < NS; ++k) pd.dep[w][r][k] = acc[k];
    tag[r] = idx;
    __threadfence_block();
    const int e = idx % CC;
    volatile int* own = pd.own;
    while (own[e] != idx) __nanosleep(64);
    __threadfence_block();
    if (atomicAdd(&pd.cnt[e], 1) != __popc(ws) - 1) return false;
    __threadfence_block();
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = 0.0f;
#pragma unroll
    for (int u = 0; u < N_RAST_WARPS; ++u) {
        if ((ws >> u) & 1u) {
            const volatile float* d = pd.dep[u][dix[u] % CD];
#pragma unroll
            for (int k = 0; k < NS; ++k) s[k] = s[k] + d[k];
        }
    }
    __threadfence_block();
#pragma unroll
    for (int u = 0; u < N_RAST_WARPS; ++u) {
        if ((ws >> u) & 1u)
            ((volatile int*)pd.tag[u])[dix[u] % CD] = -1;
    }
    pd.cnt[e] = 0;
    __threadfence_block();
    own[e] = idx + CC;
    return true;
}

// The multi-warp bookkeeping of a 32-slot group, from each lane's slot's
// warp set wset. dcnt: in lane u < N_RAST_WARPS, warp u's deposits before
// the group (advanced past it here). Sets dix[u] to the number of this
// lane's slot's deposit in warp u's ring (dix_w: in this warp's), and
// returns the group's mask of slots met by several warps. Every lane of the
// warp calls it.
__device__ __forceinline__ unsigned group_multi(unsigned wset, int& dcnt,
                                                int dix[N_RAST_WARPS],
                                                int& dix_w) {
    const bool multi = __popc(wset) > 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    int add = 0;
    dix_w = 0;
#pragma unroll
    for (int u = 0; u < N_RAST_WARPS; ++u) {
        const unsigned m =
            __ballot_sync(0xffffffffu, multi && ((wset >> u) & 1u));
        dix[u] = __shfl_sync(0xffffffffu, dcnt, u) + __popc(m & below);
        if (lane == u) add = __popc(m);
        if (warp == u) dix_w = dix[u];
    }
    dcnt += add;
    return __ballot_sync(0xffffffffu, multi);
}

}  // namespace gsl
