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
// slot's alpha-gate footprint. The kernels are far slower than either: each
// walked slot meets all 2048 pixels of its 16x128 tile, as the reference's
// kernels do.
//
// Design: the general rasterizer's tile layout (rasterize.cuh): one block
// per tile, 256 threads of 8 pixels, 128-slot chunks from
// floor(start/128)*128, a block vote for the chunk-granular stop. While a
// chunk is staged, threads 0-127 project one slot each with the current
// camera (project_parts / project8_rows of project.cuh, the plain
// version's operation order) into shared memory; the validity row is
// folded into the opacity (0 unless ok), which gates alpha to 0 exactly as
// the plain version's explicit gate does. Reads at or past M_pad return 0.
// Every thread runs the plain version's sequential per-pixel recurrence:
// t_incl = T*(1-alpha), w = T*alpha while t_incl > T_EPS, payload [qz, 1].
// A dead pixel or a gated-off (slot, pixel) pair is an exact no-op and is
// skipped. (A whole-slot skip on a zero opacity, also exact, made nvcc 12.8
// drop most of the forward's contributions at -O3; it is left out.) The
// reference's Hillis-Steele scans, MXU payload products and speculative
// double-buffered DMA have no counterpart: they exist only for Mosaic.
//
// fused_bwd: each pixel thread carries T and the running sum of w*phi
// (phi = g_d*qz + g_a); the suffix the adjoint needs is the forward total
// g_d*D + g_a*A minus that sum. Per slot, six sums over the tile's pixels
// in the direct form (d_sigma*dx, d_sigma*dy, d_sigma*dx^2, d_sigma*dx*dy,
// d_sigma*dy^2 with dx = px - u, and w*g_d): each thread over its 8 pixels,
// the warp by shuffles (skipped when no lane holds a nonzero term), the 8
// warps in warp order through shared memory. Then lane j of warp 0 runs
// pose_chain for slot j with the slot's own (u, v) as the moment origin,
// the 32 slots' partials join by a fixed shuffle tree, the block adds them
// in chunk order, writes its 12 partials to a (n_tiles, 12) scratch, and
// reduce.cuh's second pass sums the tiles in a fixed order in double. No
// float atomics: a gradient and a tracking run repeat bit for bit.
//
// fused_probe: the forward's walk; each thread keeps, per 32 slots, a bit
// mask of the slots that reach one of its pixels (alpha > 0 at a live
// T_prefix), the warp ORs the masks, and threads 0-127 OR the 8 warps' and
// write contrib = 1.0 or 0.0 for the chunk's in-segment columns. A block
// writes only its own segment's walked columns; the wrapper zero-fills the
// buffer.
#include "rasterize.cuh"
#include "reduce.cuh"

namespace gsl {

constexpr int N_PROJ = 7;   // staged rows: u, v, ca, cb, cc, qz, opacity*ok
constexpr int N_ISO = 5;    // record rows read: x, y, z, s2, opacity
constexpr int N_SUMS = 6;   // per-slot sums of the backward
constexpr int FUSED_FLUSH = 32;  // slots whose warp partials are held at once
constexpr int N_WARPS_T = RAST_THREADS / 32;

// Threads 0..CHUNK-1 project slot col0 + threadIdx.x with the current
// camera into s_p (and, with KEEP_REC, copy its record rows into s_rec).
template <bool KEEP_REC>
__device__ __forceinline__ void stage_projected(
        const float* __restrict__ slot3d, long long col0, long long m_pad,
        const Cam& cam, float near_p, float far_p, float (*s_p)[CHUNK],
        float (*s_rec)[CHUNK]) {
    const int j = threadIdx.x;
    if (j >= CHUNK) return;
    const long long col = col0 + j;
    float r[N_ISO];
#pragma unroll
    for (int k = 0; k < N_ISO; ++k)
        r[k] = (col < m_pad) ? slot3d[(long long)k * m_pad + col] : 0.0f;
    const Proj p = project_parts(r[0], r[1], r[2], r[3], r[4], cam);
    float p8[8];
    project8_rows(p, near_p, far_p, p8);
#pragma unroll
    for (int k = 0; k < 6; ++k) s_p[k][j] = p8[k];
    s_p[6][j] = (p8[7] != 0.0f) ? p8[6] : 0.0f;
    if (KEEP_REC) {
#pragma unroll
        for (int k = 0; k < N_ISO; ++k) s_rec[k][j] = r[k];
    }
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

__global__ void __launch_bounds__(RAST_THREADS)
fused_fwd_kernel(const int* __restrict__ meta, const float* __restrict__ cam_p,
                 const float* __restrict__ slot3d, float* __restrict__ out,
                 int* __restrict__ chunks_done, int n_tx, long long m_pad,
                 long long plane, int wp, float near_p, float far_p) {
    __shared__ float s_p[N_PROJ][CHUNK];

    const TileWalk tw = tile_walk(meta, n_tx);
    const Cam cam = load_cam(cam_p);
    float py[PX_PER_THREAD], t[PX_PER_THREAD];
    float acc_d[PX_PER_THREAD], acc_a[PX_PER_THREAD];
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        py[p] = (float)((tw.ti + meta[0]) * TILE_H + tw.row0 + p) + 0.5f;
        t[p] = 1.0f;
        acc_d[p] = 0.0f;
        acc_a[p] = 0.0f;
    }

    int c = 0;
    for (; c < tw.n_chunks; ++c) {
        int alive = 0;
#pragma unroll
        for (int p = 0; p < PX_PER_THREAD; ++p) alive |= (t[p] > T_EPS);
        // chunk-granular early stop; also the barrier that protects the
        // staged chunk of the previous round
        if (__syncthreads_or(alive) == 0) break;
        const long long col0 = (long long)tw.base + (long long)c * CHUNK;
        stage_projected<false>(slot3d, col0, m_pad, cam, near_p, far_p, s_p,
                               nullptr);
        __syncthreads();
        const int j_lo = max(tw.start - (int)col0, 0);
        const int j_hi = min(tw.end - (int)col0, CHUNK);
        for (int j = j_lo; j < j_hi; ++j) {
            const float dx = tw.px - s_p[0][j];
            const float v = s_p[1][j];
            const float ca = s_p[2][j], cb = s_p[3][j], cc = s_p[4][j];
            const float qz = s_p[5][j], opa = s_p[6][j];
#pragma unroll
            for (int p = 0; p < PX_PER_THREAD; ++p) {
                if (!(t[p] > T_EPS)) continue;
                const float alpha = tile_alpha(dx, py[p] - v, ca, cb, cc, opa);
                if (alpha == 0.0f) continue;
                const float t_incl = t[p] * (1.0f - alpha);
                const float w = (t_incl > T_EPS) ? t[p] * alpha : 0.0f;
                acc_d[p] = acc_d[p] + qz * w;
                acc_a[p] = acc_a[p] + w;
                t[p] = t_incl;
            }
        }
    }
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        const long long pix = (long long)(tw.ti * TILE_H + tw.row0 + p) * wp
                              + tw.tj * TILE_W + tw.col;
        out[pix] = acc_d[p];
        out[plane + pix] = acc_a[p];
    }
    if (threadIdx.x == 0) chunks_done[tw.tile] = c;
}

__global__ void __launch_bounds__(RAST_THREADS)
fused_bwd_kernel(const int* __restrict__ meta, const float* __restrict__ cam_p,
                 const float* __restrict__ slot3d,
                 const int* __restrict__ chunks_done,
                 const float* __restrict__ px_in, float* __restrict__ scratch,
                 int n_tx, long long m_pad, long long plane, int wp,
                 float near_p, float far_p) {
    __shared__ float s_p[N_PROJ][CHUNK];
    __shared__ float s_rec[N_ISO][CHUNK];
    __shared__ float s_part[N_WARPS_T][FUSED_FLUSH][N_SUMS + 1];

    const TileWalk tw = tile_walk(meta, n_tx);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_done = chunks_done[tw.tile];
    const Cam cam = load_cam(cam_p);

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
    float blk[12];  // the tile's partials, held by thread 0
#pragma unroll
    for (int k = 0; k < 12; ++k) blk[k] = 0.0f;

    for (int c = 0; c < n_done; ++c) {
        const long long col0 = (long long)tw.base + (long long)c * CHUNK;
        __syncthreads();  // the previous chunk's readers are done
        stage_projected<true>(slot3d, col0, m_pad, cam, near_p, far_p, s_p,
                              s_rec);
        __syncthreads();
        const int j_lo = max(tw.start - (int)col0, 0);
        const int j_hi = min(tw.end - (int)col0, CHUNK);
        for (int sb = 0; sb < CHUNK; sb += FUSED_FLUSH) {
            for (int jj = 0; jj < FUSED_FLUSH; ++jj) {
                const int j = sb + jj;
                float acc[N_SUMS];
#pragma unroll
                for (int k = 0; k < N_SUMS; ++k) acc[k] = 0.0f;
                if (j >= j_lo && j < j_hi) {
                    const float dx = tw.px - s_p[0][j];
                    const float v = s_p[1][j];
                    const float ca = s_p[2][j], cb = s_p[3][j];
                    const float cc = s_p[4][j], qz = s_p[5][j];
                    const float opa = s_p[6][j];
#pragma unroll
                    for (int p = 0; p < PX_PER_THREAD; ++p) {
                        if (!(t[p] > T_EPS)) continue;
                        const float dy = py[p] - v;
                        const float alpha = tile_alpha(dx, dy, ca, cb, cc, opa);
                        if (alpha == 0.0f) continue;
                        const float one_minus = 1.0f - alpha;
                        const float t_incl = t[p] * one_minus;
                        const bool live = t_incl > T_EPS;
                        const float w = live ? t[p] * alpha : 0.0f;
                        const float phi = gd[p] * qz + ga[p];
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
                        acc[5] = acc[5] + w * gd[p];
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
            if (warp == 0) {
                // lane jj: slot sb + jj's sums over the 8 warps, in order,
                // then its pose chain
                const int j = sb + lane;
                float part[12];
#pragma unroll
                for (int k = 0; k < 12; ++k) part[k] = 0.0f;
                if (j >= j_lo && j < j_hi) {
                    float s[N_SUMS];
                    bool any = false;
#pragma unroll
                    for (int k = 0; k < N_SUMS; ++k) {
                        float v = 0.0f;
#pragma unroll
                        for (int w = 0; w < N_WARPS_T; ++w)
                            v = v + s_part[w][lane][k];
                        s[k] = v;
                        any = any || (v != 0.0f);
                    }
                    if (any) {
                        const Proj pr = project_parts(
                            s_rec[0][j], s_rec[1][j], s_rec[2][j],
                            s_rec[3][j], s_rec[4][j], cam);
                        pose_chain(pr, cam, 0.0f, s[0], s[1], s[2], s[3],
                                   s[4], s[5], pr.u, pr.v, part);
                    }
                }
                // the FLUSH slots' partials joined by a fixed shuffle tree
#pragma unroll
                for (int k = 0; k < 12; ++k) {
                    float v = part[k];
#pragma unroll
                    for (int ofs = 16; ofs > 0; ofs >>= 1)
                        v = v + __shfl_down_sync(0xffffffffu, v, ofs);
                    if (lane == 0) blk[k] = blk[k] + v;
                }
            }
            __syncthreads();  // s_part is reused by the next FLUSH slots
        }
    }
    if (tid == 0) {
#pragma unroll
        for (int k = 0; k < 12; ++k)
            scratch[(long long)tw.tile * 12 + k] = blk[k];
    }
}

__global__ void __launch_bounds__(RAST_THREADS)
fused_probe_kernel(const int* __restrict__ meta,
                   const float* __restrict__ cam_p,
                   const float* __restrict__ slot3d,
                   float* __restrict__ contrib, int* __restrict__ chunks_done,
                   int n_tx, long long m_pad, float near_p, float far_p) {
    __shared__ float s_p[N_PROJ][CHUNK];
    __shared__ unsigned s_or[N_WARPS_T][CHUNK / 32];

    const TileWalk tw = tile_walk(meta, n_tx);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const Cam cam = load_cam(cam_p);
    float py[PX_PER_THREAD], t[PX_PER_THREAD];
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
        py[p] = (float)((tw.ti + meta[0]) * TILE_H + tw.row0 + p) + 0.5f;
        t[p] = 1.0f;
    }

    int c = 0;
    for (; c < tw.n_chunks; ++c) {
        int alive = 0;
#pragma unroll
        for (int p = 0; p < PX_PER_THREAD; ++p) alive |= (t[p] > T_EPS);
        // chunk-granular stop, as fused_fwd; also the barrier that protects
        // s_p and s_or of the previous round
        if (__syncthreads_or(alive) == 0) break;
        const long long col0 = (long long)tw.base + (long long)c * CHUNK;
        stage_projected<false>(slot3d, col0, m_pad, cam, near_p, far_p, s_p,
                               nullptr);
        __syncthreads();
        const int j_lo = max(tw.start - (int)col0, 0);
        const int j_hi = min(tw.end - (int)col0, CHUNK);
        for (int g = 0; g < CHUNK / 32; ++g) {
            unsigned mask = 0u;
            for (int b = 0; b < 32; ++b) {
                const int j = g * 32 + b;
                if (j < j_lo || j >= j_hi) continue;
                const float dx = tw.px - s_p[0][j];
                const float v = s_p[1][j];
                const float ca = s_p[2][j], cb = s_p[3][j], cc = s_p[4][j];
                const float opa = s_p[6][j];
                bool reach = false;
#pragma unroll
                for (int p = 0; p < PX_PER_THREAD; ++p) {
                    if (!(t[p] > T_EPS)) continue;
                    const float alpha =
                        tile_alpha(dx, py[p] - v, ca, cb, cc, opa);
                    if (alpha == 0.0f) continue;
                    reach = true;
                    t[p] = t[p] * (1.0f - alpha);
                }
                if (reach) mask |= 1u << b;
            }
            mask = __reduce_or_sync(0xffffffffu, mask);
            if (lane == 0) s_or[warp][g] = mask;
        }
        __syncthreads();
        if (tid < CHUNK && tid >= j_lo && tid < j_hi) {
            unsigned any = 0u;
#pragma unroll
            for (int w = 0; w < N_WARPS_T; ++w) any |= s_or[w][tid >> 5];
            contrib[col0 + tid] = ((any >> (tid & 31)) & 1u) ? 1.0f : 0.0f;
        }
    }
    if (tid == 0) chunks_done[tw.tile] = c;
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
    gsl::fused_fwd_kernel<<<n_tiles, gsl::RAST_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)cam, (const float*)slot3d,
        (float*)out, (int*)chunks_done, n_tx, m_pad, plane, wp, near_p,
        far_p);
    return (int)cudaGetLastError();
}

extern "C" int gsl_fused_bwd(const void* meta, const void* cam,
                             const void* slot3d, const void* chunks_done,
                             const void* px_in, void* scratch, void* out,
                             int n_ty, int n_tx, long long m_pad, float near_p,
                             float far_p, void* stream) {
    const int n_tiles = n_ty * n_tx;
    if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
    const int wp = n_tx * gsl::TILE_W;
    const long long plane = (long long)n_ty * gsl::TILE_H * wp;
    gsl::fused_bwd_kernel<<<n_tiles, gsl::RAST_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)cam, (const float*)slot3d,
        (const int*)chunks_done, (const float*)px_in, (float*)scratch, n_tx,
        m_pad, plane, wp, near_p, far_p);
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
    gsl::fused_probe_kernel<<<n_tiles, gsl::RAST_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)cam, (const float*)slot3d,
        (float*)contrib, (int*)chunks_done, n_tx, m_pad, near_p, far_p);
    return (int)cudaGetLastError();
}
