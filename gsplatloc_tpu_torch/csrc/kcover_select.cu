// K-cover select: each pixel's first K covering splats, front to back,
// from the depth-sorted unpadded slot buffer, in two forms that share one
// walk (kcover_select_kernel<kIndex>):
//
//   records (kIndex = false) replaces the Pallas kernel
//     _kcover_select_records_kernel (launched by select_kcover_records in
//     the JAX package's ops/kcover.py): reads slot3d (8, B_pad), projects
//     each staged slot in-kernel and writes the 5 record rows of a hit into
//     the (5, K, M_out) cover buffer;
//   index (kIndex = true) replaces the Pallas kernel _kcover_select_kernel
//     (launched by select_kcover there): reads the projected rows proj8
//     (8, M_pad) that project8 wrote and writes the hit's slot column, as
//     f32, into the (K, M_out) index buffer.
//
// Both project through project.cuh (project8 with the same functions), so
// the two forms find the same hits bit for bit: the records gathered at
// the index form's columns ARE the records form's buffer.
//
// Bound on this card: bytes (one read of the walked slot prefix and one
// write of the output, (5, K, M_out) records or (K, M_out) columns; the
// operations — the staging of every walked slot, and per (slot, pixel) pair
// inside the slot's footprint box six multiply-adds, one expf and the gates
// — take less time at the card's f32 rate). Design: one block per 16x16
// sub-tile, 256 threads of one pixel each; warp w holds pixel rows 2w and
// 2w+1. The block stages 256 slots of its segment at a time into shared
// memory, each slot once: its tile-local sigma polynomial coefficients
// (coeff_mat, after the in-kernel projection in the records form) and its
// footprint box (subtile_box, subtile.cuh) as a column / row bit mask.
// Each warp turns the staged masks into its own list with a ballot (the
// slots whose box meets its two rows) and walks it in slot order; a lane
// whose pixel lies outside a slot's box, or is done, skips the alpha, and
// a warp whose 32 pixels are all done skips its lists. A hit appends the
// slot to its pixel's K-list, kept as slot positions in dynamic shared
// memory, and lowers the pixel's transmittance. The block stops when every
// pixel has K hits or is dead. Then each thread writes its pixel's whole
// list, every entry once, coalesced along the pixel axis: the hits' record
// rows (records) or columns (index), and the zero record or the dummy
// column behind the last hit, so the caller fills nothing.
//
// The cull changes no entry: outside its box sub_alpha is exactly 0, a
// hit needs alpha > 0, and each pixel's list and transmittance are its
// own.
//
// Semantics: liveness is exact PER PIXEL — a pixel admits a hit only while
// its own transmittance is above T_EPS. (The Pallas kernels gate liveness
// per 256-slot block and may admit post-death hits into the tail of a
// K-list; the step render weighs those at <= T_EPS in total.)
#include "subtile.cuh"

namespace gsl {

constexpr int NREC_KC = 5;
constexpr int SEL_STAGE = P_SUB;  // slots staged per round (one per thread)

// Dynamic shared memory of one block: each pixel's K-list of slots.
inline size_t select_list_bytes(int k_cover) {
    return (size_t)k_cover * P_SUB * sizeof(int);
}

// src: slot3d (8, b_pad) for records, proj8 (8, b_pad) for the index form.
// out: (NREC_KC, k_cover, m_out) records or (k_cover, m_out) columns, every
// entry written here (uncovered: the zero record, or the dummy column
// b_pad).
template <bool kIndex>
__global__ void __launch_bounds__(P_SUB)
kcover_select_kernel(const int* __restrict__ meta,
                     const float* __restrict__ cam_p,
                     const float* __restrict__ src, float* __restrict__ out,
                     int k_cover, long long b_pad, long long m_out, int n_tx,
                     float near_p, float far_p) {
    // coeff_mat's rows but qz (row 6), which the select does not read
    __shared__ float s_coef[7][SEL_STAGE];
    __shared__ unsigned s_mask[SEL_STAGE];
    extern __shared__ int s_list[];  // [k][pixel]: the slot of hit k

    const int st = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int start = meta[1 + st];
    const int end = meta[2 + st];
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

    float t = 1.0f;
    int cnt = 0;
    bool done = false;

    for (int base = start; base < end; base += SEL_STAGE) {
        const int i = base + tid;
        unsigned mask = 0u;
        if (i < end) {
            float p8[8], coef[8];
            if constexpr (kIndex) {
#pragma unroll
                for (int r = 0; r < 8; ++r)
                    p8[r] = src[(long long)r * b_pad + i];
            } else {
                // the camera is read per staged slot (it stays in L1) rather
                // than held in registers across the walk
                const Proj pr = project_parts(
                    src[i], src[b_pad + i], src[2 * b_pad + i],
                    src[3 * b_pad + i], src[4 * b_pad + i], load_cam(cam_p));
                project8_rows(pr, near_p, far_p, p8);
            }
            coeff_mat(p8, x0, y0, coef);
#pragma unroll
            for (int r = 0; r < 6; ++r) s_coef[r][tid] = coef[r];
            s_coef[6][tid] = coef[7];
            mask = sub_box_mask(subtile_box(coef, p8[0] - x0, p8[1] - y0));
        }
        s_mask[tid] = mask;
        __syncthreads();
        for (int g = 0; g < SEL_STAGE; g += 32) {
            if (__all_sync(0xffffffffu, done)) break;
            unsigned todo = __ballot_sync(
                0xffffffffu, sub_mask_meets_warp(s_mask[g + lane], warp));
            while (todo != 0u) {
                const int j = g + __ffs(todo) - 1;
                todo &= todo - 1u;
                if (done || !sub_mask_holds(s_mask[j], row, col)) continue;
                const float alpha = sub_alpha(
                    s_coef[0][j], s_coef[1][j], s_coef[2][j], s_coef[3][j],
                    s_coef[4][j], s_coef[5][j], s_coef[6][j], xl, yl, xx,
                    xy, yy);
                if (alpha > 0.0f) {
                    s_list[cnt * P_SUB + tid] = base + j;
                    cnt += 1;
                    t = t * (1.0f - alpha);
                    done = cnt >= k_cover || !(t > T_EPS);
                }
            }
        }
        // also the barrier that protects the staged slots from the next round
        if (__syncthreads_count(done ? 0 : 1) == 0) break;
    }

    const long long pix = (long long)st * P_SUB + tid;
    for (int k = 0; k < k_cover; ++k) {
        const bool hit = k < cnt;
        const int slot = hit ? s_list[k * P_SUB + tid] : 0;
        if constexpr (kIndex) {
            // a column below 2^24 (checked by the caller) is exact in f32
            out[(long long)k * m_out + pix] = hit ? (float)slot : (float)b_pad;
        } else {
#pragma unroll
            for (int r = 0; r < NREC_KC; ++r)
                out[((long long)r * k_cover + k) * m_out + pix] =
                    hit ? src[(long long)r * b_pad + slot] : 0.0f;
        }
    }
}

}  // namespace gsl

extern "C" int gsl_kcover_select_records(const void* meta, const void* cam,
                                         const void* slot3d, void* out,
                                         int k_cover, long long b_pad,
                                         long long m_out, int n_seg, int n_tx,
                                         float near_p, float far_p,
                                         void* stream) {
    if ((long long)n_seg * gsl::P_SUB != m_out)
        return (int)cudaErrorInvalidValue;
    const size_t dyn = gsl::select_list_bytes(k_cover);
    const cudaError_t attr = cudaFuncSetAttribute(
        gsl::kcover_select_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (attr != cudaSuccess) return (int)attr;
    gsl::kcover_select_kernel<false><<<n_seg, gsl::P_SUB, dyn,
                                       (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)cam, (const float*)slot3d,
        (float*)out, k_cover, b_pad, m_out, n_tx, near_p, far_p);
    return (int)cudaGetLastError();
}

extern "C" int gsl_kcover_select(const void* meta, const void* proj8,
                                 void* out, int k_cover, long long m_pad,
                                 long long m_out, int n_seg, int n_tx,
                                 void* stream) {
    if ((long long)n_seg * gsl::P_SUB != m_out || m_pad + 1 > (1LL << 24))
        return (int)cudaErrorInvalidValue;
    const size_t dyn = gsl::select_list_bytes(k_cover);
    const cudaError_t attr = cudaFuncSetAttribute(
        gsl::kcover_select_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (attr != cudaSuccess) return (int)attr;
    gsl::kcover_select_kernel<true><<<n_seg, gsl::P_SUB, dyn,
                                      (cudaStream_t)stream>>>(
        (const int*)meta, nullptr, (const float*)proj8, (float*)out,
        k_cover, m_pad, m_out, n_tx, 0.0f, 0.0f);
    return (int)cudaGetLastError();
}
