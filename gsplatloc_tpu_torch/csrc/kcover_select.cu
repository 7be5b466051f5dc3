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
// Bound on this card: operations. Every walked slot meets the 256 pixels
// of its sub-tile (six multiply-adds and one expf per pair) while the
// bytes are one read of the walked slot prefix and one write of the
// output. Design: one block per 16x16 sub-tile, one thread per pixel. The
// block stages 256 slots of its segment at a time into shared memory as
// tile-local sigma polynomial coefficients (coeff_mat, after the in-kernel
// projection in the records form); each thread then walks the staged
// slots against its own pixel, appends its own hits to its K-list and
// carries its own transmittance. The block stops when every pixel has K
// hits or is dead. No rank scan, no extraction product: a thread writes
// where it wants.
//
// Semantics: liveness is exact PER PIXEL — a pixel admits a hit only while
// its own transmittance is above T_EPS. (The Pallas kernels gate liveness
// per 256-slot block and may admit post-death hits into the tail of a
// K-list; the step render weighs those at <= T_EPS in total.)
#include "project.cuh"

namespace gsl {

constexpr int NREC_KC = 5;
constexpr int SEL_STAGE = P_SUB;  // slots staged per round (one per thread)

// src: slot3d (8, b_pad) for records, proj8 (8, b_pad) for the index form.
// out: (NREC_KC, k_cover, m_out) records, zero-filled by the caller, or
// (k_cover, m_out) columns, filled with the dummy column by the caller;
// the kernel writes hits only.
template <bool kIndex>
__global__ void __launch_bounds__(P_SUB)
kcover_select_kernel(const int* __restrict__ meta,
                     const float* __restrict__ cam_p,
                     const float* __restrict__ src, float* __restrict__ out,
                     int k_cover, long long b_pad, long long m_out, int n_tx,
                     float near_p, float far_p) {
    __shared__ float s_coef[8][SEL_STAGE];
    __shared__ float s_rec[kIndex ? 1 : NREC_KC][SEL_STAGE];

    const int st = blockIdx.x;
    const int tid = threadIdx.x;
    const int start = meta[1 + st];
    const int end = meta[2 + st];
    const int n_gx = n_tx * N_SUB_X;
    const int gy = st / n_gx;
    const int gx = st - gy * n_gx;
    const float x0 = (float)(gx * SUB_W);
    const float y0 = (float)((gy + meta[0]) * SUB_H);
    Cam cam;
    if constexpr (!kIndex) cam = load_cam(cam_p);

    const float yl = (float)(tid / SUB_W) + 0.5f;
    const float xl = (float)(tid % SUB_W) + 0.5f;
    const float xx = xl * xl, xy = xl * yl, yy = yl * yl;
    const long long pix = (long long)st * P_SUB + tid;

    float t = 1.0f;
    int cnt = 0;
    bool done = false;

    for (int base = start; base < end; base += SEL_STAGE) {
        const int i = base + tid;
        if (i < end) {
            float p8[8], coef[8];
            if constexpr (kIndex) {
#pragma unroll
                for (int r = 0; r < 8; ++r)
                    p8[r] = src[(long long)r * b_pad + i];
            } else {
                float rec[NREC_KC];
#pragma unroll
                for (int r = 0; r < NREC_KC; ++r) {
                    rec[r] = src[(long long)r * b_pad + i];
                    s_rec[r][tid] = rec[r];
                }
                const Proj pr = project_parts(rec[0], rec[1], rec[2], rec[3],
                                              rec[4], cam);
                project8_rows(pr, near_p, far_p, p8);
            }
            coeff_mat(p8, x0, y0, coef);
#pragma unroll
            for (int r = 0; r < 8; ++r) s_coef[r][tid] = coef[r];
        }
        __syncthreads();
        const int n = min(SEL_STAGE, end - base);
        if (!done) {
            for (int j = 0; j < n; ++j) {
                const float opaok = s_coef[7][j];
                if (opaok == 0.0f) continue;
                const float alpha = sub_alpha(
                    s_coef[0][j], s_coef[1][j], s_coef[2][j], s_coef[3][j],
                    s_coef[4][j], s_coef[5][j], opaok, xl, yl, xx, xy, yy);
                if (alpha > 0.0f) {
                    if constexpr (kIndex) {
                        // a column below 2^24 (checked by the caller) is
                        // exact in f32
                        out[(long long)cnt * m_out + pix] = (float)(base + j);
                    } else {
#pragma unroll
                        for (int r = 0; r < NREC_KC; ++r)
                            out[((long long)r * k_cover + cnt) * m_out + pix] =
                                s_rec[r][j];
                    }
                    cnt += 1;
                    t = t * (1.0f - alpha);
                    if (cnt >= k_cover || !(t > T_EPS)) {
                        done = true;
                        break;
                    }
                }
            }
        }
        // also the barrier that protects the staged slots from the next round
        if (__syncthreads_count(done ? 0 : 1) == 0) break;
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
    gsl::kcover_select_kernel<false><<<n_seg, gsl::P_SUB, 0,
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
    gsl::kcover_select_kernel<true><<<n_seg, gsl::P_SUB, 0,
                                      (cudaStream_t)stream>>>(
        (const int*)meta, nullptr, (const float*)proj8, (float*)out,
        k_cover, m_pad, m_out, n_tx, 0.0f, 0.0f);
    return (int)cudaGetLastError();
}
