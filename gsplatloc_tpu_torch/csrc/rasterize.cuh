// Shared layout and per-pixel alpha of the general rasterizer's two kernels
// (rasterize_fwd.cu, rasterize_bwd.cu): 16x128 pixel tiles, one block per
// tile, 256 threads of 8 pixels each (thread tid holds column tid % 128 of
// rows 8*(tid / 128) .. +7), and the (16, M_pad) field-major record buffer
// staged 128 slots at a time.
//
// The alpha follows the plain PyTorch version (ops/rasterize_tiles.py
// _chunk_alpha) term by term; the library is built with -fmad=false, so a
// kernel and its plain version land on the same side of every gate.
#pragma once

#include "project.cuh"

namespace gsl {

constexpr int TILE_H = 16;
constexpr int TILE_W = 128;
constexpr int RAST_THREADS = 256;
constexpr int PX_PER_THREAD = TILE_H * TILE_W / RAST_THREADS;  // 8
constexpr int N_FIELDS = 10;  // record fields read / gradient rows written

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

// Stage fields 0-9 of the 128 slots from column col0 into shared memory
// (columns at or past m_pad read as 0). Every thread of the block calls it.
__device__ __forceinline__ void stage_records(const float* __restrict__ rec,
                                              long long col0, long long m_pad,
                                              float (*s_rec)[CHUNK]) {
    for (int i = threadIdx.x; i < N_FIELDS * CHUNK; i += RAST_THREADS) {
        const int f = i / CHUNK;
        const int j = i - f * CHUNK;
        const long long col = col0 + j;
        s_rec[f][j] = (col < m_pad) ? rec[(long long)f * m_pad + col] : 0.0f;
    }
}

}  // namespace gsl
