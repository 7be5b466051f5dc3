// The fixed-order reduction of 12 pose partials of kcover_step_bwd (whose
// second pass fused_bwd shares; subtile_chain reduces on its own): each
// thread's 12 partials are summed warp shuffle -> shared memory -> one
// 12-vector per block in a (n_blocks, 12) scratch, and a second kernel adds
// the block rows in a fixed order in double. No float atomics, so a result
// repeats bit for bit from run to run.
#pragma once

#include <cuda_runtime.h>

namespace gsl {

constexpr int REDUCE_THREADS = 256;  // block size of both callers

// Block-wide sum of part[12] into scratch[blockIdx.x * 12 + j]. Every
// thread of the block (blockDim.x == REDUCE_THREADS) must call it.
__device__ __forceinline__ void block_sum12(const float part[12],
                                            float* __restrict__ scratch) {
    __shared__ float warp_part[REDUCE_THREADS / 32][12];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        float v = part[j];
#pragma unroll
        for (int ofs = 16; ofs > 0; ofs >>= 1)
            v = v + __shfl_down_sync(0xffffffffu, v, ofs);
        if (lane == 0) warp_part[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < 12) {
        float v = 0.0f;
        for (int w = 0; w < REDUCE_THREADS / 32; ++w)
            v = v + warp_part[w][threadIdx.x];
        scratch[(long long)blockIdx.x * 12 + threadIdx.x] = v;
    }
}

// Second pass: out[j] = sum over the n_blocks rows of scratch[:, j], in a
// fixed order, in double (defined in kcover_step.cu).
int launch_sum12(const float* scratch, float* out, int n_blocks,
                 cudaStream_t stream);

}  // namespace gsl
