// Metric-weighted euclidean distance tile:
//
//     d[q, t] = sqrt(max(0, sum_j m_j (a[q,j]/na_q - b[t,j]/nb_t)^2))
//
// Replaces kpop_tpu/ops/pallas_pairwise.py::_dist_kernel (the repository's
// one Pallas kernel, launched by pairwise_distances_pallas).  On the
// serving path it computes distances_to_classes: [B, d] twisted reads
// against [C, d] classes, 128 x 512 x 511 at the headline shape.
//
// What bounds it on the H100: at that shape the work is 2*B*C*d = 67 MFLOP
// over 2.3 MB of operands, so neither the 67 TFLOP/s of the f32 cores nor
// the 3.35 TB/s of HBM is the limit: the grid is, at 16 blocks of 64x64
// outputs for 132 SMs.  For the all-pairs relatedness shape (4096 x 4096 x
// 512, 17 GFLOP over 16 MB) it is f32 FMA throughput outside the tensor
// cores.  The design keeps the f32 arithmetic of the TPU kernel: each
// operand element is loaded once per tile into shared memory, scaled by
// 1/na or 1/nb on the way, and each thread keeps a 4x4 block of cross
// terms plus its rows' and columns' weighted norms in registers, so one
// shared-memory read feeds four FMAs.  The feature loop inside the block
// takes the place of the TPU's sequential grid dimension 2 (Hopper blocks
// run in no order, so nothing can carry over between them), and the
// sqrt(max(., 0)) runs once in the epilogue.  Ragged edges are masked: out
// of range rows load as 0 and out of range features carry weight 0, so no
// operand is padded or copied.  Tensor cores (mma.sync / wgmma, TF32 or
// split-f32), TMA and a fused digest epilogue are later work.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;     // output rows and columns per block
constexpr int THREADS = 16;  // threads per block edge (16 x 16 = 256)
constexpr int PER = TILE / THREADS;  // outputs per thread edge (4)
constexpr int TD = 32;       // features per shared-memory chunk

__global__ void __launch_bounds__(THREADS * THREADS)
pairwise_dist_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ m, const float* __restrict__ na,
                     const float* __restrict__ nb, float* __restrict__ out,
                     int Q, int T, int D) {
    // [feature][row]: thread (tx, ty) reads rows ty + 16 i and columns
    // tx + 16 j, so a warp reads 2 distinct a values (broadcast) and 16
    // consecutive b values (no bank conflict)
    __shared__ float as[TD][TILE + 1];
    __shared__ float bs[TD][TILE + 1];
    __shared__ float ms[TD];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * THREADS + tx;
    const int q0 = blockIdx.y * TILE, t0 = blockIdx.x * TILE;

    // loader mapping: 256 threads cover 8 rows x 32 features per step
    const int lf = tid % TD, lr = tid / TD;
    constexpr int LROWS = THREADS * THREADS / TD;

    float inv_a[TILE / LROWS], inv_b[TILE / LROWS];
#pragma unroll
    for (int s = 0; s < TILE / LROWS; ++s) {
        const int q = q0 + lr + s * LROWS, t = t0 + lr + s * LROWS;
        inv_a[s] = q < Q ? 1.0f / na[q] : 0.0f;
        inv_b[s] = t < T ? 1.0f / nb[t] : 0.0f;
    }

    float cross[PER][PER] = {};
    float na2[PER] = {}, nb2[PER] = {};

    for (int f0 = 0; f0 < D; f0 += TD) {
        const int f = f0 + lf;
#pragma unroll
        for (int s = 0; s < TILE / LROWS; ++s) {
            const int r = lr + s * LROWS;
            const int q = q0 + r, t = t0 + r;
            as[lf][r] = (q < Q && f < D) ? a[(size_t)q * D + f] * inv_a[s] : 0.0f;
            bs[lf][r] = (t < T && f < D) ? b[(size_t)t * D + f] * inv_b[s] : 0.0f;
        }
        if (tid < TD) ms[tid] = (f0 + tid < D) ? m[f0 + tid] : 0.0f;
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < TD; ++j) {
            const float mj = ms[j];
            float am[PER], bv[PER];
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const float av = as[j][ty + THREADS * i];
                am[i] = av * mj;
                na2[i] = fmaf(am[i], av, na2[i]);
                bv[i] = bs[j][tx + THREADS * i];
                nb2[i] = fmaf(bv[i] * mj, bv[i], nb2[i]);
            }
#pragma unroll
            for (int i = 0; i < PER; ++i)
#pragma unroll
                for (int c = 0; c < PER; ++c)
                    cross[i][c] = fmaf(am[i], bv[c], cross[i][c]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int q = q0 + ty + THREADS * i;
        if (q >= Q) continue;
#pragma unroll
        for (int c = 0; c < PER; ++c) {
            const int t = t0 + tx + THREADS * c;
            if (t >= T) continue;
            const float d2 = na2[i] + nb2[c] - 2.0f * cross[i][c];
            out[(size_t)q * T + t] = sqrtf(fmaxf(d2, 0.0f));
        }
    }
}

}  // namespace

extern "C" int kpop_pairwise_dist(const float* a, const float* b,
                                  const float* m, const float* na,
                                  const float* nb, float* out, int Q, int T,
                                  int D, void* stream) {
    if (Q > 0 && T > 0) {
        const dim3 grid((T + TILE - 1) / TILE, (Q + TILE - 1) / TILE);
        const dim3 block(THREADS, THREADS);
        pairwise_dist_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            a, b, m, na, nb, out, Q, T, D);
    }
    return (int)cudaGetLastError();
}
