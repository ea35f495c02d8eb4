// Embedding bag: reads straight to twisted coordinates, without spectra.
//
//     twisted[b, c] = sum_w twister[lut[code_w], c] / n_known[b]
//
// over the valid windows w of read set b whose k-mer is in the vocabulary
// (n_known == 0 is replaced by 1).  Replaces
// kpop_tpu/ops/pipeline.py::project_reads, which XLA compiled on the TPU as
// a lax.scan of [B, chunk, d] gathers; kpop-classify --project-path bag
// (or auto, at large vocabularies) takes this route.
//
// What bounds it on the H100: it reads one twister row of 4*d bytes for
// every known window, B*W*d*4 bytes in all (7.9 GB for the headline batch
// of 128 read sets of 30k windows at d=511), from a twister of V*d*4 bytes
// (0.75 GB at V=368k) that does not fit the 50 MB L2.  So it is bound by
// HBM bandwidth on gathered rows, 2.4 ms per batch at 3.35 TB/s; the dense
// route (count, then a [B, V] x [V, d] product) moves far fewer bytes at
// that shape and is the one kpop-classify picks there.
//
// The design: block (b, y) owns read set b and columns [128 y, 128 y + 128)
// of d.  It turns a chunk of windows into vocabulary indices in shared
// memory (each thread computes window codes and looks them up), then every
// thread walks that chunk and accumulates its own column in f32 registers,
// so a warp reads 128 contiguous bytes of each gathered row.  There are no
// atomics: each output has one owner and sums in a fixed order, so the
// result is deterministic from run to run.  Each block counts the known
// windows of its chunks itself and divides at the end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // columns per block
constexpr int CHUNK = 1024;   // windows per shared-memory chunk

__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const int8_t* __restrict__ codes, int L, int k,
                     int canonical, int base, const int32_t* __restrict__ lut,
                     int V, const float* __restrict__ twister, int d,
                     int normalize, float* __restrict__ out) {
    __shared__ int idx[CHUNK];
    __shared__ int n_chunk;
    __shared__ int n_known;

    const int row = blockIdx.x;
    const int col = blockIdx.y * THREADS + threadIdx.x;
    const int W = L - k + 1;
    const int8_t* seq = codes + (size_t)row * L;
    if (threadIdx.x == 0) n_known = 0;

    float acc = 0.0f;
    for (int w0 = 0; w0 < W; w0 += CHUNK) {
        if (threadIdx.x == 0) n_chunk = 0;
        __syncthreads();
        // 1. window codes -> vocabulary indices (V for a miss or a break)
        const int n = min(CHUNK, W - w0);
        for (int t = threadIdx.x; t < n; t += THREADS) {
            const int8_t* s = seq + w0 + t;
            int fwd = 0, rc = 0, mult = 1;
            bool ok = true;
            for (int j = 0; j < k; ++j) {
                const int c = s[j];
                ok &= c >= 0 && c < base;  // no input indexes past the LUT
                fwd = fwd * base + c;
                rc += (3 - c) * mult;
                mult *= base;
            }
            int v = V;
            if (ok) v = lut[canonical ? min(fwd, rc) : fwd];
            idx[t] = v;
        }
        __syncthreads();
        // 2. each thread sums its column over the chunk's known windows;
        //    the branch is uniform across the block
        if (col < d) {
            float s0 = 0.0f, s1 = 0.0f;
            int t = 0;
            for (; t + 1 < n; t += 2) {
                const int v0 = idx[t], v1 = idx[t + 1];
                if (v0 < V) s0 += twister[(size_t)v0 * d + col];
                if (v1 < V) s1 += twister[(size_t)v1 * d + col];
            }
            if (t < n && idx[t] < V) s0 += twister[(size_t)idx[t] * d + col];
            acc += s0 + s1;
        }
        int mine = 0;
        for (int t = threadIdx.x; t < n; t += THREADS) mine += idx[t] < V;
        if (mine) atomicAdd(&n_chunk, mine);
        __syncthreads();
        if (threadIdx.x == 0) n_known += n_chunk;
    }
    __syncthreads();
    if (col < d) {
        const float denom = (normalize && n_known > 0) ? (float)n_known : 1.0f;
        out[(size_t)row * d + col] = acc / denom;
    }
}

}  // namespace

extern "C" int kpop_embedding_bag(const int8_t* codes, int B, int L, int k,
                                  int canonical, int base, const int32_t* lut,
                                  int V, const float* twister, int d,
                                  int normalize, float* out, void* stream) {
    if (B > 0 && d > 0) {
        const dim3 grid(B, (d + THREADS - 1) / THREADS);
        embedding_bag_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            codes, L, k, canonical, base, lut, V, twister, d, normalize, out);
    }
    return (int)cudaGetLastError();
}
