// Fused k-mer counting: window code, vocabulary lookup and spectrum
// scatter in one kernel.
//
// Replaces kpop_tpu/ops/pipeline.py::count_spectra together with
// vocab_lookup and kpop_tpu/ops/encode.py::window_codes_batch, which XLA
// compiled on the TPU as separate passes (window codes, LUT gather, then a
// scatter-add into a [B, V+1] buffer whose trash column is sliced off).
//
// What bounds it on the H100: per window it reads k int8 bases (served from
// L1, since neighbouring windows share k-1 of them) and one int32 LUT entry
// from a table of base^k+1 entries (4 MB at k=10, inside the 50 MB L2), and
// issues one f32 atomic add to a [B, V] spectrum (188 MB at the headline
// B=128, V=368k).  The atomics are scattered over V columns, so they rarely
// collide; the bound is the memory system's rate of scattered 4-byte
// read-modify-writes in L2, not arithmetic.  The design does each window
// in one thread: it computes the forward code (and for canonical DNA the
// reverse-complement code) from its k bases, takes min(fwd, rc), skips
// windows that touch a -1 break (or a code outside [0, base), so that no
// input can index past the LUT), looks the code up in the LUT and adds 1.0
// to out[b*V + idx].  Misses and invalid windows are skipped, so there is
// no trash column and no slice copy.  A rolling code shared across a warp
// is a later optimisation.
//
// Exactness: every update adds 1.0f, and a float32 holds every integer up
// to 2^24 exactly, so as long as no cell exceeds 2^24 counts (a read set
// would need 16.7M windows of one k-mer) the result does not depend on the
// order of the atomics and equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
count_spectra_kernel(const int8_t* __restrict__ codes, int L, int k,
                     int canonical, int base, const int32_t* __restrict__ lut,
                     int V, float* __restrict__ out) {
    const int W = L - k + 1;
    const int w = blockIdx.x * THREADS + threadIdx.x;
    const int row = blockIdx.y;
    if (w >= W) return;
    const int8_t* s = codes + (size_t)row * L + w;
    int fwd = 0, rc = 0, mult = 1;
    for (int j = 0; j < k; ++j) {
        const int c = s[j];
        if (c < 0 || c >= base) return;  // a break (-1), or not a base
        fwd = fwd * base + c;
        rc += (3 - c) * mult;
        mult *= base;
    }
    const int code = canonical ? min(fwd, rc) : fwd;
    const int idx = lut[code];
    if (idx < V) atomicAdd(out + (size_t)row * V + idx, 1.0f);
}

}  // namespace

extern "C" int kpop_count_spectra(const int8_t* codes, int B, int L, int k,
                                  int canonical, int base, const int32_t* lut,
                                  int V, float* out, void* stream) {
    const int W = L - k + 1;
    if (B > 0 && W > 0) {
        const dim3 grid((W + THREADS - 1) / THREADS, B);
        count_spectra_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            codes, L, k, canonical, base, lut, V, out);
    }
    return (int)cudaGetLastError();
}
