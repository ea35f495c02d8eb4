// Fused k-mer counting: window code, vocabulary lookup and spectrum in two
// launches, the spectrum written once.
//
// Replaces kpop_tpu/ops/pipeline.py::count_spectra together with
// vocab_lookup and kpop_tpu/ops/encode.py::window_codes_batch, which XLA
// compiled on the TPU as separate passes (window codes, LUT gather, then a
// scatter-add into a [B, V+1] buffer whose trash column is sliced off).
//
// What bounds it on the H100: writing the [B, V] f32 spectrum (188 MB at
// the headline B = 128, V = 367,987), 56 us at 3.35 TB/s; the codes
// (3.9 MB) and the LUT entries the windows hit (a 4 MB table at k = 10,
// inside the 50 MB L2) are small beside it, though the LUT gathers are one
// random 32-byte L2 sector a window.  A scatter of f32 atomics into a
// zeroed spectrum pays a pass to zero it and a read-modify-write of a
// sector per window on top.  The design writes every cell once, zeros
// included, with no memset of the spectrum and no global atomics on it:
// 1. count_lookup: each thread walks RUN consecutive windows of a read
//    set with a rolling forward (and, for canonical DNA, reverse-
//    complement) code, skips windows that touch a -1 break or a code
//    outside [0, base), looks each code up in the LUT once and writes the
//    vocabulary index, or MISS, to an int32 scratch [B, Wp] (Wp = W
//    rounded up to RUN; the padding is MISS), two 16-byte stores a thread;
// 2. count_slices: a block owns one slice of the vocabulary and walks
//    read sets, as many walkers a slice as fill every SM once.  For each
//    read set it reads the indices (from L2: 15 MB for the batch, UNROLL
//    chunks of loads in flight a thread), counts those in its slice as
//    integers in shared memory, converts the slice to f32, writes it whole
//    with 16-byte streaming stores and zeroes its counters, so one read
//    set's stores drain while the next one's indices load.  A thread
//    merges equal neighbours of its RUN indices before its one shared-
//    memory atomic, so a read set of one repeated k-mer puts W / RUN
//    atomics on its cell, not W.  Counters are u16, two to a word, while a
//    read set has at most 65,535 windows (no cell can carry into its
//    neighbour), else u32; a slice is SLICE_BYTES of counters (8 slices of
//    49,152 cells at the headline), two blocks to an SM.
// (One launch whose blocks took lookup and slice tasks from a queue, so
// that later read sets' LUT gathers overlapped earlier ones' stores,
// measured slower on the card than the two launches.)
//
// Exactness: the counts are integers, summed in shared memory in any
// order, and converted once; a float32 holds every integer below 2^24
// exactly (the wrapper raises for W >= 2^24), so the result equals the
// plain version bit for bit and is the same from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LOOKUP_THREADS = 256;
constexpr int RUN = 8;                  // windows a thread looks up, and indices it merges
constexpr int THREADS = 512;
constexpr int CHUNK = THREADS * RUN;    // indices a slice block reads at once
constexpr int UNROLL = 4;               // chunks of indices a thread loads at once
constexpr int SLICE_BYTES = 96 * 1024;  // counters of a slice
constexpr int NARROW_MAX = 65535;       // windows a read set for u16 counters
constexpr uint32_t MISS = 0xffffffffu;
static_assert(RUN == 8, "two 16-byte loads and stores a thread");

__global__ void __launch_bounds__(LOOKUP_THREADS)
count_lookup(const int8_t* __restrict__ codes, int L, int k, int canonical, int base,
             const int32_t* __restrict__ lut, int V, int Wp, uint32_t* __restrict__ idx) {
    const int b = blockIdx.y;
    const int w0 = (blockIdx.x * LOOKUP_THREADS + threadIdx.x) * RUN;
    if (w0 >= Wp) return;
    const int8_t* s = codes + (size_t)b * L;
    const int W = L - k + 1;
    int top = 1;  // base^(k-1)
    for (int j = 1; j < k; ++j) top *= base;
    // fwd = sum_j c[w+j] base^(k-1-j); rc = sum_j (3 - c[w+j]) 4^j (DNA);
    // last_bad = the last position that is not a base
    int fwd = 0, rc = 0, last_bad = w0 - 1;
    auto push = [&](int j) {
        int c = j < L ? s[j] : -1;
        if (c < 0 || c >= base) {
            last_bad = j;
            c = 0;
        }
        fwd = (base == 4 ? (fwd & (top - 1)) : fwd % top) * base + c;
        rc = (rc >> 2) + (3 - c) * top;
    };
    for (int j = w0; j < w0 + k - 1; ++j) push(j);
    uint32_t out[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
        const int w = w0 + r;
        push(w + k - 1);
        uint32_t v = MISS;
        if (w < W && last_bad < w) {
            const int x = lut[canonical ? min(fwd, rc) : fwd];
            if ((unsigned)x < (unsigned)V) v = (uint32_t)x;
        }
        out[r] = v;
    }
    uint4* dst = reinterpret_cast<uint4*>(idx + (size_t)b * Wp + w0);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

template <bool WIDE>
__device__ __forceinline__ void add_run(uint32_t* cnt, uint32_t cell, uint32_t n_cells,
                                        uint32_t m) {
    if (cell < n_cells) {
        if (WIDE) atomicAdd(cnt + cell, m);
        else atomicAdd(cnt + (cell >> 1), m << (16 * (cell & 1)));
    }
}

// Stores of the spectrum, marked streaming (evict first): 188 MB written
// once would otherwise push the index scratch and the LUT out of L2
__device__ __forceinline__ void put(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void put4(float* p, float4 v) { __stcs(reinterpret_cast<float4*>(p), v); }

template <bool WIDE>
__device__ __forceinline__ float cell_value(const uint32_t* cnt, int i) {
    return WIDE ? (float)cnt[i] : (float)reinterpret_cast<const uint16_t*>(cnt)[i];
}

// Each thread's RUN indices of one chunk: equal neighbours merged, one
// atomic a run
template <bool WIDE>
__device__ __forceinline__ void count_run(uint32_t* cnt, uint4 p, uint4 q, uint32_t lo,
                                          uint32_t n) {
    const uint32_t v[RUN] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
    uint32_t cur = v[0] - lo, m = 1;  // MISS and other slices: >= n
#pragma unroll
    for (int r = 1; r < RUN; ++r) {
        const uint32_t c = v[r] - lo;
        if (c == cur) {
            ++m;
        } else {
            add_run<WIDE>(cnt, cur, n, m);
            cur = c;
            m = 1;
        }
    }
    add_run<WIDE>(cnt, cur, n, m);
}

// One slice of one read set's spectrum from its indices; the counters are
// zero on entry and left zero
template <bool WIDE>
__device__ void count_slice(const uint32_t* __restrict__ idx_row, int Wp, int lo, int n,
                            uint32_t* cnt, float* __restrict__ o) {
    const uint4* row = reinterpret_cast<const uint4*>(idx_row);
    const uint4 miss = make_uint4(MISS, MISS, MISS, MISS);
    // UNROLL chunks' loads in flight before their atomics
    for (int w0 = threadIdx.x * RUN; w0 < Wp; w0 += UNROLL * CHUNK) {
        uint4 p[UNROLL], q[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * CHUNK;
            p[u] = w < Wp ? row[w / 4] : miss;
            q[u] = w < Wp ? row[w / 4 + 1] : miss;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) count_run<WIDE>(cnt, p[u], q[u], lo, n);
    }
    __syncthreads();
    // the slice as f32, every cell once: scalar stores up to the first
    // 16-byte boundary, 16-byte stores, then the tail
    const int head = min(n, (int)((16 - ((uintptr_t)o & 15)) & 15) / 4);
    const int quads = (n - head) / 4;
    if (threadIdx.x < head) put(o + threadIdx.x, cell_value<WIDE>(cnt, threadIdx.x));
    for (int t = threadIdx.x; t < quads; t += THREADS) {
        const int i = head + 4 * t;
        put4(o + i, make_float4(cell_value<WIDE>(cnt, i), cell_value<WIDE>(cnt, i + 1),
                                cell_value<WIDE>(cnt, i + 2), cell_value<WIDE>(cnt, i + 3)));
    }
    const int i = head + 4 * quads + threadIdx.x;
    if (i < n) put(o + i, cell_value<WIDE>(cnt, i));
    __syncthreads();
    for (int j = threadIdx.x; j < SLICE_BYTES / 16; j += THREADS)
        reinterpret_cast<uint4*>(cnt)[j] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
}

// Block (s, y) owns vocabulary slice s and walks read sets y, y +
// gridDim.y, ...
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
count_slices(const uint32_t* __restrict__ idx, int B, int Wp, int V, float* __restrict__ out) {
    extern __shared__ __align__(16) uint32_t cnt[];
    constexpr int CELLS = WIDE ? SLICE_BYTES / 4 : SLICE_BYTES / 2;
    const int lo = blockIdx.x * CELLS;
    for (int i = threadIdx.x; i < SLICE_BYTES / 16; i += THREADS)
        reinterpret_cast<uint4*>(cnt)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int b = blockIdx.y; b < B; b += gridDim.y)
        count_slice<WIDE>(idx + (size_t)b * Wp, Wp, lo, min(CELLS, V - lo), cnt,
                          out + (size_t)b * V + lo);
}

}  // namespace

// idx: int32 scratch of B * Wp entries, Wp = L - k + 1 rounded up to RUN
extern "C" int kpop_count_spectra(const int8_t* codes, int B, int L, int k, int canonical,
                                  int base, const int32_t* lut, int V, uint32_t* idx,
                                  float* out, void* stream) {
    const int W = L - k + 1;
    if (B <= 0 || V <= 0) return (int)cudaGetLastError();
    const int Wp = W > 0 ? (W + RUN - 1) / RUN * RUN : 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (Wp > 0) {
        const dim3 grid((Wp / RUN + LOOKUP_THREADS - 1) / LOOKUP_THREADS, B);
        count_lookup<<<grid, LOOKUP_THREADS, 0, st>>>(codes, L, k, canonical, base, lut, V, Wp,
                                                      idx);
    }
    const bool wide = W > NARROW_MAX;
    const int cells = wide ? SLICE_BYTES / 4 : SLICE_BYTES / 2;
    const int slices = (V + cells - 1) / cells;
    auto kernel = wide ? count_slices<true> : count_slices<false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SLICE_BYTES);
    // enough read-set walkers to fill every SM once with its resident blocks
    int dev = 0, sms = 132, per_sm = 1;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                            SLICE_BYTES);
    if (err != cudaSuccess) return (int)err;
    const int walkers = min(B, max(1, (per_sm * sms + slices - 1) / slices));
    kernel<<<dim3(slices, walkers), THREADS, SLICE_BYTES, st>>>(idx, B, Wp, V, out);
    return (int)cudaGetLastError();
}
