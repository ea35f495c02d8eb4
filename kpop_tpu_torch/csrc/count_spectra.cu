// Fused k-mer counting: window code, vocabulary lookup and spectrum in two
// launches, the spectrum written once.
//
// Replaces kpop_tpu/ops/pipeline.py::count_spectra together with
// vocab_lookup and kpop_tpu/ops/encode.py::window_codes_batch, which XLA
// compiled on the TPU as separate passes (window codes, LUT gather, then a
// scatter-add into a [B, V+1] buffer whose trash column is sliced off).
//
// What bounds it on the H100: writing the [B, V] f32 spectrum (188 MB at
// the headline B = 128, V = 367,987, 56 us at 3.35 TB/s; 518 MB at k = 16,
// V = 1,011,930, 155 us); the codes (3.9 MB) and the vocabulary table are
// small beside it, though each window's lookup is a random L2 sector or
// two.  A scatter of f32 atomics into a zeroed spectrum pays a pass to zero
// it and a read-modify-write of a sector per window on top.  The design
// writes every cell once, zeros included, with no memset of the spectrum
// and no global atomics on it:
// 1. count_lookup: each thread looks up RUN consecutive windows of a read
//    set (wide_lookup.cuh::window_rows: one rolling code, all RUN lookups
//    in flight together) and appends the vocabulary indices of the known
//    ones to the read set's row of an int32 scratch [B, Wp] (Wp = W
//    rounded up to RUN): a block gathers its indices in shared memory,
//    claims their place in the row by one atomic on the read set's count
//    n[b] and writes them out in whole lines.  The order of a row's
//    indices varies from run to run; the counts do not.  Only the known
//    windows are kept: 23 % of phase 3's random reads at k = 16, a third
//    at k = 10, 93 % of real reads at k = 10.
// 2. count_slices: the (vocabulary slice, read set) tasks, slice by slice,
//    split evenly over one wave of blocks (two to an SM), so no block
//    starts after the first wave.  For each task a block reads the read
//    set's n[b] indices (from L2, UNROLL chunks of loads in flight a
//    thread), counts those in its slice as integers in shared memory,
//    then converts the slice to f32 and writes it whole with 16-byte
//    streaming stores, zeroing each quad of counters as it reads it.  The
//    counters sit shifted by the slice's offset within its 16-byte line of
//    the output, so every quad of counters is one aligned 16-byte store.
//    A thread merges equal neighbours of its RUN indices before its one
//    shared-memory atomic, so a read set of one repeated k-mer puts about
//    n / RUN atomics on its cell.  Counters are u16, two to a word, while a
//    read set has at most 65,535 windows (no cell can carry into its
//    neighbour), else u32; a slice is SLICE_BYTES of counters (8 slices of
//    49,152 cells at the headline, 21 at k = 16).
// (One launch whose blocks took lookup and slice tasks from a queue, so
// that later read sets' LUT gathers overlapped earlier ones' stores,
// measured slower on the card than the two launches.)
//
// A row range (kpop-classify-torch's k-mer-sharded serving,
// parallel/serving.py): the lookup keeps only the known windows whose
// vocabulary index lies in [row0, row0 + rows), shifted by row0, and the
// slices count the rows cells of that range into a [B, rows] spectrum.
// Where the caller asks (known), the lookup also counts every known window
// of each read set into the tail of the scratch: the global normaliser of
// a shard's projection.  The default range, 0 and V, takes the lookup with
// neither the range test nor that count (RANGED false): there every known
// window is kept, so each read set's count of kept windows, n[b], is its
// normaliser, with or without known.
//
// Exactness: the counts are integers, summed in shared memory in any
// order, and each cell is converted to float32 once: exact below 2^24, one
// float32 rounding above (u32 counters, read sets of more than 65,535
// windows).  So the result equals the plain version bit for bit and is the
// same from run to run.  The normaliser stays an int32 count, exact for
// any read set the wrapper takes (ops/encode.py::READ_MAX_BASES).  Every
// batch offset (read set times its row of codes, indices or spectrum) is
// 64-bit; a read set's positions and windows are int32.
//
// Large k (kpop_count_spectra_wide): the rolling codes are uint64 (DNA 2
// bits a base, masked to 2k bits; the reverse complement shifted in at bit
// 2(k - 1)), the canonical code is the smaller full code, and the LUT read
// becomes the two-limb lookup of wide_lookup.cuh: the cuckoo hash's
// fingerprints and slots, or the sorted limbs.  The slices do not change.
// Measured on an H100 (tools/probe_count.py, phase 3's batch at k = 16,
// V = 1,011,930): the slices take 0.19 ms, within 7 % of a copy that only
// writes the spectrum (0.18 ms, 2.9 TB/s), so they are bound by the
// stores; the cuckoo lookup takes 0.076 ms, the sorted limbs' 0.32.
// Reading only the known windows' indices is what keeps the slices at the
// stores: every slice reads its read set's indices, 21 times at k = 16.
//
// The 2-bit wire (kpop_count_spectra_packed, kpop_count_spectra_wide_packed;
// kpop-classify's packed uploads, DNA only): the lookup reads each base
// from the packed and validity bytes (wide_lookup.cuh::PackedWire) where
// the int8 entry points read a code byte; nothing else changes, so the
// spectra are the int8 entry points' bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_lookup.cuh"

namespace {

constexpr int LOOKUP_THREADS = 256;
constexpr int RUN = 8;                  // windows a thread looks up, and indices it merges
constexpr int THREADS = 512;
constexpr int CHUNK = THREADS * RUN;    // indices a slice block reads at once
constexpr int UNROLL = 4;               // chunks of indices a thread loads at once
constexpr int SLICE_BYTES = 96 * 1024;  // counters of a slice
constexpr int PAD_BYTES = 16;           // the counters' shift within a 16-byte line
constexpr int NARROW_MAX = 65535;       // windows a read set for u16 counters
constexpr uint32_t MISS = 0xffffffffu;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RUN == 8, "two 16-byte loads a thread");

// Wire: kpop::CodeWire (int8 codes; valid null) or kpop::PackedWire (the
// 2-bit wire);
// Find: kpop::LutFind (an int code, a dense table) or kpop::WideFind (a
// uint64 code, the cuckoo hash or the sorted limbs; wide_lookup.cuh)
// (at most 64 registers, four blocks an SM: the lookups' latency wants
// the warps)
template <class Wire, class Find, bool RANGED>
__global__ void __launch_bounds__(LOOKUP_THREADS, 4)
count_lookup(const typename Wire::Byte* __restrict__ bases, const uint8_t* __restrict__ valid,
             int L, int k, int canonical, int base, const Find find, int V, int row0, int rows,
             int Wp, uint32_t* __restrict__ idx, int* __restrict__ n_idx,
             int* __restrict__ n_known) {
    __shared__ uint32_t known[LOOKUP_THREADS * RUN];
    __shared__ int warp_at[LOOKUP_THREADS / 32], warp_known[LOOKUP_THREADS / 32], block_at, block_n;
    const int b = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int w0 = (blockIdx.x * LOOKUP_THREADS + threadIdx.x) * RUN;
    int x[RUN];
    kpop::window_rows<RUN>(Wire::row(bases, valid, L, b), k, canonical, base, find, w0, L - k + 1,
                           x);
    // a known window in the row range [row0, row0 + rows) is kept, shifted
    // by row0; with n_known, every known window counts into the read set's
    bool keep[RUN];
    int c = 0, kn = 0;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
        keep[r] = x[r] < V && (!RANGED || (uint32_t)(x[r] - row0) < (uint32_t)rows);
        c += keep[r];
        kn += x[r] < V;
    }
    const bool count_known = RANGED && n_known;
    int incl = c;  // the warp's kept windows up to this lane
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    if (count_known) {
        kn = __reduce_add_sync(FULL, kn);
        if (lane == 0) warp_known[warp] = kn;
    }
    if (lane == 31) warp_at[warp] = incl;
    __syncthreads();
    // the block's kept windows: one place claimed in the row, one atomic;
    // its known windows, one more where they are counted
    if (threadIdx.x == 0) {
        int run = 0, all = 0;
        for (int i = 0; i < LOOKUP_THREADS / 32; ++i) {
            const int t = warp_at[i];
            warp_at[i] = run;
            run += t;
            if (count_known) all += warp_known[i];
        }
        block_n = run;
        block_at = run ? atomicAdd(n_idx + b, run) : 0;
        if (all) atomicAdd(n_known + b, all);
    }
    __syncthreads();
    int at = warp_at[warp] + incl - c;
#pragma unroll
    for (int r = 0; r < RUN; ++r)
        if (keep[r]) known[at++] = (uint32_t)(RANGED ? x[r] - row0 : x[r]);
    __syncthreads();
    // then out in order, a warp's stores one 128-byte line
    uint32_t* row = idx + (size_t)b * Wp + block_at;
    for (int i = threadIdx.x; i < block_n; i += LOOKUP_THREADS) row[i] = known[i];
}

template <bool WIDE>
__device__ __forceinline__ void add_run(uint32_t* cnt, uint32_t cell, uint32_t n_cells,
                                        uint32_t shift, uint32_t m) {
    if (cell < n_cells) {
        cell += shift;
        if (WIDE) atomicAdd(cnt + cell, m);
        else atomicAdd(cnt + (cell >> 1), m << (16 * (cell & 1)));
    }
}

// Stores of the spectrum, marked streaming (evict first): the spectrum
// written once would otherwise push the index scratch and the vocabulary
// table out of L2
__device__ __forceinline__ void put(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void put4(float* p, float4 v) { __stcs(reinterpret_cast<float4*>(p), v); }

// Each thread's RUN indices of one chunk, the first `valid` of them read:
// equal neighbours merged, one atomic a run
template <bool WIDE>
__device__ __forceinline__ void count_run(uint32_t* cnt, uint4 p, uint4 q, int valid,
                                          uint32_t lo, uint32_t n, uint32_t shift) {
    uint32_t v[RUN] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
    for (int r = 0; r < RUN; ++r)
        if (r >= valid) v[r] = MISS;
    uint32_t cur = v[0] - lo, m = 1;  // MISS and other slices: >= n
#pragma unroll
    for (int r = 1; r < RUN; ++r) {
        const uint32_t c = v[r] - lo;
        if (c == cur) {
            ++m;
        } else {
            add_run<WIDE>(cnt, cur, n, shift, m);
            cur = c;
            m = 1;
        }
    }
    add_run<WIDE>(cnt, cur, n, shift, m);
}

// the quad of counters at 4 q as f32, zeroing it
template <bool WIDE>
__device__ __forceinline__ float4 take_quad(uint32_t* cnt, int q) {
    if (WIDE) {
        uint4* c = reinterpret_cast<uint4*>(cnt) + q;
        const uint4 v = *c;
        *c = make_uint4(0u, 0u, 0u, 0u);
        return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
    }
    uint2* c = reinterpret_cast<uint2*>(cnt) + q;
    const uint2 v = *c;
    *c = make_uint2(0u, 0u);
    return make_float4((float)(v.x & 0xffffu), (float)(v.x >> 16), (float)(v.y & 0xffffu),
                       (float)(v.y >> 16));
}

// One slice [lo, lo + n) of one read set's spectrum from its n_row indices
// into o; the counters are zero on entry and left zero.  Cell c sits at
// counter c + shift, where shift is o's place within its 16-byte line, so
// counter quad q is the aligned output quad at o - shift + 4 q.
template <bool WIDE>
__device__ void count_slice(const uint32_t* __restrict__ idx_row, int n_row, int lo, int n,
                            uint32_t* cnt, float* __restrict__ o) {
    const uint4* row = reinterpret_cast<const uint4*>(idx_row);
    const uint4 miss = make_uint4(MISS, MISS, MISS, MISS);
    const int shift = (int)(((uintptr_t)o >> 2) & 3);
    // UNROLL chunks' loads in flight before their atomics
    for (int w0 = threadIdx.x * RUN; w0 < n_row; w0 += UNROLL * CHUNK) {
        uint4 p[UNROLL], q[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * CHUNK;
            p[u] = w < n_row ? row[w / 4] : miss;
            q[u] = w + 4 < n_row ? row[w / 4 + 1] : miss;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            count_run<WIDE>(cnt, p[u], q[u], n_row - (w0 + u * CHUNK), lo, n, shift);
    }
    __syncthreads();
    // every cell once: whole aligned quads by 16-byte stores, the partial
    // quads at the two ends cell by cell
    float* line = o - shift;
    const int quads = (n + shift + 3) / 4;
    for (int t = threadIdx.x; t < quads; t += THREADS) {
        const float4 v = take_quad<WIDE>(cnt, t);
        if (4 * t >= shift && 4 * t + 4 <= n + shift) {
            put4(line + 4 * t, v);
        } else {
            const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (4 * t + i >= shift && 4 * t + i < n + shift) put(line + 4 * t + i, c[i]);
        }
    }
    __syncthreads();
}

// Block g takes the tasks [g T / G, (g + 1) T / G) of the T = slices x B
// (slice, read set) tasks, slice-major
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
count_slices(const uint32_t* __restrict__ idx, const int* __restrict__ n_idx, int B, int Wp,
             int rows, int slices, float* __restrict__ out) {
    extern __shared__ __align__(16) uint32_t cnt[];
    constexpr int CELLS = WIDE ? SLICE_BYTES / 4 : SLICE_BYTES / 2;
    for (int i = threadIdx.x; i < (SLICE_BYTES + PAD_BYTES) / 16; i += THREADS)
        reinterpret_cast<uint4*>(cnt)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    const long long tasks = (long long)slices * B;
    const long long t1 = tasks * (blockIdx.x + 1) / gridDim.x;
    for (long long t = tasks * blockIdx.x / gridDim.x; t < t1; ++t) {
        const int s = (int)(t / B), b = (int)(t % B);
        const int lo = s * CELLS;
        count_slice<WIDE>(idx + (size_t)b * Wp, n_idx[b], lo, min(CELLS, rows - lo), cnt,
                          out + (size_t)b * rows + lo);
    }
}

// Both launches for any lookup, into the [B, rows] spectra of the
// vocabulary rows [row0, row0 + rows); idx: int32 scratch of B * Wp + 2 B
// entries (the kept indices, then each read set's count of them, then,
// with known on a range other than the default, its count of all known
// windows), Wp = L - k + 1 rounded up to RUN
template <class Wire, class Find>
int count_spectra(const typename Wire::Byte* bases, const uint8_t* valid, int B, int L, int k,
                  int canonical, int base, const Find& find, int V, int row0, int rows, int known,
                  uint32_t* idx, float* out, void* stream) {
    const int W = L - k + 1;
    if (row0 < 0 || rows < 0) return (int)cudaErrorInvalidValue;
    if (B <= 0 || V <= 0 || rows == 0) return (int)cudaGetLastError();
    const int Wp = W > 0 ? (W + RUN - 1) / RUN * RUN : 0;
    int* n_idx = reinterpret_cast<int*>(idx + (size_t)B * Wp);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(n_idx, 0, (size_t)2 * B * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    if (Wp > 0) {
        const dim3 grid((Wp / RUN + LOOKUP_THREADS - 1) / LOOKUP_THREADS, B);
        if (row0 != 0 || rows != V)
            count_lookup<Wire, Find, true><<<grid, LOOKUP_THREADS, 0, st>>>(
                bases, valid, L, k, canonical, base, find, V, row0, rows, Wp, idx, n_idx,
                known ? n_idx + B : nullptr);
        else
            count_lookup<Wire, Find, false><<<grid, LOOKUP_THREADS, 0, st>>>(
                bases, valid, L, k, canonical, base, find, V, row0, rows, Wp, idx, n_idx, nullptr);
    }
    const bool wide = W > NARROW_MAX;
    const int cells = wide ? SLICE_BYTES / 4 : SLICE_BYTES / 2;
    const int slices = (rows + cells - 1) / cells;
    auto kernel = wide ? count_slices<true> : count_slices<false>;
    const int smem = SLICE_BYTES + PAD_BYTES;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // one wave: every SM's resident blocks
    int dev = 0, sms = 132, per_sm = 1;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    const long long tasks = (long long)slices * B;
    const int blocks = (int)(tasks < (long long)max(1, per_sm) * sms ? tasks : (long long)max(1, per_sm) * sms);
    kernel<<<blocks, THREADS, smem, st>>>(idx, n_idx, B, Wp, rows, slices, out);
    return (int)cudaGetLastError();
}

}  // namespace

// k up to lut_k_max: codes [B, L] int8; lut is the dense [base^k + 1]
// table; the spectra of the vocabulary rows [row0, row0 + rows) (0 and V:
// all of it), and with known (nonzero) on another range each read set's
// count of all its known windows (on the default range, the kept count)
extern "C" int kpop_count_spectra(const int8_t* codes, int B, int L, int k, int canonical,
                                  int base, const int32_t* lut, int V, int row0, int rows,
                                  int known, uint32_t* idx, float* out, void* stream) {
    return count_spectra<kpop::CodeWire>(codes, nullptr, B, L, k, canonical, base,
                                         kpop::LutFind{lut, V}, V, row0, rows, known, idx, out,
                                         stream);
}

// larger k: the cuckoo hash's probe layout (ops/cuckoo.py::probe_table) of
// `slots` slots a table with its seeds, or (probe null) the sorted limbs
// [V] {hi, lo} (wide_lookup.cuh)
extern "C" int kpop_count_spectra_wide(const int8_t* codes, int B, int L, int k, int canonical,
                                       int base, int k_lo, const int32_t* probe, int slots,
                                       uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2,
                                       const int32_t* limbs, int V, int row0, int rows,
                                       int known, uint32_t* idx, float* out, void* stream) {
    if (!kpop::wide_args_ok(k, probe, slots, limbs)) return (int)cudaErrorInvalidValue;
    return count_spectra<kpop::CodeWire>(
        codes, nullptr, B, L, k, canonical, base,
        kpop::wide_find(base, k_lo, probe, slots, a1, b1, a2, b2, limbs, V), V, row0, rows, known,
        idx, out, stream);
}

// The same two on the 2-bit wire (DNA, base 4): packed [B, (L + 3) / 4]
// and valid [B, (L + 7) / 8] bytes in place of the codes
extern "C" int kpop_count_spectra_packed(const uint8_t* packed, const uint8_t* valid, int B,
                                         int L, int k, int canonical, int base,
                                         const int32_t* lut, int V, int row0, int rows,
                                         int known, uint32_t* idx, float* out, void* stream) {
    if (base != 4) return (int)cudaErrorInvalidValue;
    return count_spectra<kpop::PackedWire>(packed, valid, B, L, k, canonical, base,
                                           kpop::LutFind{lut, V}, V, row0, rows, known, idx, out,
                                           stream);
}

extern "C" int kpop_count_spectra_wide_packed(const uint8_t* packed, const uint8_t* valid, int B,
                                              int L, int k, int canonical, int base, int k_lo,
                                              const int32_t* probe, int slots, uint32_t a1,
                                              uint32_t b1, uint32_t a2, uint32_t b2,
                                              const int32_t* limbs, int V, int row0, int rows,
                                              int known, uint32_t* idx, float* out,
                                              void* stream) {
    if (base != 4 || !kpop::wide_args_ok(k, probe, slots, limbs)) return (int)cudaErrorInvalidValue;
    return count_spectra<kpop::PackedWire>(
        packed, valid, B, L, k, canonical, base,
        kpop::wide_find(base, k_lo, probe, slots, a1, b1, a2, b2, limbs, V), V, row0, rows, known,
        idx, out, stream);
}
