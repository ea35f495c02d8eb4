// Fused k-mer counting: window code, vocabulary lookup and spectrum, the
// spectrum written once.
//
// Replaces kpop_tpu/ops/pipeline.py::count_spectra together with
// vocab_lookup and kpop_tpu/ops/encode.py::window_codes_batch, which XLA
// compiled on the TPU as separate passes (window codes, LUT gather, then a
// scatter-add into a [B, V+1] buffer whose trash column is sliced off).
//
// What bounds it on the H100: writing the [B, V] f32 spectrum (188 MB at
// the headline B = 128, V = 367,987, 56 us at 3.35 TB/s; 518 MB at k = 16,
// V = 1,011,930, 155 us) and, on long read sets, moving their known
// windows' indices (340 MB a read set of 88.8M windows at k = 12); the
// codes and the vocabulary table are read once, though each window's
// lookup is a random L2 sector or two.  A scatter of f32 atomics into a
// zeroed spectrum pays a pass to zero it and a read-modify-write of a
// sector per window on top.  The design writes every cell once, zeros
// included, with no memset of the spectrum and no global atomics on it.
// The spectrum is counted in vocabulary slices of SLICE_BYTES of
// shared-memory counters, one (slice, read set) task at a time:
// 1. count_lookup: each thread looks up RUN consecutive windows of a read
//    set (wide_lookup.cuh::window_rows: one rolling code, all RUN lookups
//    in flight together) and appends the vocabulary indices of the known
//    ones to the read set's row of the kept rows [B, Wp] (Wp = W rounded
//    up to RUN): a block gathers its indices in shared memory, claims
//    their place in the row by one atomic on the read set's count n[b] and
//    writes them out in whole lines.  The order of a row's indices varies
//    from run to run; the counts do not.  Only the known windows are kept:
//    23 % of phase 3's random reads at k = 16, a third at k = 10, 93 % of
//    real reads at k = 10.
// 2. The bucketed plan sorts each read set's kept indices by slice, so
//    that a task reads only its own indices:
//    - count_slices_hist: each read set's [S] counts of kept indices by
//      slice, a block's tile of HIST_TILE indices counted in shared memory
//      (a thread's equal neighbours merged), one global add a bin a block;
//    - count_slices_scan: each read set's counts -> its buckets' offsets
//      in its row (an exclusive scan), and its tasks queued (below);
//    - count_slices_scatter: each tile of SCATTER_TILE kept indices read
//      once and sorted by slice in shared memory (ranks from shared
//      atomics), each slice's run given its place in its bucket by one
//      global atomic, the runs written out as contiguous stores into the
//      bucketed rows [B, Wp].  The order within a bucket varies from run
//      to run; the counts do not.
// 3. count_slices: one wave of blocks (two to an SM) takes the tasks from
//    an atomic queue, each block the next task as it finishes one.  For a
//    task a block reads the task's indices (its bucket; in the read-all
//    plan the read set's whole kept row, keeping those in its slice), from
//    L2 or HBM, UNROLL chunks of loads in flight a thread, counts them as
//    integers in shared memory, then converts the slice to f32 and writes
//    it whole with 16-byte streaming stores, zeroing each quad of counters
//    as it reads it.  The counters sit shifted by the slice's offset within
//    its 16-byte line of the output, so every quad of counters is one
//    aligned 16-byte store.  A thread merges equal neighbours of its RUN
//    indices before its one shared-memory atomic, so a read set of one
//    repeated k-mer puts about n / RUN atomics on its cell.  Counters are
//    u16, two to a word, while a read set has at most 65,535 windows (no
//    cell can carry into its neighbour), else u32; a slice is SLICE_BYTES
//    of counters (8 slices of 49,152 cells at the headline, 21 at k = 16,
//    342 of 24,576 at k = 12 with u32 counters).
// Balancing: buckets are uneven (GC-rich code ranges hold more windows, a
// read set of one repeated k-mer puts all its windows in one bucket), so
// the scan queues each task larger than twice its read set's mean bucket
// at the front of the queue and the rest behind: the largest tasks start
// first and the small ones fill the wave's tail.  In the read-all plan the
// tasks of a slice are alike and the queue is slice-major.
// The plan (ops/pipeline.py::count_plan, the caller's `bucket`): the
// read-all plan reads each kept row once a slice, S times (342 x 16 x
// 340 MB = 1.86 TB a batch at k = 12); the bucketed one reads it three
// times and writes it once, in three launches more.  The wrapper buckets
// where a read set takes u32 counters (more than 65,535 windows) and the
// rows span 2 to BUCKET_SLICES_MAX slices, since that is where the
// measurements split.  Measured on an H100 (tools/probe_count.py, the
// kernels alone): 4 read sets of 88.8M windows at k = 12, 17.3 ms
// bucketed against 85.5 read-all (lookup 4.86, histogram 0.44, scatter
// 1.46, slices 10.5, most of it the one block that counts the all-A read
// set's one bucket); 64 x 601,876 windows at k = 10, 0.65 against 1.14;
// 64 x 65,536, 0.15 against 0.17; with u16 counters read-all was faster
// at six of seven inputs (64 genomes of 29,894 windows, 0.111 against
// 0.103; phase 3's batch at k = 10, 0.155 against 0.137), bucketed at one
// (real reads at k = 16, 93 % of windows kept: 0.344 against 0.362).  A
// histogram fused into the lookup would add one global add a bin a lookup
// block: the histogram at that tile (2,048) took 1.83 ms against 0.44 on
// the 4 read sets, more than the pass it would save.
// (One launch whose blocks took lookup and slice tasks from a queue, so
// that later read sets' LUT gathers overlapped earlier ones' stores,
// measured slower on the card than the two launches of the read-all plan.)
//
// Scratch (int32, ops/pipeline.py::count_workspace), for B read sets
// and S slices: n[B] (each read set's count of kept indices), n_known[B],
// the task queue (a u64), the bucket queue's head and tail; in the
// bucketed plan end[B S] (the histogram, then each bucket's next free
// place, which the scatter leaves at the bucket's end), start[B S] and
// order[B S] (the queue of tasks); padded to 16 bytes, then the kept rows
// [B, Wp] and, bucketed, the bucketed rows [B, Wp].  Only the counts, the
// queue and end are zeroed.
//
// A row range (kpop-classify-torch's k-mer-sharded serving,
// parallel/serving.py): the lookup keeps only the known windows whose
// vocabulary index lies in [row0, row0 + rows), shifted by row0, and the
// slices count the rows cells of that range into a [B, rows] spectrum.
// Where the caller asks (known), the lookup also counts every known window
// of each read set into n_known: the global normaliser of a shard's
// projection.  The default range, 0 and V, takes the lookup with neither
// the range test nor that count (RANGED false): there every known window
// is kept, so each read set's count of kept windows, n[b], is its
// normaliser, with or without known.
//
// Exactness: the counts are integers, summed in shared memory in any
// order, and each cell is converted to float32 once: exact below 2^24, one
// float32 rounding above (u32 counters, read sets of more than 65,535
// windows).  So the result equals the plain version bit for bit and is the
// same from run to run, in either plan.  The normaliser stays an int32
// count, exact for any read set the wrapper takes
// (ops/encode.py::READ_MAX_BASES).  Every batch offset (read set times its
// row of codes, indices or spectrum, or its S buckets) is 64-bit; a read
// set's positions and windows are int32.
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
//
// The 2-bit wire (kpop_count_spectra_packed, kpop_count_spectra_wide_packed;
// DNA only): the lookup reads each base from the packed and validity bytes
// (wide_lookup.cuh::PackedWire) where the int8 entry points read a code
// byte; nothing else changes, so the spectra are the int8 entry points'
// bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_lookup.cuh"

// ops/pipeline.py sizes the scratch and plans the count from these; they
// come from there as defines (_build.py::nvcc_flags)
#if !defined(KPOP_COUNT_RUN) || !defined(KPOP_COUNT_SLICE_BYTES) || \
    !defined(KPOP_COUNT_NARROW_MAX) || !defined(KPOP_COUNT_BUCKET_SLICES)
#error "build with the -DKPOP_COUNT_* layout defines of _build.py::nvcc_flags"
#endif

namespace {

constexpr int LOOKUP_THREADS = 256;
constexpr int RUN = KPOP_COUNT_RUN;     // windows a thread looks up, and indices it merges
constexpr int THREADS = 512;
constexpr int CHUNK = THREADS * RUN;    // indices a slice block reads at once
constexpr int UNROLL = 4;               // chunks of indices a thread loads at once
constexpr int SLICE_BYTES = KPOP_COUNT_SLICE_BYTES;  // counters of a slice
constexpr int PAD_BYTES = 16;           // the counters' shift within a 16-byte line
constexpr int NARROW_MAX = KPOP_COUNT_NARROW_MAX;  // windows a read set for u16 counters
constexpr int HIST_TILE = 16 * CHUNK;   // kept indices a histogram block counts
constexpr int SCATTER_PER = 16;         // kept indices a scatter thread places
constexpr int SCATTER_TILE = THREADS * SCATTER_PER;
constexpr int BUCKET_SLICES_MAX = KPOP_COUNT_BUCKET_SLICES;  // the scatter's bins
constexpr uint32_t MISS = 0xffffffffu;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RUN == 8, "two 16-byte loads a thread");
static_assert(SLICE_BYTES % 16 == 0, "a slice's counters are whole 16-byte quads");
static_assert(NARROW_MAX <= 65535, "no u16 counter carries into its neighbour");
static_assert(SCATTER_PER % 4 == 0, "16-byte loads");

// cells a slice: u32 counters (WIDE) or u16
template <bool WIDE>
constexpr int SLICE_CELLS = WIDE ? SLICE_BYTES / 4 : SLICE_BYTES / 2;

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

// The exclusive prefix sum of v over the block's THREADS threads (every
// thread calls it)
__device__ __forceinline__ int block_exclusive_sum(int v) {
    __shared__ int warp_sum[THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int w = lane < THREADS / 32 ? warp_sum[lane] : 0;
        int wi = w;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, wi, o);
            if (lane >= o) wi += y;
        }
        if (lane < THREADS / 32) warp_sum[lane] = wi - w;
    }
    __syncthreads();
    const int out = warp_sum[warp] + incl - v;
    __syncthreads();
    return out;
}

// Bucketed plan, 1: each read set's counts of kept indices by slice into
// end[b, s] (zero on entry); block (x, b) counts the tile [x HIST_TILE,
// (x + 1) HIST_TILE) of read set b's n[b] kept indices
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
count_slices_hist(const uint32_t* __restrict__ idx, const int* __restrict__ n_idx, int Wp,
                  int slices, int* __restrict__ end) {
    extern __shared__ int bins[];
    constexpr uint32_t CELLS = SLICE_CELLS<WIDE>;
    const int b = blockIdx.y, n = n_idx[b];
    const int t0 = blockIdx.x * HIST_TILE;
    if (t0 >= n) return;
    for (int i = threadIdx.x; i < slices; i += THREADS) bins[i] = 0;
    __syncthreads();
    const int t1 = min(n, t0 + HIST_TILE);
    // a thread's RUN entries at w lie inside the row: w and Wp are
    // multiples of RUN
    const uint4* row = reinterpret_cast<const uint4*>(idx + (size_t)b * Wp);
    for (int w0 = t0 + threadIdx.x * RUN; w0 < t1; w0 += UNROLL * CHUNK) {
        uint4 p[UNROLL], q[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * CHUNK;
            if (w < t1) {
                p[u] = row[w / 4];
                q[u] = row[w / 4 + 1];
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * CHUNK;
            if (w >= t1) break;
            const uint32_t v[RUN] = {p[u].x, p[u].y, p[u].z, p[u].w,
                                     q[u].x, q[u].y, q[u].z, q[u].w};
            const int valid = min(RUN, t1 - w);
            uint32_t cur = v[0] / CELLS;
            int m = 1;
#pragma unroll
            for (int r = 1; r < RUN; ++r) {
                if (r >= valid) break;
                const uint32_t s = v[r] / CELLS;
                if (s == cur) {
                    ++m;
                } else {
                    atomicAdd(bins + cur, m);
                    cur = s;
                    m = 1;
                }
            }
            atomicAdd(bins + cur, m);
        }
    }
    __syncthreads();
    int* counts = end + (size_t)b * slices;
    for (int i = threadIdx.x; i < slices; i += THREADS)
        if (bins[i]) atomicAdd(counts + i, bins[i]);
}

// Bucketed plan, 2: block b turns read set b's counts end[b, :] into its
// buckets' offsets, start[b, :] and end[b, :] both set to them (the
// scatter advances end), and queues its tasks s B + b in order[B S]: a
// task larger than twice the read set's mean bucket from the front (head),
// the rest from the back (tail)
__global__ void __launch_bounds__(THREADS)
count_slices_scan(const int* __restrict__ n_idx, int B, int slices, int* __restrict__ end,
                  int* __restrict__ start, int* __restrict__ order, int* __restrict__ queued) {
    const int b = blockIdx.x;
    const long long n = n_idx[b];
    const long long tasks = (long long)slices * B;
    int* e = end + (size_t)b * slices;
    int* st = start + (size_t)b * slices;
    const int per = (slices + THREADS - 1) / THREADS;
    const int s0 = min(slices, threadIdx.x * per), s1 = min(slices, s0 + per);
    int sum = 0;
    for (int s = s0; s < s1; ++s) sum += e[s];
    int at = block_exclusive_sum(sum);
    for (int s = s0; s < s1; ++s) {
        const int size = e[s];
        st[s] = at;
        e[s] = at;
        at += size;
        const int task = s * B + b;
        if ((long long)size * slices > 2 * n) order[atomicAdd(queued, 1)] = task;
        else order[tasks - 1 - atomicAdd(queued + 1, 1)] = task;
    }
}

// Bucketed plan, 3: block (x, b) places the tile [x SCATTER_TILE, (x + 1)
// SCATTER_TILE) of read set b's kept indices into its buckets of the
// bucketed row, each slice's run of the tile at the place that one atomic
// on end[b, s] claims
template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
count_slices_scatter(const uint32_t* __restrict__ idx, const int* __restrict__ n_idx, int Wp,
                     int slices, int* __restrict__ end, uint32_t* __restrict__ bkt) {
    extern __shared__ __align__(16) uint32_t tile[];  // the tile by slice, then 2 S ints
    int* base = reinterpret_cast<int*>(tile + SCATTER_TILE);  // counts, then the run's start
    int* shift = base + slices;  // a slice's place in the bucket less its run's in the tile
    constexpr uint32_t CELLS = SLICE_CELLS<WIDE>;
    const int b = blockIdx.y, n = n_idx[b];
    const int t0 = blockIdx.x * SCATTER_TILE;
    if (t0 >= n) return;
    for (int i = threadIdx.x; i < slices; i += THREADS) base[i] = 0;
    __syncthreads();
    // each thread's SCATTER_PER indices, by 16-byte loads of consecutive
    // threads; positions past n are MISS
    const uint4* row = reinterpret_cast<const uint4*>(idx + (size_t)b * Wp + t0);
    const int m = min(SCATTER_TILE, n - t0);
    uint32_t v[SCATTER_PER];
#pragma unroll
    for (int u = 0; u < SCATTER_PER / 4; ++u) {
        const int w = (u * THREADS + threadIdx.x) * 4;
        const uint4 x = w < m ? row[w / 4] : make_uint4(MISS, MISS, MISS, MISS);
        v[4 * u] = w < m ? x.x : MISS;
        v[4 * u + 1] = w + 1 < m ? x.y : MISS;
        v[4 * u + 2] = w + 2 < m ? x.z : MISS;
        v[4 * u + 3] = w + 3 < m ? x.w : MISS;
    }
    // each index's rank among the tile's of its slice: a run of equal
    // slices among a thread's indices takes one shared atomic
    int len[SCATTER_PER], rank[SCATTER_PER];
    len[SCATTER_PER - 1] = 1;
#pragma unroll
    for (int r = SCATTER_PER - 2; r >= 0; --r)
        len[r] = v[r] / CELLS == v[r + 1] / CELLS ? len[r + 1] + 1 : 1;
#pragma unroll
    for (int r = 0; r < SCATTER_PER; ++r) {
        if (v[r] == MISS) break;
        const uint32_t s = v[r] / CELLS;
        rank[r] = r > 0 && s == v[r - 1] / CELLS ? rank[r - 1] + 1 : atomicAdd(base + s, len[r]);
    }
    __syncthreads();
    // the tile's runs in slice order, and each run's place in its bucket
    const int per = (slices + THREADS - 1) / THREADS;
    const int s0 = min(slices, threadIdx.x * per), s1 = min(slices, s0 + per);
    int sum = 0;
    for (int s = s0; s < s1; ++s) sum += base[s];
    int at = block_exclusive_sum(sum);
    int* claim = end + (size_t)b * slices;
    for (int s = s0; s < s1; ++s) {
        const int c = base[s];
        base[s] = at;
        if (c) shift[s] = atomicAdd(claim + s, c) - at;
        at += c;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SCATTER_PER; ++r)
        if (v[r] != MISS) tile[base[v[r] / CELLS] + rank[r]] = v[r];
    __syncthreads();
    uint32_t* out = bkt + (size_t)b * Wp;
    for (int j = threadIdx.x; j < m; j += THREADS) {
        const uint32_t x = tile[j];
        out[shift[x / CELLS] + j] = x;
    }
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
// written once would otherwise push the index rows and the vocabulary
// table out of L2
__device__ __forceinline__ void put(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void put4(float* p, float4 v) { __stcs(reinterpret_cast<float4*>(p), v); }

// Each thread's RUN indices of one chunk, those at [from, to) of them read:
// equal neighbours merged, one atomic a run
template <bool WIDE>
__device__ __forceinline__ void count_run(uint32_t* cnt, uint4 p, uint4 q, int from, int to,
                                          uint32_t lo, uint32_t n, uint32_t shift) {
    uint32_t v[RUN] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
    for (int r = 0; r < RUN; ++r)
        if (r < from || r >= to) v[r] = MISS;
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

// One slice [lo, lo + n) of one read set's spectrum from the indices at
// [a, e) of its row into o; the counters are zero on entry and left zero.
// Cell c sits at counter c + shift, where shift is o's place within its
// 16-byte line, so counter quad q is the aligned output quad at o - shift
// + 4 q.  The row is read by 16-byte loads from a rounded down to 4.
template <bool WIDE>
__device__ void count_slice(const uint32_t* __restrict__ idx_row, int a, int e, int lo, int n,
                            uint32_t* cnt, float* __restrict__ o) {
    const uint4* row = reinterpret_cast<const uint4*>(idx_row);
    const uint4 miss = make_uint4(MISS, MISS, MISS, MISS);
    const int shift = (int)(((uintptr_t)o >> 2) & 3);
    // UNROLL chunks' loads in flight before their atomics; w + 8 <= Wp
    // wherever w + 4 < e, as w is a multiple of 4 and Wp of 8
    for (int w0 = (a & ~3) + threadIdx.x * RUN; w0 < e; w0 += UNROLL * CHUNK) {
        uint4 p[UNROLL], q[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * CHUNK;
            p[u] = w < e ? row[w / 4] : miss;
            q[u] = w + 4 < e ? row[w / 4 + 1] : miss;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            count_run<WIDE>(cnt, p[u], q[u], a - (w0 + u * CHUNK), e - (w0 + u * CHUNK), lo, n,
                            shift);
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

// The T = slices x B (slice, read set) tasks, task s B + b, each block
// taking the next from the queue until none is left: in the order of
// order[] with the bucketed rows (BUCKETED: task (s, b) reads [start,
// end) of row b), else slice-major with the kept rows (all n[b] of row b)
template <bool WIDE, bool BUCKETED>
__global__ void __launch_bounds__(THREADS)
count_slices(const uint32_t* __restrict__ idx, const int* __restrict__ n_idx,
             const int* __restrict__ start, const int* __restrict__ end,
             const int* __restrict__ order, unsigned long long* __restrict__ queue, int B, int Wp,
             int rows, int slices, float* __restrict__ out) {
    extern __shared__ __align__(16) uint32_t cnt[];
    __shared__ long long next;
    constexpr int CELLS = SLICE_CELLS<WIDE>;
    for (int i = threadIdx.x; i < (SLICE_BYTES + PAD_BYTES) / 16; i += THREADS)
        reinterpret_cast<uint4*>(cnt)[i] = make_uint4(0u, 0u, 0u, 0u);
    const long long tasks = (long long)slices * B;
    // count_slice's barriers keep the next task from overwriting `next`
    // before every thread has read it
    for (;;) {
        if (threadIdx.x == 0) next = (long long)atomicAdd(queue, 1ull);
        __syncthreads();
        const long long t = next;
        if (t >= tasks) break;
        const long long task = BUCKETED ? order[t] : t;
        const int s = (int)(task / B), b = (int)(task % B);
        const int lo = s * CELLS;
        const size_t at = (size_t)b * slices + s;
        count_slice<WIDE>(idx + (size_t)b * Wp, BUCKETED ? start[at] : 0,
                          BUCKETED ? end[at] : n_idx[b], lo, min(CELLS, rows - lo), cnt,
                          out + (size_t)b * rows + lo);
    }
}

// The launch of the slices kernel: one wave, every SM's resident blocks
template <bool WIDE, bool BUCKETED>
cudaError_t launch_slices(const uint32_t* rows_of, const int* n_idx, const int* start,
                          const int* end, const int* order, unsigned long long* queue, int B,
                          int Wp, int rows, int slices, float* out, cudaStream_t st) {
    auto kernel = count_slices<WIDE, BUCKETED>;
    const int smem = SLICE_BYTES + PAD_BYTES;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    int dev = 0, sms = 132, per_sm = 1;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    const long long tasks = (long long)slices * B, wave = (long long)max(1, per_sm) * sms;
    kernel<<<(int)(tasks < wave ? tasks : wave), THREADS, smem, st>>>(
        rows_of, n_idx, start, end, order, queue, B, Wp, rows, slices, out);
    return cudaGetLastError();
}

// The bucketed plan's three launches, then the slices over the bucketed
// rows
template <bool WIDE>
cudaError_t bucket_and_count(const uint32_t* idx, uint32_t* bkt, const int* n_idx, int* end,
                             int* start, int* order, int* queued, unsigned long long* queue,
                             int B, int Wp, int rows, int slices, float* out, cudaStream_t st) {
    if (Wp > 0) {
        count_slices_hist<WIDE><<<dim3((Wp + HIST_TILE - 1) / HIST_TILE, B), THREADS,
                                  slices * sizeof(int), st>>>(idx, n_idx, Wp, slices, end);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    count_slices_scan<<<B, THREADS, 0, st>>>(n_idx, B, slices, end, start, order, queued);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (Wp > 0) {
        auto scatter = count_slices_scatter<WIDE>;
        const int smem = SCATTER_TILE * 4 + 2 * slices * (int)sizeof(int);
        err = cudaFuncSetAttribute(scatter, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        scatter<<<dim3((Wp + SCATTER_TILE - 1) / SCATTER_TILE, B), THREADS, smem, st>>>(
            idx, n_idx, Wp, slices, end, bkt);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return launch_slices<WIDE, true>(bkt, n_idx, start, end, order, queue, B, Wp, rows, slices,
                                     out, st);
}

// Every launch for any lookup, into the [B, rows] spectra of the
// vocabulary rows [row0, row0 + rows); scratch: the int32 scratch laid out
// as the header says for the plan (bucket: the bucketed plan), Wp = L - k
// + 1 rounded up to RUN
template <class Wire, class Find>
int count_spectra(const typename Wire::Byte* bases, const uint8_t* valid, int B, int L, int k,
                  int canonical, int base, const Find& find, int V, int row0, int rows, int known,
                  int bucket, uint32_t* scratch, float* out, void* stream) {
    const int W = L - k + 1;
    if (row0 < 0 || rows < 0) return (int)cudaErrorInvalidValue;
    if (B <= 0 || V <= 0 || rows == 0) return (int)cudaGetLastError();
    const int Wp = W > 0 ? (W + RUN - 1) / RUN * RUN : 0;
    const bool wide = W > NARROW_MAX;
    const int cells = wide ? SLICE_CELLS<true> : SLICE_CELLS<false>;
    const int slices = (rows + cells - 1) / cells;
    if (bucket && slices > BUCKET_SLICES_MAX) return (int)cudaErrorInvalidValue;
    int* n_idx = reinterpret_cast<int*>(scratch);
    auto* queue = reinterpret_cast<unsigned long long*>(n_idx + 2 * B);  // 8-byte aligned
    int* queued = n_idx + 2 * B + 2;
    int* end = n_idx + 2 * B + 4;
    const size_t BS = bucket ? (size_t)B * slices : 0;
    int* start = end + BS;
    int* order = start + BS;
    uint32_t* idx = scratch + ((2 * (size_t)B + 4 + 3 * BS + 3) & ~(size_t)3);
    uint32_t* bkt = idx + (size_t)B * Wp;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(n_idx, 0, (2 * (size_t)B + 4 + BS) * sizeof(int), st);
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
    if (bucket)
        err = wide ? bucket_and_count<true>(idx, bkt, n_idx, end, start, order, queued, queue, B,
                                            Wp, rows, slices, out, st)
                   : bucket_and_count<false>(idx, bkt, n_idx, end, start, order, queued, queue,
                                             B, Wp, rows, slices, out, st);
    else
        err = wide ? launch_slices<true, false>(idx, n_idx, nullptr, nullptr, nullptr, queue, B,
                                                Wp, rows, slices, out, st)
                   : launch_slices<false, false>(idx, n_idx, nullptr, nullptr, nullptr, queue, B,
                                                 Wp, rows, slices, out, st);
    return (int)err;
}

}  // namespace

// k up to lut_k_max: codes [B, L] int8; lut is the dense [base^k + 1]
// table; the spectra of the vocabulary rows [row0, row0 + rows) (0 and V:
// all of it), and with known (nonzero) on another range each read set's
// count of all its known windows (on the default range, the kept count);
// bucket (nonzero): the bucketed plan, on its scratch
extern "C" int kpop_count_spectra(const int8_t* codes, int B, int L, int k, int canonical,
                                  int base, const int32_t* lut, int V, int row0, int rows,
                                  int known, int bucket, uint32_t* idx, float* out,
                                  void* stream) {
    return count_spectra<kpop::CodeWire>(codes, nullptr, B, L, k, canonical, base,
                                         kpop::LutFind{lut, V}, V, row0, rows, known, bucket, idx,
                                         out, stream);
}

// larger k: the cuckoo hash's probe layout (ops/cuckoo.py::probe_table) of
// `slots` slots a table with its seeds, or (probe null) the sorted limbs
// [V] {hi, lo} (wide_lookup.cuh)
extern "C" int kpop_count_spectra_wide(const int8_t* codes, int B, int L, int k, int canonical,
                                       int base, int k_lo, const int32_t* probe, int slots,
                                       uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2,
                                       const int32_t* limbs, int V, int row0, int rows,
                                       int known, int bucket, uint32_t* idx, float* out,
                                       void* stream) {
    if (!kpop::wide_args_ok(k, probe, slots, limbs)) return (int)cudaErrorInvalidValue;
    return count_spectra<kpop::CodeWire>(
        codes, nullptr, B, L, k, canonical, base,
        kpop::wide_find(base, k_lo, probe, slots, a1, b1, a2, b2, limbs, V), V, row0, rows, known,
        bucket, idx, out, stream);
}

// The same two on the 2-bit wire: packed [B, (L + 3) / 4] and valid
// [B, (L + 7) / 8] bytes in place of the codes (DNA, base 4)
extern "C" int kpop_count_spectra_packed(const uint8_t* packed, const uint8_t* valid, int B,
                                         int L, int k, int canonical, int base,
                                         const int32_t* lut, int V, int row0, int rows,
                                         int known, int bucket, uint32_t* idx, float* out,
                                         void* stream) {
    if (base != 4) return (int)cudaErrorInvalidValue;
    return count_spectra<kpop::PackedWire>(packed, valid, B, L, k, canonical, base,
                                           kpop::LutFind{lut, V}, V, row0, rows, known, bucket,
                                           idx, out, stream);
}

extern "C" int kpop_count_spectra_wide_packed(const uint8_t* packed, const uint8_t* valid, int B,
                                              int L, int k, int canonical, int base, int k_lo,
                                              const int32_t* probe, int slots, uint32_t a1,
                                              uint32_t b1, uint32_t a2, uint32_t b2,
                                              const int32_t* limbs, int V, int row0, int rows,
                                              int known, int bucket, uint32_t* idx, float* out,
                                              void* stream) {
    if (base != 4 || !kpop::wide_args_ok(k, probe, slots, limbs)) return (int)cudaErrorInvalidValue;
    return count_spectra<kpop::PackedWire>(
        packed, valid, B, L, k, canonical, base,
        kpop::wide_find(base, k_lo, probe, slots, a1, b1, a2, b2, limbs, V), V, row0, rows, known,
        bucket, idx, out, stream);
}
