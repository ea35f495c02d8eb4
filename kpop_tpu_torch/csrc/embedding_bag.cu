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
// What bounds it on the H100.  The function must read the codes, the LUT
// and each twister row that the batch hits, and write [B, d]: at the
// headline batch (128 read sets of 30k windows, V = 368k, d = 511) that is
// about 0.38 GB, 0.115 ms at 3.35 TB/s.  A gather of one row per known
// window moves 4 d bytes a window instead, 7x as many for random reads and
// more for real ones, whose read sets share most of their k-mers.  So the
// design reads each hit row once per batch and column block, and turns the
// rest into integer bookkeeping and sums in registers.  What bounds it then
// is not HBM bandwidth on rows but two other things.  The bookkeeping
// (bucket, scan, compact) is a chain of dependent, atomic-heavy steps; it
// takes about a third of the time.  The accumulate takes the rest: its
// copies alone and its sums alone (bound by shared-memory loads and
// instruction issue) take about as long each, and they overlap only in
// part, since the same threads issue both (tools/probe_bag.py measures
// each part and each stage).  At large k on random reads almost every
// hit row serves one entry (852,380 rows for 853,022 entries at k = 16,
// V = 1,011,930: 1.74 GB of row slices); there the gather regime below
// reads them at 2.6-2.7 TB/s on an H100 (0.64-0.67 ms, the same with the
// sums left out), so it is bound by HBM.
//
// The stages, per pass of up to GROUP read sets:
//
// 1. bucket.  bag_histogram computes each window's vocabulary row (a
//    rolling window code over a thread's HIST_PER consecutive windows,
//    then the LUT; wide_lookup.cuh), keeps it, and counts the known windows per
//    counter: one of COPIES per bucket of R / SUB rows, picked by the read
//    set, so that rows that every read set hits do not pile their atomics
//    on one address; bag_tile_sums, bag_scan and bag_cursors turn the
//    counters into each tile's key offset, the list of the tiles of R rows
//    that hold keys, and each counter's slot cursor; bag_scatter writes one
//    key (row within its tile << 8 | read set) per known window into a
//    [B W] int32 list, grouped by counter and so by tile.  Slot claims are
//    integer atomics, so the order of keys within a tile varies from run to
//    run; the next stage only counts them.
// 2. compact.  bag_compact, one block a tile that holds keys, counts the
//    tile's keys into exact integer counts per (read set, row) in shared
//    memory (u16, two to a word, while a read set has at most 65,535
//    windows, so six blocks share an SM and hide each tile's dependent
//    loads), with a mask of the rows each read set hit, and writes them
//    back as entries {the row within the tile << 16 | where it sits among
//    the tile's hit rows, count as f32}, read set by read set and each in
//    row order, with the tile's hit-row mask; it also sums the pass's
//    entries, which with its tiles choose the accumulate's regime.  It
//    touches only the cells its keys hit.  Integer counts do not depend on
//    the order of the keys, so from here on everything is deterministic.
// 3. accumulate, in one of two regimes that add the same products in the
//    same order (so the same bits).  Staged (bag_accumulate), where tiles
//    hold more than GATHER_TILE_ENTRIES entries on average (k = 10):
//    block (y, s) owns columns [COLS y, COLS y + COLS) of d
//    and the tiles of slice s: the slices split the tiles into S parts of
//    near-equal keys plus tiles.  It walks its tiles in order, the next
//    one in flight: every thread issues 16-byte cp.async copies of the
//    tile's header, entries and hit rows' column slices into a ring in
//    shared memory, so each hit row is read once, and a tile takes only the
//    bytes it needs (the densest, 16k entries and 128 rows, fits alone).
//    Warp w keeps the sums of read sets 4 w .. 4 w + 3 in registers, each
//    lane those of 4 columns (lane_col), and adds count x row[c] (one f32
//    product, one f32 add) for each read set's entries in entry order.  A
//    (read set, column) has one owner, so there are no atomics on floats.
//    Gather (bag_gather), where tiles are sparse (random reads at k = 16:
//    853,022 entries on 852,380 hit rows in 7,906 tiles).  Staging
//    then buys no reuse, and the staged ring's time went to its serial
//    chain (wait for a tile, sum, barrier, issue the tile after next) and
//    to the copies' issue, not to HBM (1.02 ms for 1.74 GB).  The
//    same blocks, slices and owners read each entry's row slice straight
//    into registers, GATHER_AHEAD entries in flight a warp and 32 warps an
//    SM, with no shared memory and no barrier: each warp reads its read
//    sets' entry ranges GATHER_TILES tiles at a time, fetches 32 entries
//    at once, and adds them in order.
// 4. slice sum.  Each block writes its [B, COLS] partial to an f32
//    workspace [S, B, d]; bag_slice_sum adds the slices in order and
//    divides by n_known, the read set's int32 count of known windows, once
//    in float64, so the quotient is the correctly rounded float32 one at
//    any count (below 2^24 the same bits as a float32 division).
//
// count x row is rounded once where a plain sum adds the row count times,
// so the result differs from the plain version in the last bits; the sum
// is the same from run to run.  A count is an integer until it becomes the
// entry's float32 once: exact below 2^24, one rounding above.  A pass's
// keys and entries are int32 (2 Bg W < 2^31 for the Bg read sets a
// launch takes, ops/pipeline.py::bag_row_groups); every batch offset is
// 64-bit.
//
// Large k (kpop_embedding_bag_wide): bag_histogram computes each window's
// code in uint64 and looks it up in the cuckoo hash's fingerprints and
// slots or the sorted limbs of wide_lookup.cuh in place of the LUT; every
// later stage is the same.
//
// The 2-bit wire (kpop_embedding_bag_packed, kpop_embedding_bag_wide_packed;
// DNA only): bag_histogram, the one stage that reads the read sets, reads
// each base from the packed and validity bytes (wide_lookup.cuh::
// PackedWire); a pass of GROUP read sets starts at their rows of both;
// every later stage is the same, so the result is the int8 entry points'
// bit for bit.
//
// bf16 twisters (row type 1; kpop-classify --dtype bf16, the JAX
// package's project_reads on a bf16 twister, whose scan widens each
// gathered row to f32 and sums in f32).  Row v starts at element v ld
// (ld, the row stride, >= d).  A bf16 twister's ld must be a multiple of 8
// (ops/pipeline.py::bf16_rows: 512 at d = 511), so every row starts on 16
// bytes: in both regimes a lane owns the 4 consecutive columns 4 l .. 4 l
// + 3 of a 128-column block (lane_col) and reads them as one 8-byte word,
// where 2-byte reads of 4 columns 32 apart took four load instructions and
// left the gather bound by them and the staged sums by instruction issue.
// Each element is widened to f32 exactly (its 16 bits as the high half)
// and then goes through the same f32 products and sums, in the same order,
// as an f32 row's, so both regimes still give the same bits, and the same
// as an f32 twister of the widened values.  f32 rows keep their 4 columns
// 32 apart a lane.  Rows off 8-byte words are refused: reading them as two
// words and funnel-shifting the pair measured slower on real reads
// (PERF.md §6).  The staged ring's 16-byte windows align down by
// PER_CHUNK elements (Row<Tw>), so an f32 row's start at any 4 bytes takes
// 33 chunks a 128-column slice; a bf16 slice is 256 bytes at no offset,
// in 17 chunks, one to spare.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_lookup.cuh"

namespace {

constexpr int COLS = 128;                // columns per accumulate block: 4 a lane
constexpr int THREADS = 1024;            // warp w: read sets [4 w, 4 w + 4)
constexpr int GROUP = 128;               // read sets per pass (8 bits of a key)
constexpr int R = 128;                   // rows of a vocabulary tile: 4 words of hit mask
constexpr int SUB = 8;                   // buckets of R / SUB rows a tile
constexpr int COPIES = 4;                // counters a bucket, by read set
constexpr int CNT = SUB * COPIES;        // counters a tile
constexpr int WORDS = R / 32;
constexpr int HIST_THREADS = 256;
constexpr int HIST_PER = 8;              // windows per bucket thread
constexpr int HIST_WINDOWS = HIST_THREADS * HIST_PER;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int COMPACT_THREADS = 256;
constexpr int NARROW_MAX = 65535;         // windows a read set for the compact's u16 counts
constexpr int HDR_INTS = 4 + GROUP + 4;    // a tile's stage header, 16-byte padded
constexpr int HDR_CHUNKS = HDR_INTS / 4;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS / 32 * 4 == GROUP && COLS == 4 * 32, "accumulate block shape");
static_assert(COMPACT_THREADS >= GROUP && COMPACT_THREADS % 32 == 0, "compact block shape");
static_assert(HDR_INTS % 4 == 0, "a header is whole 16-byte chunks");
static_assert(CNT % 4 == 0 && R % SUB == 0 && R % 32 == 0, "a tile's counters are whole int4s");

// A twister row's element type Tw: float, or bf16 held as its 16 bits
// (uint16_t).  A 16-byte chunk holds PER_CHUNK elements; CHUNKS chunks
// hold a COLS-column slice at any offset within its first chunk, and a
// staged row takes STRIDE elements.
template <typename Tw>
struct Row {
    static constexpr int PER_CHUNK = 16 / (int)sizeof(Tw);
    static constexpr int CHUNKS = COLS / PER_CHUNK + 1;
    static constexpr int STRIDE = PER_CHUNK * CHUNKS;
};
static_assert(COLS % Row<uint16_t>::PER_CHUNK == 0, "a column block starts on a chunk");

// whether a lane reads its 4 columns of a row as one 8-byte word: bf16
// rows, which start on 16 bytes
template <typename Tw>
constexpr bool WORD_READS = sizeof(Tw) == 2;

// column k = 0..3 of a lane within its COLS-column block: the lanes
// interleaved (l + 32 k, f32 rows), or 4 consecutive columns a lane (4 l +
// k, one 8-byte word of a bf16 row)
template <typename Tw>
__device__ __forceinline__ int lane_col(int lane, int k) {
    return WORD_READS<Tw> ? 4 * lane + k : lane + 32 * k;
}

// 4 bf16, 2 to a word, widened to f32 exactly
__device__ __forceinline__ void widen4(unsigned lo, unsigned hi, float (&x)[4]) {
    x[0] = __uint_as_float(lo << 16);
    x[1] = __uint_as_float(lo & 0xffff0000u);
    x[2] = __uint_as_float(hi << 16);
    x[3] = __uint_as_float(hi & 0xffff0000u);
}

// the offset of twister[v, col0] in its 16-byte aligned window (col0 is a
// multiple of PER_CHUNK)
template <typename Tw>
__device__ __forceinline__ int row_shift(int v, int ld, int col0) {
    return (int)(((unsigned)v * (unsigned)ld + (unsigned)col0) & (unsigned)(Row<Tw>::PER_CHUNK - 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- 1. bucket --------------------------------------------------------

// grid (ceil(W / HIST_WINDOWS), B): each window's vocabulary row into vt
// (V for a miss), and the known windows per bucket of R / SUB rows and per
// read set.  A thread looks up HIST_PER consecutive windows with one
// rolling code (wide_lookup.cuh::window_rows); the rows go out through
// shared memory so that the block's stores to vt are coalesced.  Lanes
// that fall in one bucket pool their atomic (a read that repeats a k-mer
// sends every window to one bucket); buckets smaller than a tile spread
// the atomics over more counters.
template <class Wire, class Find>
__global__ void __launch_bounds__(HIST_THREADS, 4)
bag_histogram(const typename Wire::Byte* __restrict__ bases, const uint8_t* __restrict__ valid,
              int L, int k, int canonical, int base, const Find find, int V,
              int* __restrict__ vt, int* __restrict__ hist, int* __restrict__ n_known) {
    __shared__ int staged[HIST_THREADS * (HIST_PER + 1)];
    __shared__ int block_known;
    const int b = blockIdx.y;
    const int W = L - k + 1;
    const int first = (int)blockIdx.x * HIST_WINDOWS;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) block_known = 0;
    int v[HIST_PER];
    kpop::window_rows<HIST_PER>(Wire::row(bases, valid, L, b), k, canonical, base, find,
                                first + (int)threadIdx.x * HIST_PER, W, v);
    int known = 0;
#pragma unroll
    for (int i = 0; i < HIST_PER; ++i) {
        staged[threadIdx.x * (HIST_PER + 1) + i] = v[i];
        const int u = v[i] < V ? v[i] / (R / SUB) * COPIES + b % COPIES : -1;
        const unsigned peers = __match_any_sync(FULL, u);
        if (u >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[u], __popc(peers));
        known += u >= 0;
    }
    for (int o = 16; o > 0; o >>= 1) known += __shfl_xor_sync(FULL, known, o);
    __syncthreads();
    if (lane == 0 && known) atomicAdd(&block_known, known);
    for (int i = threadIdx.x; i < HIST_WINDOWS; i += HIST_THREADS)
        if (first + i < W)
            vt[(size_t)b * W + first + i] = staged[i / HIST_PER * (HIST_PER + 1) + i % HIST_PER];
    __syncthreads();
    if (threadIdx.x == 0 && block_known) atomicAdd(&n_known[b], block_known);
}

// a thread a tile: tot[t] = the keys of tile t, the sum of its CNT
// counters
__global__ void bag_tile_sums(const int* __restrict__ bkt, int T, int* __restrict__ tot) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    const int4* c = reinterpret_cast<const int4*>(bkt) + (size_t)(CNT / 4) * t;
    int sum = 0;
#pragma unroll
    for (int u = 0; u < CNT / 4; ++u) {
        const int4 q = c[u];
        sum += q.x + q.y + q.z + q.w;
    }
    tot[t] = sum;
}

// one block: the tile totals tot[0, T) -> their exclusive key offsets, in
// place; the tiles that hold keys, in order, nz[0, n), with their key
// offsets kbase[0, n) and kbase[n] = N
__global__ void __launch_bounds__(SCAN_THREADS)
bag_scan(int* __restrict__ tot, int* __restrict__ nz, int* __restrict__ kbase,
         int* __restrict__ n_nz, int T) {
    __shared__ int warp_k[SCAN_THREADS / 32], warp_n[SCAN_THREADS / 32];
    __shared__ int carry_k, carry_n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry_k = carry_n = 0;
    __syncthreads();
    for (int base = 0; base < T; base += SCAN_THREADS * SCAN_ITEMS) {
        const int i0 = base + (int)threadIdx.x * SCAN_ITEMS;
        int v[SCAN_ITEMS], sk = 0, sn = 0;
#pragma unroll
        for (int i = 0; i < SCAN_ITEMS; ++i) {
            v[i] = i0 + i < T ? tot[i0 + i] : 0;
            sk += v[i];
            sn += v[i] > 0;
        }
        int ik = sk, in = sn;  // inclusive scans within the warp
        for (int o = 1; o < 32; o <<= 1) {
            const int yk = __shfl_up_sync(FULL, ik, o), yn = __shfl_up_sync(FULL, in, o);
            if (lane >= o) ik += yk, in += yn;
        }
        if (lane == 31) warp_k[warp] = ik, warp_n[warp] = in;
        __syncthreads();
        if (warp == 0) {
            int wk = warp_k[lane], wn = warp_n[lane];
            for (int o = 1; o < 32; o <<= 1) {
                const int yk = __shfl_up_sync(FULL, wk, o), yn = __shfl_up_sync(FULL, wn, o);
                if (lane >= o) wk += yk, wn += yn;
            }
            warp_k[lane] = wk;
            warp_n[lane] = wn;
        }
        __syncthreads();
        int ek = carry_k + (warp ? warp_k[warp - 1] : 0) + ik - sk;
        int en = carry_n + (warp ? warp_n[warp - 1] : 0) + in - sn;
#pragma unroll
        for (int i = 0; i < SCAN_ITEMS; ++i) {
            if (i0 + i < T) {
                tot[i0 + i] = ek;
                if (v[i] > 0) {
                    nz[en] = i0 + i;
                    kbase[en] = ek;
                    ++en;
                }
            }
            ek += v[i];
        }
        __syncthreads();
        if (threadIdx.x == SCAN_THREADS - 1) carry_k = ek, carry_n = en;
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        kbase[carry_n] = carry_k;
        *n_nz = carry_n;
    }
}

// a thread a tile: its counters in bkt -> the scatter's cursors, each
// counter's exclusive key offset, from its tile's off[t]
__global__ void bag_cursors(int* __restrict__ bkt, int T, const int* __restrict__ off) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    int4* c = reinterpret_cast<int4*>(bkt) + (size_t)(CNT / 4) * t;
    int run = off[t];
#pragma unroll
    for (int u = 0; u < CNT / 4; ++u) {
        const int4 q = c[u];
        int4 o;
        o.x = run, run += q.x;
        o.y = run, run += q.y;
        o.z = run, run += q.z;
        o.w = run, run += q.w;
        c[u] = o;
    }
}

// the grid of bag_histogram: one key (row within the tile << 8 | read set)
// per known window, grouped by bucket and so by tile; one slot claim for
// the lanes of a bucket
__global__ void __launch_bounds__(HIST_THREADS)
bag_scatter(const int* __restrict__ vt, int W, int V, int* __restrict__ cursor,
            int* __restrict__ keys) {
    const int b = blockIdx.y;
    const int w0 = (int)blockIdx.x * HIST_WINDOWS + (int)threadIdx.x;
    const int lane = threadIdx.x & 31;
    int v[HIST_PER];
#pragma unroll
    for (int i = 0; i < HIST_PER; ++i) {
        const int w = w0 + i * HIST_THREADS;
        v[i] = w < W ? vt[(size_t)b * W + w] : V;
    }
#pragma unroll
    for (int i = 0; i < HIST_PER; ++i) {
        const int u = v[i] < V ? v[i] / (R / SUB) * COPIES + b % COPIES : -1;
        const unsigned peers = __match_any_sync(FULL, u);
        const int leader = __ffs(peers) - 1;
        int slot = 0;
        if (u >= 0 && lane == leader) slot = atomicAdd(&cursor[u], __popc(peers));
        slot = __shfl_sync(FULL, slot, leader) + __popc(peers & ((1u << lane) - 1u));
        if (u >= 0) keys[slot] = ((v[i] % R) << 8) | b;
    }
}

// ---- 2. compact: one block a tile that holds keys -----------------------

// Tile nz[j]'s keys -> exact counts per (read set, row) in shared memory
// and the rows each read set hit -> entries {r << 16 | where row r sits
// among the tile's hit rows in the ring, count as f32}, read set by read
// set and each in row order, written over the tile's own key range of ent;
// *entries gains the tile's entries; meta[j]
// = {tile, entries, entry base}, hit[j] = the tile's hit-row mask, and
// hdr[j] = {tile, entry base & 1, entry base, 0, the first entry of each
// read set, entries} (HDR_INTS, the header the accumulate copies).  The
// counts are zeroed once, and after each tile only where its keys fell.
// NARROW: u16 counts, two to a word, while a read set has at most
// NARROW_MAX windows (no count can carry into its neighbour): half the
// shared memory, so twice the blocks hide the tiles' dependent loads.
template <bool NARROW>
__device__ __forceinline__ unsigned count_of(const unsigned* cnt, int c) {
    return NARROW ? (cnt[c >> 1] >> (16 * (c & 1))) & 0xffffu : cnt[c];
}

template <bool NARROW, typename Tw>
__global__ void __launch_bounds__(COMPACT_THREADS)
bag_compact(const int* __restrict__ keys, const int* __restrict__ nz,
            const int* __restrict__ kbase, const int* __restrict__ n_nz, int B, int ld,
            int2* __restrict__ ent, int4* __restrict__ meta, int4* __restrict__ hit,
            int* __restrict__ hdr, int* __restrict__ entries) {
    extern __shared__ unsigned cnt[];  // [B, R] counts
    __shared__ unsigned rows_of[GROUP][WORDS];
    __shared__ int nb[GROUP + 1];
    __shared__ unsigned hits[WORDS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int n = *n_nz;
    int block_entries = 0;  // thread 0: the block's tiles
    for (int i = threadIdx.x; i < (NARROW ? B * R / 2 : B * R); i += COMPACT_THREADS) cnt[i] = 0;
    for (int i = threadIdx.x; i < GROUP * WORDS; i += COMPACT_THREADS) rows_of[i / WORDS][i % WORDS] = 0;
    if (threadIdx.x < WORDS) hits[threadIdx.x] = 0;
    __syncthreads();
    for (int j = blockIdx.x; j < n; j += gridDim.x) {
        const int k0 = kbase[j], k1 = kbase[j + 1];
        const int t = nz[j];
        for (int i = k0 + threadIdx.x; i < k1; i += COMPACT_THREADS) {
            const int key = keys[i], b = key & 255, r = key >> 8, c = b * R + r;
            const unsigned old = NARROW ? atomicAdd(&cnt[c >> 1], 1u << (16 * (c & 1))) >> (16 * (c & 1))
                                        : atomicAdd(&cnt[c], 1u);
            if ((NARROW ? old & 0xffffu : old) == 0) atomicOr(&rows_of[b][r >> 5], 1u << (r & 31));
        }
        __syncthreads();
        // the entries of each read set, and the tile's hit rows
        if (threadIdx.x < GROUP) {
            const int b = threadIdx.x;
            int m_b = 0;
#pragma unroll
            for (int q = 0; q < WORDS; ++q) {
                const unsigned m = rows_of[b][q];
                m_b += __popc(m);
                const unsigned any = __reduce_or_sync(FULL, m);
                if (lane == 0 && any) atomicOr(&hits[q], any);
            }
            nb[b] = m_b;
        }
        __syncthreads();
        if (warp == 0) {  // exclusive scan of nb over the read sets, 4 a lane
            int v[4], sum = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                v[i] = 4 * lane + i < B ? nb[4 * lane + i] : 0;
                sum += v[i];
            }
            int inc = sum;
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, inc, o);
                if (lane >= o) inc += y;
            }
            int run = inc - sum;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                nb[4 * lane + i] = run;
                run += v[i];
            }
            if (lane == 31) nb[GROUP] = inc;
        }
        __syncthreads();
        // hit row r sits in slot (hit rows below r) of the tile's rows
        int slot0[WORDS];
        slot0[0] = 0;
#pragma unroll
        for (int q = 1; q < WORDS; ++q) slot0[q] = slot0[q - 1] + __popc(hits[q - 1]);
        for (int b = warp; b < B; b += COMPACT_THREADS / 32) {
            int pos = k0 + nb[b];
#pragma unroll
            for (int q = 0; q < WORDS; ++q) {
                const unsigned m = rows_of[b][q];
                if ((m >> lane) & 1u) {
                    const int r = 32 * q + lane;
                    const int slot = slot0[q] + __popc(hits[q] & below);
                    ent[pos + __popc(m & below)] =
                        make_int2(r << 16 | (slot * Row<Tw>::STRIDE + row_shift<Tw>(t * R + r, ld, 0)),
                                  __float_as_int((float)count_of<NARROW>(cnt, b * R + r)));
                }
                pos += __popc(m);
            }
        }
        const int total = nb[GROUP];
        int* h = hdr + (size_t)j * HDR_INTS;
        for (int b = threadIdx.x; b <= GROUP; b += COMPACT_THREADS) h[4 + b] = b < B ? nb[b] : total;
        if (threadIdx.x < 4) h[threadIdx.x] = threadIdx.x == 0 ? t : threadIdx.x == 1 ? (k0 & 1) : threadIdx.x == 2 ? k0 : 0;
        if (threadIdx.x == 0) {
            meta[j] = make_int4(t, total, k0, 0);
            hit[j] = make_int4((int)hits[0], (int)hits[1], (int)hits[2], (int)hits[3]);
            block_entries += total;
        }
        __syncthreads();
        // zero what this tile touched
        for (int i = k0 + threadIdx.x; i < k1; i += COMPACT_THREADS) {
            const int key = keys[i], c = (key & 255) * R + (key >> 8);
            if (NARROW) reinterpret_cast<unsigned short*>(cnt)[c] = 0;
            else cnt[c] = 0;
        }
        for (int i = threadIdx.x; i < GROUP * WORDS; i += COMPACT_THREADS) rows_of[i / WORDS][i % WORDS] = 0;
        if (threadIdx.x < WORDS) hits[threadIdx.x] = 0;
        __syncthreads();
    }
    if (threadIdx.x == 0 && block_entries) atomicAdd(entries, block_entries);
}

// ---- 3. accumulate ----------------------------------------------------

// the first tile of slice s, as an index into the n tiles that hold keys:
// the least j in [0, n] with (kbase[j] + M j) S >= s (N + M n), N =
// kbase[n] keys and M = N / n the mean keys a tile.  A slice costs its keys
// plus a mean tile's keys for each of its tiles, so that a stretch of
// nearly empty tiles (the vocabulary's rarely hit k-mers) does not land in
// one slice.
__device__ int slice_start(const int* __restrict__ kbase, int n, int S, int s) {
    const long long N = kbase[n];
    const long long M = n ? (N / n > 1 ? N / n : 1) : 1;
    const long long target = (long long)s * (N + M * n);
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((kbase[mid] + M * mid) * S >= target) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

// 16 bytes from global to shared memory, of which the first `bytes` are
// read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// tiles in flight at most in an accumulate block, one barrier each, and the
// ring of tiles in shared memory: the rest of what a block may have
constexpr int SLOTS = 2;
constexpr int MBAR_BYTES = (SLOTS * 8 + 15) / 16 * 16;
constexpr int RING_BYTES = 232448 - MBAR_BYTES;
static_assert(HDR_INTS * 4 + (GROUP * R + 2) * 8 + R * Row<float>::CHUNKS * 16 <= RING_BYTES,
              "the densest tile fits in the ring alone");

__device__ __forceinline__ void mbar_init(uint64_t* mbar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(mbar)), "r"(count)
                 : "memory");
}

// one arrival on mbar once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* mbar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(mbar))
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* mbar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(mbar)), "r"(parity) : "memory");
}

// int2 entries of a tile copied from their 16-byte aligned window: n
// entries from entry base e0
__host__ __device__ __forceinline__ int staged_entries(int n, int e0) {
    return (n + (e0 & 1) + 1) & ~1;
}

// A tile in the ring: its header (HDR_INTS), its entries from their
// 16-byte aligned window, and its hit rows [hits, Row<Tw>::STRIDE] in row
// order: hit row r holds the 16-byte aligned window of Row<Tw>::CHUNKS
// chunks that starts at or just before twister[v, col0], so column col0 +
// c sits at slot Row<Tw>::STRIDE + row_shift(v) + c.  Every part is a
// multiple of 16 bytes.
template <typename Tw>
__device__ __forceinline__ int tile_bytes(int4 m, int4 h) {
    const int hits = __popc(h.x) + __popc(h.y) + __popc(h.z) + __popc(h.w);
    return HDR_INTS * 4 + staged_entries(m.y, m.z) * 8 + hits * Row<Tw>::CHUNKS * 16;
}

// the position of the k-th set bit (from 0) of w
__device__ __forceinline__ int nth_bit(unsigned w, int k) {
    int pos = 0;
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) {
        const unsigned low = w & ((1u << half) - 1u);
        const int c = __popc(low);
        if (k >= c) k -= c, w >>= half, pos += half;
        else w = low;
    }
    return pos;
}

// all threads: the copies that bring tile j (meta m, hit mask h) to st;
// the twister holds `size` elements.  Copy i is a header chunk, an entry
// chunk, or chunk i % CHUNKS of the (i / CHUNKS)-th hit row; the chunks
// past the twister's end are zero-filled.
template <typename Tw>
__device__ __forceinline__ void fill(unsigned char* st, int j, int4 m, int4 h,
                                     const int2* __restrict__ ent, const int* __restrict__ hdr,
                                     const Tw* __restrict__ twister, size_t size, int ld,
                                     int col0) {
    constexpr int PER = Row<Tw>::PER_CHUNK, CHUNKS = Row<Tw>::CHUNKS;
    const int n_ent = staged_entries(m.y, m.z);
    int2* se = reinterpret_cast<int2*>(st + HDR_INTS * 4);
    Tw* rows = reinterpret_cast<Tw*>(st + HDR_INTS * 4 + n_ent * 8);
    const int e0 = m.z & ~1;
    const int n1 = HDR_CHUNKS + n_ent / 2;
    const int p1 = __popc(h.x), p2 = p1 + __popc(h.y), p3 = p2 + __popc(h.z);
    const int n2 = n1 + (p3 + __popc(h.w)) * CHUNKS;
    const size_t first = (size_t)m.x * R * ld + col0;  // twister[t R, col0]
    for (int i = threadIdx.x; i < n2; i += THREADS) {
        if (i < HDR_CHUNKS) {
            cp_async16(st + 16 * i, hdr + (size_t)j * HDR_INTS + 4 * i, 16);
        } else if (i < n1) {
            cp_async16(se + 2 * (i - HDR_CHUNKS), ent + e0 + 2 * (i - HDR_CHUNKS), 16);
        } else {
            const int c = i - n1, slot = c / CHUNKS, q = c - slot * CHUNKS;
            const int word = slot < p1 ? 0 : slot < p2 ? 1 : slot < p3 ? 2 : 3;
            const int r = 32 * word + nth_bit(word == 0 ? h.x : word == 1 ? h.y : word == 2 ? h.z : h.w,
                                              slot - (word == 0 ? 0 : word == 1 ? p1 : word == 2 ? p2 : p3));
            const size_t src = ((first + (size_t)r * ld) & ~(size_t)(PER - 1)) + PER * q;
            const int bytes =
                src + PER <= size ? 16 : src < size ? (int)((size - src) * sizeof(Tw)) : 0;
            cp_async16(rows + slot * Row<Tw>::STRIDE + PER * q, twister + (bytes ? src : 0), bytes);
        }
    }
}

// the lane's 4 columns of the staged row of entry a (lane_col), widened,
// times the count: a bf16 row's as one 8-byte word (its staged window
// starts at the row), an f32 row's 32 apart
template <typename Tw>
__device__ __forceinline__ void add_entry(float (&acc)[4], const Tw* rows, int2 a, int lane) {
    const float cf = __int_as_float(a.y);
    float v[4];
    if constexpr (WORD_READS<Tw>) {
        const uint2 w = reinterpret_cast<const uint2*>(rows + (a.x & 0xffff))[lane];
        widen4(w.x, w.y, v);
    } else {
        const Tw* x = rows + (a.x & 0xffff) + lane;
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = x[32 * k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(cf, v[k]));
}

// the entries [e, e1) of one read set into its sums, in order, two at a
// time
template <typename Tw>
__device__ __forceinline__ void add_read_set(float (&acc)[4], const int2* se, const Tw* rows,
                                             int e, int e1, int lane) {
    for (; e + 2 <= e1; e += 2) {
        const int2 a0 = se[e], a1 = se[e + 1];
        add_entry(acc, rows, a0, lane);
        add_entry(acc, rows, a1, lane);
    }
    if (e < e1) add_entry(acc, rows, se[e], lane);
}

// The accumulate's two regimes.  Where the pass's tiles that hold keys
// hold at most GATHER_TILE_ENTRIES entries on average (random reads at
// k = 16: 108, about one entry a hit row; real reads at k = 16: 225),
// staging buys too little reuse for its ring's turn a tile, and the pass
// takes bag_gather; else bag_accumulate (random reads at k = 10: 424; real
// reads at k = 10: 632).  Both are launched; the one not chosen returns at
// once.  Both add the same products in the same order, so the choice
// never changes a bit of the result.
constexpr int GATHER_TILE_ENTRIES = 300;

__device__ __forceinline__ bool gather_regime(const int* __restrict__ entries,
                                              const int* __restrict__ n_nz) {
    return (long long)*entries <= (long long)GATHER_TILE_ENTRIES * *n_nz;
}

// grid (ceil(d / COLS), S); dynamic shared memory MBAR_BYTES + RING_BYTES.
// Block (y, s) walks slice s's tiles in order.  Before each tile, its
// threads issue the copies of every next tile that fits in the ring (up
// to SLOTS in flight), each thread arriving on the tile's barrier when its
// copies have landed; a tile takes what it needs, so a dense tile's
// entries and a sparse tile's few rows cost only their bytes.  Warp w
// keeps the sums of read sets 4 w .. 4 w + 3 over the lane's columns of
// block y (lane_col) in registers.
template <typename Tw>
__global__ void __launch_bounds__(THREADS, 1)
bag_accumulate(const int4* __restrict__ meta, const int4* __restrict__ hit,
               const int* __restrict__ hdr, const int* __restrict__ kbase,
               const int* __restrict__ n_nz, const int2* __restrict__ ent,
               const int* __restrict__ entries, const Tw* __restrict__ twister, int V, int d,
               int ld, int B, float* __restrict__ ws) {
    if (gather_regime(entries, n_nz)) return;
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    unsigned char* ring = smem + MBAR_BYTES;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int col0 = blockIdx.x * COLS;
    const int S = gridDim.y, s = blockIdx.y;
    const int n = *n_nz;
    const int j0 = slice_start(kbase, n, S, s), j1 = slice_start(kbase, n, S, s + 1);
    const size_t size = (size_t)(V - 1) * ld + d;  // the twister's elements, to its last
    if (threadIdx.x < SLOTS) mbar_init(full + threadIdx.x, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
    // the ring: where each tile in flight starts, and the bytes it holds
    // with the padding before it; every thread keeps the same account
    int start[SLOTS], span[SLOTS];
    int head = 0, used = 0, jf = j0;
    // the meta of tiles jf and jf + 1, loaded a tile ahead of their use
    int4 mf = make_int4(0, 0, 0, 0), hf = mf, mn = mf, hn = mf;
    if (jf < j1) mf = meta[jf], hf = hit[jf];
    if (jf + 1 < j1) mn = meta[jf + 1], hn = hit[jf + 1];
    for (int j = j0; j < j1; ++j) {
        const int i = j - j0;
        while (jf < j1 && jf - j < SLOTS) {
            if (used == 0) head = 0;
            const int z = tile_bytes<Tw>(mf, hf);
            const bool wrap = head + z > RING_BYTES;  // skip the ring's end
            const int pad = wrap ? RING_BYTES - head : 0;
            if (used + pad + z > RING_BYTES) break;
            const int at = wrap ? 0 : head, slot = (jf - j0) % SLOTS;
            fill(ring + at, jf, mf, hf, ent, hdr, twister, size, ld, col0);
            cp_async_arrive(full + slot);
            start[slot] = at;
            span[slot] = pad + z;
            head = at + z;
            used += pad + z;
            mf = mn, hf = hn;
            if (++jf + 1 < j1) mn = meta[jf + 1], hn = hit[jf + 1];
        }
        mbar_wait(full + i % SLOTS, (i / SLOTS) & 1);
        const unsigned char* st = ring + start[i % SLOTS];
        const int* h = reinterpret_cast<const int*>(st);
        const int sh = h[1], total = h[4 + GROUP];
        const int2* se = reinterpret_cast<const int2*>(st + HDR_INTS * 4) + sh;
        const Tw* rows =
            reinterpret_cast<const Tw*>(st + HDR_INTS * 4 + staged_entries(total, sh) * 8);
#pragma unroll
        for (int bi = 0; bi < 4; ++bi) {
            const int b = 4 * w + bi;
            add_read_set(acc[bi], se, rows, h[4 + b], h[5 + b], lane);
        }
        used -= span[i % SLOTS];
        __syncthreads();
    }
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
        const int b = 4 * w + bi;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int g = col0 + lane_col<Tw>(lane, k);
            if (b < B && g < d) ws[((size_t)s * B + b) * d + g] = acc[bi][k];
        }
    }
}

// 4 bf16 from the 8-byte word at element w (a multiple of 4), 0 past the
// twister's `size` elements
__device__ __forceinline__ uint2 bf16_word(const uint16_t* __restrict__ twister, size_t w,
                                           size_t size) {
    if (w + 4 <= size) return __ldg(reinterpret_cast<const uint2*>(twister + w));
    unsigned h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = w + k < size ? __ldg(twister + w + k) : 0u;
    return make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}

// The gather's read of the bf16 row slices that start at twister[at[u]]
// (at = v ld + col0, a multiple of 8) for the N entries in flight,
// widened, into the lane's 4 consecutive columns: its 8-byte word at at +
// 4 l, 0 where there is no entry (ok[u], the warp's) or past the row.
// Every load is issued before any is used.
template <int N>
__device__ __forceinline__ void read_rows(float (&x)[N][4], const uint16_t* __restrict__ twister,
                                          size_t size, const size_t (&at)[N],
                                          const bool (&ok)[N], const bool (&in_row)[4],
                                          int lane) {
    uint2 w[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
        const size_t at_l = at[u] + 4 * (size_t)lane;
        w[u] = !ok[u] ? make_uint2(0, 0)
               : at[u] + 4 * 32 <= size  // the warp's words lie inside
                   ? __ldg(reinterpret_cast<const uint2*>(twister + at_l))
                   : bf16_word(twister, at_l, size);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
        float v[4];
        widen4(w[u].x, w[u].y, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) x[u][k] = ok[u] && in_row[k] ? v[k] : 0.0f;
    }
}

// tiles whose headers a warp reads at once (a lane a tile and read set),
// and entries whose rows it has in flight at once
constexpr int GATHER_TILES = 8;
constexpr int GATHER_AHEAD = 2;
static_assert(GATHER_TILES * 4 == 32, "a lane a (tile, read set) of the warp");

// The gather regime: the grid, the slices and the owners of bag_accumulate
// (warp w: read sets 4 w .. 4 w + 3 over the lane's columns of block y), no
// shared memory and no barrier.  Each warp walks its slice's tiles
// GATHER_TILES at a time: lane 4 g + q reads the entry range of read set
// 4 w + q in tile g, the warp fetches the 32 next entries of those ranges
// (tile order, then entry order, for each read set) a lane each, and then
// reads their twister rows straight from global memory, GATHER_AHEAD
// entries' rows in flight, and adds count x row to the owner's sums in
// entry order: the products and the order of bag_accumulate.
template <typename Tw>
__global__ void __launch_bounds__(THREADS, 1)
bag_gather(const int4* __restrict__ meta, const int* __restrict__ hdr,
           const int* __restrict__ kbase, const int* __restrict__ n_nz,
           const int2* __restrict__ ent, const int* __restrict__ entries,
           const Tw* __restrict__ twister, int V, int d, int ld, int B,
           float* __restrict__ ws) {
    if (!gather_regime(entries, n_nz)) return;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int col0 = blockIdx.x * COLS;
    const int S = gridDim.y, s = blockIdx.y;
    const int n = *n_nz;
    const int j0 = slice_start(kbase, n, S, s), j1 = slice_start(kbase, n, S, s + 1);
    const size_t size = (size_t)(V - 1) * ld + d;  // the twister's elements, to its last
    bool in_row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) in_row[k] = col0 + lane_col<Tw>(lane, k) < d;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
    for (int jg = j0; jg < j1; jg += GATHER_TILES) {
        const int j = jg + (lane >> 2);
        int e = 0, count = 0, row0 = 0;
        if (j < j1) {
            const int4 m = meta[j];
            const int* h = hdr + (size_t)j * HDR_INTS + 4 + 4 * w + (lane & 3);
            e = m.z + h[0];
            count = h[1] - h[0];
            row0 = m.x * R;
        }
        int incl = count;  // entries of the lanes up to this one
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        for (int i0 = 0; i0 < total; i0 += 32) {
            // entry i0 + lane lies in the range of the first lane whose
            // running total exceeds it
            const int i = i0 + lane;
            int owner = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1)
                if (__shfl_sync(FULL, incl, owner + step - 1) <= i) owner += step;
            owner = min(owner, 31);
            const int first = __shfl_sync(FULL, e, owner) - __shfl_sync(FULL, incl - count, owner);
            const int tile_row0 = __shfl_sync(FULL, row0, owner);
            int2 a = make_int2(0, 0);
            if (i < total) a = ent[first + i];
            const int v = tile_row0 + (a.x >> 16);
            // each read set's entries of the 32, in lane order, GATHER_AHEAD
            // rows in flight at once
#pragma unroll
            for (int bi = 0; bi < 4; ++bi) {
                unsigned mine = __ballot_sync(FULL, i < total && (owner & 3) == bi);
                while (mine) {
                    int us[GATHER_AHEAD];
#pragma unroll
                    for (int u = 0; u < GATHER_AHEAD; ++u) {
                        us[u] = mine ? __ffs(mine) - 1 : -1;
                        mine &= mine - 1;
                    }
                    float x[GATHER_AHEAD][4];
                    if constexpr (WORD_READS<Tw>) {
                        size_t at[GATHER_AHEAD];
                        bool ok[GATHER_AHEAD];
#pragma unroll
                        for (int u = 0; u < GATHER_AHEAD; ++u) {
                            at[u] = (size_t)__shfl_sync(FULL, v, us[u] & 31) * ld + col0;
                            ok[u] = us[u] >= 0;
                        }
                        read_rows(x, twister, size, at, ok, in_row, lane);
                    } else {
#pragma unroll
                        for (int u = 0; u < GATHER_AHEAD; ++u) {
                            const Tw* src = twister + (size_t)__shfl_sync(FULL, v, us[u] & 31) * ld +
                                            col0 + lane;
#pragma unroll
                            for (int k = 0; k < 4; ++k)
                                x[u][k] = us[u] >= 0 && in_row[k] ? __ldg(src + 32 * k) : 0.0f;
                        }
                    }
#pragma unroll
                    for (int u = 0; u < GATHER_AHEAD; ++u) {
                        const float cf = __int_as_float(__shfl_sync(FULL, a.y, us[u] & 31));
                        if (us[u] >= 0)
#pragma unroll
                            for (int k = 0; k < 4; ++k)
                                acc[bi][k] = __fadd_rn(acc[bi][k], __fmul_rn(cf, x[u][k]));
                    }
                }
            }
        }
    }
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
        const int b = 4 * w + bi;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int g = col0 + lane_col<Tw>(lane, k);
            if (b < B && g < d) ws[((size_t)s * B + b) * d + g] = acc[bi][k];
        }
    }
}

// ---- 4. slice sum -----------------------------------------------------

// out[b, c] = sum over slices in order of ws[j, b, c], over n_known[b]
__global__ void bag_slice_sum(const float* __restrict__ ws, int S, int B, int d,
                              const int* __restrict__ n_known, int normalize,
                              float* __restrict__ out) {
    const size_t n = (size_t)B * d;
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        float sum = ws[i];
        for (int j = 1; j < S; ++j) sum = __fadd_rn(sum, ws[(size_t)j * n + i]);
        if (normalize) {
            const int nk = n_known[i / d];
            sum = (float)((double)sum / (double)(nk > 0 ? nk : 1));
        }
        out[i] = sum;
    }
}

// One launch for a batch of B read sets, in groups of GROUP.  S: vocabulary
// slices.  iwork holds, with T = ceil(V / R) and N = min(B, GROUP)
// (L - k + 1): meta 4 T, hit 4 T, hdr HDR_INTS T, the counters and
// cursors CNT T, the entries 2 N + 2 (the windows' rows first), keys N, nz
// T, kbase T + 1, the tile totals T, n_known GROUP, n_nz 1 and the pass's
// entries 1 int; fwork S min(B, GROUP) d floats.  The twister must start
// on 16 bytes; its row v starts at element v ld (ld >= d, a multiple of 8
// for bf16 rows).
template <class Wire, class Find, typename Tw>
int embedding_bag(const typename Wire::Byte* bases, const uint8_t* valid, int B, int L, int k,
                  int canonical, int base, const Find& find, int V, const Tw* twister, int d,
                  int ld, int normalize, int S, int* iwork, float* fwork, float* out,
                  void* stream) {
    if (B <= 0 || d <= 0) return (int)cudaGetLastError();
    if (L < k || V <= 0 || S <= 0 || S > 65535 || ld < d || (WORD_READS<Tw> && ld % 8) ||
        reinterpret_cast<uintptr_t>(twister) % 16 || reinterpret_cast<uintptr_t>(iwork) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int W = L - k + 1;
    const int T = (V + R - 1) / R;
    const int Bmax = B < GROUP ? B : GROUP;
    const size_t N = (size_t)Bmax * W;
    int4* meta = reinterpret_cast<int4*>(iwork);
    int4* hit = meta + T;
    int* hdr = reinterpret_cast<int*>(hit + T);
    int* bkt = hdr + (size_t)HDR_INTS * T;
    int* vt = bkt + (size_t)CNT * T;
    int2* ent = reinterpret_cast<int2*>(vt);
    int* keys = vt + 2 * N + 2;
    int* nz = keys + N;
    int* kbase = nz + T;
    int* tot = kbase + T + 1;
    int* n_known = tot + T;
    int* n_nz = n_known + GROUP;
    int* entries = n_nz + 1;
    const size_t acc_smem = MBAR_BYTES + RING_BYTES;
    const bool narrow = W <= NARROW_MAX;
    auto compact = narrow ? bag_compact<true, Tw> : bag_compact<false, Tw>;
    const int compact_smem = Bmax * R * (narrow ? 2 : 4);
    cudaError_t err = cudaFuncSetAttribute(
        bag_accumulate<Tw>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)acc_smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(compact, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   compact_smem);
    // the compact: one wave, every SM's resident blocks
    int dev = 0, sms = 132, per_sm = 1;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact, COMPACT_THREADS,
                                                            compact_smem);
    if (err != cudaSuccess) return (int)err;
    const int hist_blocks = (W + HIST_WINDOWS - 1) / HIST_WINDOWS;
    const dim3 acc_grid((d + COLS - 1) / COLS, S);
    const int compact_blocks = T < max(1, per_sm) * sms ? T : max(1, per_sm) * sms;
    for (int g0 = 0; g0 < B; g0 += GROUP) {
        const int Bg = B - g0 < GROUP ? B - g0 : GROUP;
        const dim3 bgrid(hist_blocks, Bg);
        if ((err = cudaMemsetAsync(bkt, 0, (size_t)CNT * T * 4, st)) != cudaSuccess) return (int)err;
        if ((err = cudaMemsetAsync(n_known, 0, (GROUP + 2) * 4, st)) != cudaSuccess) return (int)err;
        bag_histogram<Wire, Find><<<bgrid, HIST_THREADS, 0, st>>>(
            bases + g0 * Wire::base_stride(L), valid + g0 * Wire::valid_stride(L), L, k, canonical,
            base, find, V, vt, bkt, n_known);
        const int tile_blocks = (T + 255) / 256;
        bag_tile_sums<<<tile_blocks, 256, 0, st>>>(bkt, T, tot);
        bag_scan<<<1, SCAN_THREADS, 0, st>>>(tot, nz, kbase, n_nz, T);
        bag_cursors<<<tile_blocks, 256, 0, st>>>(bkt, T, tot);
        bag_scatter<<<bgrid, HIST_THREADS, 0, st>>>(vt, W, V, bkt, keys);
        compact<<<compact_blocks, COMPACT_THREADS, compact_smem, st>>>(
            keys, nz, kbase, n_nz, Bg, ld, ent, meta, hit, hdr, entries);
        bag_accumulate<Tw><<<acc_grid, THREADS, acc_smem, st>>>(meta, hit, hdr, kbase, n_nz, ent,
                                                                entries, twister, V, d, ld, Bg,
                                                                fwork);
        bag_gather<Tw><<<acc_grid, THREADS, 0, st>>>(meta, hdr, kbase, n_nz, ent, entries,
                                                     twister, V, d, ld, Bg, fwork);
        const size_t n = (size_t)Bg * d;
        const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
        bag_slice_sum<<<blocks, 256, 0, st>>>(fwork, S, Bg, d, n_known, normalize,
                                              out + (size_t)g0 * d);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

// the twister's row type: 0 f32, 1 bf16
template <class Wire, class Find>
int embedding_bag_rows(const typename Wire::Byte* bases, const uint8_t* valid, int B, int L,
                       int k, int canonical, int base, const Find& find, int V,
                       const void* twister, int row_type, int d, int ld, int normalize, int S,
                       int* iwork, float* fwork, float* out, void* stream) {
    switch (row_type) {
        case 0:
            return embedding_bag<Wire>(bases, valid, B, L, k, canonical, base, find, V,
                                       static_cast<const float*>(twister), d, ld, normalize, S,
                                       iwork, fwork, out, stream);
        case 1:
            return embedding_bag<Wire>(bases, valid, B, L, k, canonical, base, find, V,
                                       static_cast<const uint16_t*>(twister), d, ld, normalize, S,
                                       iwork, fwork, out, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// k up to lut_k_max: codes [B, L] int8; lut is the dense [base^k + 1]
// table
extern "C" int kpop_embedding_bag(const int8_t* codes, int B, int L, int k,
                                  int canonical, int base, const int32_t* lut,
                                  int V, const void* twister, int row_type, int d, int ld,
                                  int normalize, int S, int* iwork,
                                  float* fwork, float* out, void* stream) {
    return embedding_bag_rows<kpop::CodeWire>(codes, nullptr, B, L, k, canonical, base,
                                              kpop::LutFind{lut, V}, V, twister, row_type, d, ld,
                                              normalize, S, iwork, fwork, out, stream);
}

// larger k: the cuckoo hash's probe layout (ops/cuckoo.py::probe_table) of
// `slots` slots a table with its seeds, or (probe null) the sorted limbs
// [V] {hi, lo} (wide_lookup.cuh)
extern "C" int kpop_embedding_bag_wide(const int8_t* codes, int B, int L, int k, int canonical,
                                       int base, int k_lo, const int32_t* probe, int slots,
                                       uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2,
                                       const int32_t* limbs, int V,
                                       const void* twister, int row_type, int d, int ld,
                                       int normalize,
                                       int S, int* iwork, float* fwork, float* out,
                                       void* stream) {
    if (!kpop::wide_args_ok(k, probe, slots, limbs)) return (int)cudaErrorInvalidValue;
    return embedding_bag_rows<kpop::CodeWire>(
        codes, nullptr, B, L, k, canonical, base,
        kpop::wide_find(base, k_lo, probe, slots, a1, b1, a2, b2, limbs, V), V, twister, row_type,
        d, ld, normalize, S, iwork, fwork, out, stream);
}

// The same two on the 2-bit wire (DNA, base 4): packed [B, (L + 3) / 4]
// and valid [B, (L + 7) / 8] bytes in place of the codes
extern "C" int kpop_embedding_bag_packed(const uint8_t* packed, const uint8_t* valid, int B,
                                         int L, int k, int canonical, int base,
                                         const int32_t* lut, int V, const void* twister,
                                         int row_type, int d, int ld, int normalize, int S,
                                         int* iwork, float* fwork, float* out, void* stream) {
    if (base != 4) return (int)cudaErrorInvalidValue;
    return embedding_bag_rows<kpop::PackedWire>(packed, valid, B, L, k, canonical, base,
                                                kpop::LutFind{lut, V}, V, twister, row_type, d,
                                                ld, normalize, S, iwork, fwork, out, stream);
}

extern "C" int kpop_embedding_bag_wide_packed(const uint8_t* packed, const uint8_t* valid, int B,
                                              int L, int k, int canonical, int base, int k_lo,
                                              const int32_t* probe, int slots, uint32_t a1,
                                              uint32_t b1, uint32_t a2, uint32_t b2,
                                              const int32_t* limbs, int V, const void* twister,
                                              int row_type, int d, int ld, int normalize, int S,
                                              int* iwork, float* fwork, float* out,
                                              void* stream) {
    if (base != 4 || !kpop::wide_args_ok(k, probe, slots, limbs)) return (int)cudaErrorInvalidValue;
    return embedding_bag_rows<kpop::PackedWire>(
        packed, valid, B, L, k, canonical, base,
        kpop::wide_find(base, k_lo, probe, slots, a1, b1, a2, b2, limbs, V), V, twister, row_type,
        d, ld, normalize, S, iwork, fwork, out, stream);
}
