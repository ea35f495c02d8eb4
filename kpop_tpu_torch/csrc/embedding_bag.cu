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
// each part and each stage).
//
// The stages, per pass of up to GROUP read sets:
//
// 1. bucket.  bag_histogram computes each window's vocabulary row (window
//    code, then the LUT), keeps it, and counts the known windows per
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
//    memory, with a mask of the rows each read set hit, and writes them
//    back as entries {where the row sits among the tile's hit rows, count
//    as f32}, read set by read set and each in row order, with the tile's
//    hit-row mask.  It touches only the cells its keys hit.  Integer counts
//    do not depend on the order of the keys, so from here on everything is
//    deterministic.
// 3. accumulate.  Block (y, s) owns columns [COLS y, COLS y + COLS) of d
//    and the tiles of slice s: the slices split the tiles into S parts of
//    near-equal keys plus tiles.  It walks its tiles in order, the next
//    one in flight: every thread issues 16-byte cp.async copies of the
//    tile's header, entries and hit rows' column slices into a ring in
//    shared memory, so each hit row is read once, and a tile takes only the
//    bytes it needs (the densest, 16k entries and 128 rows, fits alone).
//    Warp w keeps the sums of read sets 4 w .. 4 w + 3 in registers, lane
//    l columns l + 32 k, and adds count x row[c] (one f32 product, one f32
//    add) for each read set's entries in entry order.  A (read set,
//    column) has one owner, so there are no atomics on floats.
// 4. slice sum.  Each block writes its [B, COLS] partial to an f32
//    workspace [S, B, d]; bag_slice_sum adds the slices in order and
//    divides by n_known, the read set's count of known windows.
//
// count x row is rounded once where a plain sum adds the row count times,
// so the result differs from the plain version in the last bits; the sum
// is the same from run to run.
//
// Large k (kpop_embedding_bag_wide): bag_histogram computes each window's
// code in uint64 and looks it up in the cuckoo hash or the sorted limbs of
// wide_lookup.cuh in place of the LUT; every later stage is the same.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_lookup.cuh"

namespace {

constexpr int COLS = 128;                // columns per accumulate block: lane + 32 k
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
constexpr int ROW_CHUNKS = COLS / 4 + 1;  // 16-byte chunks that hold a row's slice
constexpr int ROW_STRIDE = 4 * ROW_CHUNKS; // floats a staged row
constexpr int HDR_INTS = 4 + GROUP + 4;    // a tile's stage header, 16-byte padded
constexpr int HDR_CHUNKS = HDR_INTS / 4;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS / 32 * 4 == GROUP && COLS == 4 * 32, "accumulate block shape");
static_assert(COMPACT_THREADS >= GROUP && COMPACT_THREADS % 32 == 0, "compact block shape");
static_assert(HDR_INTS % 4 == 0, "a header is whole 16-byte chunks");
static_assert(CNT % 4 == 0 && R % SUB == 0 && R % 32 == 0, "a tile's counters are whole int4s");

// the offset of twister[v, col0] in its 16-byte aligned window (col0 is a
// multiple of 4)
__device__ __forceinline__ int row_shift(int v, int d, int col0) {
    return (int)(((unsigned)v * (unsigned)d + (unsigned)col0) & 3u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the vocabulary row of the window at s, V for a miss or a break; Find is
// kpop::LutFind (an int code, a dense table) or kpop::WideFind (a uint64
// code, the cuckoo hash or the sorted limbs; wide_lookup.cuh)
template <class Find>
__device__ __forceinline__ int window_row(const int8_t* s, int k, int canonical,
                                          int base, const Find& find, int V) {
    using Code = typename Find::Code;
    Code fwd = 0, rc = 0, mult = 1;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
        const int c = s[j];
        ok &= c >= 0 && c < base;  // no input indexes past the LUT
        fwd = fwd * base + c;
        rc += (Code)(3 - c) * mult;
        mult *= base;
    }
    return ok ? find(canonical && fwd > rc ? rc : fwd) : V;
}

// ---- 1. bucket --------------------------------------------------------

// grid (ceil(W / HIST_WINDOWS), B): each window's vocabulary row into vt
// (V for a miss), and the known windows per bucket of R / SUB rows and per
// read set.  Lanes that fall in one bucket pool their atomic (a read that
// repeats a k-mer sends every window to one bucket); buckets smaller than
// a tile spread the atomics over more counters.
template <class Find>
__global__ void __launch_bounds__(HIST_THREADS)
bag_histogram(const int8_t* __restrict__ codes, int L, int k, int canonical, int base,
              const Find find, int V, int* __restrict__ vt,
              int* __restrict__ hist, int* __restrict__ n_known) {
    __shared__ int block_known;
    const int b = blockIdx.y;
    const int W = L - k + 1;
    const int8_t* seq = codes + (size_t)b * L;
    const int w0 = (int)blockIdx.x * HIST_WINDOWS + (int)threadIdx.x;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) block_known = 0;
    int v[HIST_PER];
#pragma unroll
    for (int i = 0; i < HIST_PER; ++i) {
        const int w = w0 + i * HIST_THREADS;
        v[i] = w < W ? window_row(seq + w, k, canonical, base, find, V) : V;
    }
    __syncthreads();
    int known = 0;
#pragma unroll
    for (int i = 0; i < HIST_PER; ++i) {
        const int w = w0 + i * HIST_THREADS;
        if (w < W) vt[(size_t)b * W + w] = v[i];
        const int u = v[i] < V ? v[i] / (R / SUB) * COPIES + b % COPIES : -1;
        const unsigned peers = __match_any_sync(FULL, u);
        if (u >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[u], __popc(peers));
        known += u >= 0;
    }
    for (int o = 16; o > 0; o >>= 1) known += __shfl_xor_sync(FULL, known, o);
    if (lane == 0 && known) atomicAdd(&block_known, known);
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
// and the rows each read set hit -> entries {where row r sits among the
// tile's hit rows in the ring, count as f32}, read set by read set and
// each in row order, written over the tile's own key range of ent; meta[j]
// = {tile, entries, entry base}, hit[j] = the tile's hit-row mask, and
// hdr[j] = {tile, entry base & 1, entry base, 0, the first entry of each
// read set, entries} (HDR_INTS, the header the accumulate copies).  The
// counts are zeroed once, and after each tile only where its keys fell.
__global__ void __launch_bounds__(COMPACT_THREADS)
bag_compact(const int* __restrict__ keys, const int* __restrict__ nz,
            const int* __restrict__ kbase, const int* __restrict__ n_nz, int B, int d,
            int2* __restrict__ ent, int4* __restrict__ meta, int4* __restrict__ hit,
            int* __restrict__ hdr) {
    extern __shared__ int cnt[];  // [B, R]
    __shared__ unsigned rows_of[GROUP][WORDS];
    __shared__ int nb[GROUP + 1];
    __shared__ unsigned hits[WORDS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int n = *n_nz;
    for (int i = threadIdx.x; i < B * R; i += COMPACT_THREADS) cnt[i] = 0;
    for (int i = threadIdx.x; i < GROUP * WORDS; i += COMPACT_THREADS) rows_of[i / WORDS][i % WORDS] = 0;
    if (threadIdx.x < WORDS) hits[threadIdx.x] = 0;
    __syncthreads();
    for (int j = blockIdx.x; j < n; j += gridDim.x) {
        const int k0 = kbase[j], k1 = kbase[j + 1];
        const int t = nz[j];
        for (int i = k0 + threadIdx.x; i < k1; i += COMPACT_THREADS) {
            const int key = keys[i], b = key & 255, r = key >> 8;
            if (atomicAdd(&cnt[b * R + r], 1) == 0) atomicOr(&rows_of[b][r >> 5], 1u << (r & 31));
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
                        make_int2(slot * ROW_STRIDE + row_shift(t * R + r, d, 0),
                                  __float_as_int((float)cnt[b * R + r]));
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
        }
        __syncthreads();
        // zero what this tile touched
        for (int i = k0 + threadIdx.x; i < k1; i += COMPACT_THREADS) {
            const int key = keys[i];
            cnt[(key & 255) * R + (key >> 8)] = 0;
        }
        for (int i = threadIdx.x; i < GROUP * WORDS; i += COMPACT_THREADS) rows_of[i / WORDS][i % WORDS] = 0;
        if (threadIdx.x < WORDS) hits[threadIdx.x] = 0;
        __syncthreads();
    }
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
static_assert(HDR_INTS * 4 + (GROUP * R + 2) * 8 + R * ROW_STRIDE * 4 <= RING_BYTES,
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
// 16-byte aligned window, and its hit rows [hits, ROW_STRIDE] f32 in row
// order: hit row r holds the 16-byte aligned window of ROW_CHUNKS chunks
// that starts at or just before twister[v, col0], so column col0 + c sits
// at slot ROW_STRIDE + row_shift(v) + c.  Every part is a multiple of 16
// bytes.
__device__ __forceinline__ int tile_bytes(int4 m, int4 h) {
    const int hits = __popc(h.x) + __popc(h.y) + __popc(h.z) + __popc(h.w);
    return HDR_INTS * 4 + staged_entries(m.y, m.z) * 8 + hits * ROW_STRIDE * 4;
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
// the twister holds `size` floats.  Copy i is a header chunk, an entry
// chunk, or chunk i % ROW_CHUNKS of the (i / ROW_CHUNKS)-th hit row; the
// chunks past the twister's end are zero-filled.
__device__ __forceinline__ void fill(unsigned char* st, int j, int4 m, int4 h,
                                     const int2* __restrict__ ent, const int* __restrict__ hdr,
                                     const float* __restrict__ twister, size_t size, int d,
                                     int col0) {
    const int n_ent = staged_entries(m.y, m.z);
    int2* se = reinterpret_cast<int2*>(st + HDR_INTS * 4);
    float* rows = reinterpret_cast<float*>(st + HDR_INTS * 4 + n_ent * 8);
    const int e0 = m.z & ~1;
    const int n1 = HDR_CHUNKS + n_ent / 2;
    const int p1 = __popc(h.x), p2 = p1 + __popc(h.y), p3 = p2 + __popc(h.z);
    const int n2 = n1 + (p3 + __popc(h.w)) * ROW_CHUNKS;
    const size_t first = (size_t)m.x * R * d + col0;  // twister[t R, col0]
    for (int i = threadIdx.x; i < n2; i += THREADS) {
        if (i < HDR_CHUNKS) {
            cp_async16(st + 16 * i, hdr + (size_t)j * HDR_INTS + 4 * i, 16);
        } else if (i < n1) {
            cp_async16(se + 2 * (i - HDR_CHUNKS), ent + e0 + 2 * (i - HDR_CHUNKS), 16);
        } else {
            const int c = i - n1, slot = c / ROW_CHUNKS, q = c - slot * ROW_CHUNKS;
            const int word = slot < p1 ? 0 : slot < p2 ? 1 : slot < p3 ? 2 : 3;
            const int r = 32 * word + nth_bit(word == 0 ? h.x : word == 1 ? h.y : word == 2 ? h.z : h.w,
                                              slot - (word == 0 ? 0 : word == 1 ? p1 : word == 2 ? p2 : p3));
            const size_t src = ((first + (size_t)r * d) & ~(size_t)3) + 4 * q;
            const int bytes = src + 4 <= size ? 16 : src < size ? (int)(size - src) * 4 : 0;
            cp_async16(rows + slot * ROW_STRIDE + 4 * q, twister + (bytes ? src : 0), bytes);
        }
    }
}

// the lane's 4 columns of the staged row at `off`, times the count
__device__ __forceinline__ void add_entry(float (&acc)[4], const float* rows, int2 a, int lane) {
    const float cf = __int_as_float(a.y);
    const float* x = rows + a.x + lane;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = x[32 * k];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(cf, v[k]));
}

// the entries [e, e1) of one read set into its sums, in order, two at a
// time
__device__ __forceinline__ void add_read_set(float (&acc)[4], const int2* se, const float* rows,
                                             int e, int e1, int lane) {
    for (; e + 2 <= e1; e += 2) {
        const int2 a0 = se[e], a1 = se[e + 1];
        add_entry(acc, rows, a0, lane);
        add_entry(acc, rows, a1, lane);
    }
    if (e < e1) add_entry(acc, rows, se[e], lane);
}

// grid (ceil(d / COLS), S); dynamic shared memory MBAR_BYTES + RING_BYTES.
// Block (y, s) walks slice s's tiles in order.  Before each tile, its
// threads issue the copies of every next tile that fits in the ring (up
// to SLOTS in flight), each thread arriving on the tile's barrier when its
// copies have landed; a tile takes what it needs, so a dense tile's
// entries and a sparse tile's few rows cost only their bytes.  Warp w
// keeps the sums of read sets 4 w .. 4 w + 3 over columns COLS y + lane +
// 32 k in registers.
__global__ void __launch_bounds__(THREADS, 1)
bag_accumulate(const int4* __restrict__ meta, const int4* __restrict__ hit,
               const int* __restrict__ hdr, const int* __restrict__ kbase,
               const int* __restrict__ n_nz, const int2* __restrict__ ent,
               const float* __restrict__ twister, int V, int d, int B,
               float* __restrict__ ws) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    unsigned char* ring = smem + MBAR_BYTES;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int col0 = blockIdx.x * COLS;
    const int S = gridDim.y, s = blockIdx.y;
    const int n = *n_nz;
    const int j0 = slice_start(kbase, n, S, s), j1 = slice_start(kbase, n, S, s + 1);
    const size_t size = (size_t)V * d;
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
            const int z = tile_bytes(mf, hf);
            const bool wrap = head + z > RING_BYTES;  // skip the ring's end
            const int pad = wrap ? RING_BYTES - head : 0;
            if (used + pad + z > RING_BYTES) break;
            const int at = wrap ? 0 : head, slot = (jf - j0) % SLOTS;
            fill(ring + at, jf, mf, hf, ent, hdr, twister, size, d, col0);
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
        const float* rows =
            reinterpret_cast<const float*>(st + HDR_INTS * 4 + staged_entries(total, sh) * 8);
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
            const int g = col0 + lane + 32 * k;
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
            sum = sum / (float)(nk > 0 ? nk : 1);
        }
        out[i] = sum;
    }
}

// One launch for a batch of B read sets, in groups of GROUP.  S: vocabulary
// slices.  iwork holds, with T = ceil(V / R) and N = min(B, GROUP)
// (L - k + 1): meta 4 T, hit 4 T, hdr HDR_INTS T, the counters and
// cursors CNT T, the entries 2 N + 2 (the windows' rows first), keys N, nz
// T, kbase T + 1, the tile totals T, n_known GROUP and n_nz 1 ints; fwork S
// min(B, GROUP) d floats.  The twister must start on 16 bytes.
template <class Find>
int embedding_bag(const int8_t* codes, int B, int L, int k, int canonical, int base,
                  const Find& find, int V, const float* twister, int d, int normalize, int S,
                  int* iwork, float* fwork, float* out, void* stream) {
    if (B <= 0 || d <= 0) return (int)cudaGetLastError();
    if (L < k || V <= 0 || S <= 0 || S > 65535 ||
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
    const size_t acc_smem = MBAR_BYTES + RING_BYTES;
    const size_t compact_smem = (size_t)Bmax * R * 4;
    cudaError_t err = cudaFuncSetAttribute(
        bag_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)acc_smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(bag_compact, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)compact_smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int hist_blocks = (W + HIST_WINDOWS - 1) / HIST_WINDOWS;
    const dim3 acc_grid((d + COLS - 1) / COLS, S);
    const int compact_blocks = T < 3 * sms ? T : 3 * sms;
    for (int g0 = 0; g0 < B; g0 += GROUP) {
        const int Bg = B - g0 < GROUP ? B - g0 : GROUP;
        const dim3 bgrid(hist_blocks, Bg);
        if ((err = cudaMemsetAsync(bkt, 0, (size_t)CNT * T * 4, st)) != cudaSuccess) return (int)err;
        if ((err = cudaMemsetAsync(n_known, 0, GROUP * 4, st)) != cudaSuccess) return (int)err;
        bag_histogram<Find><<<bgrid, HIST_THREADS, 0, st>>>(codes + (size_t)g0 * L, L, k,
                                                            canonical, base, find, V, vt, bkt,
                                                            n_known);
        const int tile_blocks = (T + 255) / 256;
        bag_tile_sums<<<tile_blocks, 256, 0, st>>>(bkt, T, tot);
        bag_scan<<<1, SCAN_THREADS, 0, st>>>(tot, nz, kbase, n_nz, T);
        bag_cursors<<<tile_blocks, 256, 0, st>>>(bkt, T, tot);
        bag_scatter<<<bgrid, HIST_THREADS, 0, st>>>(vt, W, V, bkt, keys);
        bag_compact<<<compact_blocks, COMPACT_THREADS, (size_t)Bg * R * 4, st>>>(
            keys, nz, kbase, n_nz, Bg, d, ent, meta, hit, hdr);
        bag_accumulate<<<acc_grid, THREADS, acc_smem, st>>>(meta, hit, hdr, kbase, n_nz, ent,
                                                            twister, V, d, Bg, fwork);
        const size_t n = (size_t)Bg * d;
        const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
        bag_slice_sum<<<blocks, 256, 0, st>>>(fwork, S, Bg, d, n_known, normalize,
                                              out + (size_t)g0 * d);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

}  // namespace

// k up to lut_k_max: lut is the dense [base^k + 1] table
extern "C" int kpop_embedding_bag(const int8_t* codes, int B, int L, int k,
                                  int canonical, int base, const int32_t* lut,
                                  int V, const float* twister, int d,
                                  int normalize, int S, int* iwork,
                                  float* fwork, float* out, void* stream) {
    return embedding_bag(codes, B, L, k, canonical, base, kpop::LutFind{lut, V}, V, twister, d,
                         normalize, S, iwork, fwork, out, stream);
}

// larger k: the cuckoo table [6, slots] with its seeds, or (cuckoo null)
// the sorted limbs vocab_hi, vocab_lo [V] (wide_lookup.cuh)
extern "C" int kpop_embedding_bag_wide(const int8_t* codes, int B, int L, int k, int canonical,
                                       int base, int k_lo, const int32_t* cuckoo, int slots,
                                       uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2,
                                       const int32_t* vocab_hi, const int32_t* vocab_lo, int V,
                                       const float* twister, int d, int normalize, int S,
                                       int* iwork, float* fwork, float* out, void* stream) {
    if (k > 32 || (!cuckoo && !(vocab_hi && vocab_lo)) || (cuckoo && (slots & (slots - 1))))
        return (int)cudaErrorInvalidValue;
    return embedding_bag(codes, B, L, k, canonical, base,
                         kpop::wide_find(base, k_lo, cuckoo, slots, a1, b1, a2, b2, vocab_hi,
                                         vocab_lo, V),
                         V, twister, d, normalize, S, iwork, fwork, out, stream);
}
