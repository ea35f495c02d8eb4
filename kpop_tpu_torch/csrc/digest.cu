// Row digest of a distance block: for each row of dmat [B, N], its mean,
// n-1 standard deviation, upper median, MAD and its k smallest entries with
// their column indices.
//
// Replaces the digest half of kpop_tpu/ops/summaries.py::_digest_batch,
// which XLA compiled on the TPU as a full sort of every row (median and the
// window MAD), a lax.top_k and the moment reductions.  A sort is not needed:
// the median, the MAD and the k-th smallest value are each one order
// statistic, so this kernel finds them by radix selection and never orders
// the row.
//
// What bounds it on the H100: a row is read many times (the moments, the
// digit passes of three order statistics, the compaction), so the bound is
// where those passes read from and how much each does, not the one read
// of the block from device memory (82 MB at 2048 x 10,000).  The design:
// - a row that fits in STAGE_MAX of shared memory (N up to 51,197) is
//   staged there once: its 16-byte aligned body by one bulk asynchronous
//   copy (cp.async.bulk, completing on an mbarrier), the at most 3 + 3
//   entries around it by plain loads, and turned into order keys in place
//   by the first moment pass.  Every later pass reads shared memory, 16
//   bytes a load.  Blocks are small (256 threads, about 45 KB at N =
//   10,000), so five share an SM and one row's copy overlaps the others'
//   passes.  Wider rows are streamed from device memory by blocks of 512
//   threads, with the same code;
// - passes are shared: the second moment pass also counts the first digit
//   of the median and k-th value selection, and the compaction's pass the
//   first digit of the MAD's.  The shared leading bits of a selection's
//   extreme keys are skipped, and the median and the k-th value share
//   their digit passes (and, for the first digit, one histogram);
// - later digits scan the whole row again: a version that listed each
//   selection's candidates in shared memory for its last digits measured
//   slower on the card;
// - one warp per selection scans the bins (8 a lane), picks the bin and
//   zeroes it for the next digit: two barriers a digit.  Lane l may count
//   into histogram copy l % COPIES (the copies one bank apart), against
//   the contention of a nearly constant leading digit, but one copy
//   measured fastest on the card (tools/probe_digest.py), so COPIES is 1;
// - for k <= K_MAX one ballot pass over a contiguous chunk a warp lists
//   the entries below the k-th value (slots from a shared counter) and
//   each warp's first ties to it; one warp then orders the k by (value,
//   column), one a lane, so the caller sorts nothing.  A larger k takes
//   two ballot passes (counts, then slots after one pass over the warp
//   counts) and lists the entries below the k-th value, then its ties,
//   each group in column order, for the caller's stable sort by value.
//
// Exactness:
// - the keys are the order-preserving u32 image of each float, with -0.0
//   taken as +0.0 and every NaN as the largest key, which is the order of
//   a stable torch.sort; values are returned from the keys, so a zero is
//   always +0.0 (printed "0", as the host float64 path prints it);
// - the MAD is the selection of rank N/2 among the float32 values
//   |d - median|.  Every candidate of the reference's window formula is one
//   of those values, so the two agree bit for bit.  They lie between 0 and
//   the larger deviation of the row's two extremes, since rounding is
//   monotone.  The reference's window always reaches the row's largest
//   entry, so a row that holds a NaN has a NaN MAD, here too;
// - the k smallest are the entries below the k-th value, then the entries
//   equal to it, lowest column first: the (value, column) order of the
//   reference's stable sort;
// - mean and the sum of squared deviations accumulate in float64, in a
//   fixed order, so the result does not change from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // a block of a row staged in shared memory
constexpr int WIDE_THREADS = 512;  // a block of a row streamed from device memory
constexpr int MAX_WARPS = WIDE_THREADS / 32;
constexpr int DIGIT_BITS = 8;
constexpr int BINS = 1 << DIGIT_BITS;
constexpr int COPIES = 1;       // histogram copies a selection; lane l counts into l % COPIES
constexpr int K_MAX = 32;       // k up to this is ordered here (DIGEST_K_MAX)
constexpr int STAGE_MAX = 200 * 1024;  // dynamic shared memory of a staged row
constexpr unsigned FULL = 0xffffffffu;
static_assert(BINS == 32 * 8, "one warp scans the bins, 8 a lane");
static_assert(K_MAX == 32, "one warp orders the k smallest, one a lane");

struct Shared {
    int hist[2][COPIES][BINS + 1];  // copies one bank apart
    double red[2][MAX_WARPS];
    uint32_t lo[MAX_WARPS], hi[MAX_WARPS];
    int warp_lt[MAX_WARPS], warp_eq[MAX_WARPS];
    int pick[2][2];  // a selection's digit and the keys below it
    uint32_t top_key[K_MAX];
    int top_col[K_MAX];
    int eq_col[MAX_WARPS][K_MAX];  // each warp's first ties to the k-th value
    int n_lt;                      // entries below the k-th value listed so far
    uint64_t landed;               // the row's bulk copy
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* mbar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(mbar)), "r"(count)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// bytes (a multiple of 16, both ends on 16 bytes) from global to shared
// memory by the copy engine, completing on the mbarrier, which expects them
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* mbar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(mbar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(mbar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* mbar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(mbar)), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t order_key(float f) {
    if (f != f) return 0xffffffffu;  // NaN: last
    uint32_t u = __float_as_uint(f);
    if (u == 0x80000000u) u = 0u;  // -0.0 is +0.0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
    return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A row as order keys staged in shared memory, keys + head on 16 bytes;
// a pass may replace the keys (set)
struct StagedRow {
    static constexpr bool WRITABLE = true;
    uint32_t* keys;
    int N, head;
    __device__ uint32_t key(int i) const { return keys[i]; }
    __device__ void set(int i, uint32_t kx) const { keys[i] = kx; }
    // the keys of entries head + 4q .. head + 4q + 3
    __device__ void quad(int q, uint32_t (&kx)[4]) const {
        const uint4 v = reinterpret_cast<const uint4*>(keys + head)[q];
        kx[0] = v.x;
        kx[1] = v.y;
        kx[2] = v.z;
        kx[3] = v.w;
    }
    // f(i, key) for every entry, the aligned body 16 bytes a load
    template <int NT, class F>
    __device__ void for_each(F f) const {
        const int quads = (N - head) >> 2;
        if ((int)threadIdx.x < head) f(threadIdx.x, keys[threadIdx.x]);
        const uint4* body = reinterpret_cast<const uint4*>(keys + head);
        for (int q = threadIdx.x; q < quads; q += NT) {
            const uint4 v = body[q];
            const int i = head + 4 * q;
            f(i, v.x);
            f(i + 1, v.y);
            f(i + 2, v.z);
            f(i + 3, v.w);
        }
        const int t = head + 4 * quads + threadIdx.x;
        if (t < N) f(t, keys[t]);
    }
};

// A row read from device memory on every pass
struct StreamedRow {
    static constexpr bool WRITABLE = false;
    static constexpr int head = 0;
    const float* row;
    int N;
    __device__ uint32_t key(int i) const { return order_key(row[i]); }
    __device__ void set(int, uint32_t) const {}
    __device__ void quad(int q, uint32_t (&kx)[4]) const {
#pragma unroll
        for (int j = 0; j < 4; ++j) kx[j] = key(4 * q + j);
    }
    template <int NT, class F>
    __device__ void for_each(F f) const {
        for (int i = threadIdx.x; i < N; i += NT) f(i, order_key(row[i]));
    }
};

// The selection key of an entry, from its order key: itself, or the key
// of its deviation from the median
struct ValueKey {
    __device__ uint32_t operator()(uint32_t kx) const { return kx; }
};

struct DeviationKey {
    float median;
    __device__ uint32_t operator()(uint32_t kx) const {
        return order_key(fabsf(key_value(kx) - median));
    }
};

// The bits below the leading ones that every key in [lo, hi] shares
__device__ __forceinline__ int low_bits(uint32_t lo, uint32_t hi) {
    return lo == hi ? 0 : 32 - __clz(lo ^ hi);
}

// The first digit of a selection over keys in [lo, hi]: every key is a
// candidate, so a pass that reads the row anyway counts it
struct FirstDigit {
    int low;        // the digit is bits [low, low + bits)
    uint32_t mask;  // 0 when there is no digit
    __device__ explicit FirstDigit(uint32_t lo, uint32_t hi) {
        const int lb = low_bits(lo, hi);
        low = lb - min(DIGIT_BITS, lb);
        mask = (1u << (lb - low)) - 1u;
    }
    __device__ void count(uint32_t kx, Shared& sh) const {
        if (mask) atomicAdd(&sh.hist[0][(threadIdx.x & 31) % COPIES][(kx >> low) & mask], 1);
    }
};

// Warp-wide: lane l's bins 8l..8l+7 of a selection's histogram, summed
// over the copies and zeroed; returns their total and sets `below` to the
// count of the bins before them
__device__ __forceinline__ int take_bins(int (&hist)[COPIES][BINS + 1], int (&c)[8], int& below) {
    const int lane = threadIdx.x & 31;
    int t = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int b = lane * 8 + j;
        int v = 0;
#pragma unroll
        for (int cp = 0; cp < COPIES; ++cp) {
            v += hist[cp][b];
            hist[cp][b] = 0;
        }
        c[j] = v;
        t += v;
    }
    int x = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    below = x - t;
    return t;
}

// The lane whose bins hold rank rs writes the bin and the count below it
__device__ __forceinline__ void pick_bin(const int (&c)[8], int below, int t, int rs,
                                         int (&pick)[2]) {
    if (below <= rs && rs < below + t) {  // exactly one lane holds rank rs
        bool done = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (!done && rs < below + c[j]) {
                pick[0] = (threadIdx.x & 31) * 8 + j;
                pick[1] = below;
                done = true;
            }
            below += c[j];
        }
    }
}

// The keys of ranks rank[s] (0-based, ascending) among key(k_i) over the
// row's entries, found together, most significant digit first, and the
// number of keys below each.  Every key lies in [lo, hi], so the leading
// bits those two share are known and skipped: the digits cover only the
// bits below them.  The first digit's counts are in histogram 0 on entry
// (FirstDigit, in an earlier pass, then a barrier), shared by the
// selections.  The histograms are left zero.
template <int NT, int NSEL, class Row, class Key>
__device__ void radix_select(const Row& row, Key key, uint32_t lo, uint32_t hi,
                             const int (&rank)[NSEL], uint32_t (&found)[NSEL],
                             int (&n_below)[NSEL], Shared& sh) {
    static_assert(NSEL <= 2 && NSEL <= NT / 32, "a warp scans each selection");
    const int warp = threadIdx.x >> 5;
    const int copy = (threadIdx.x & 31) % COPIES;
    const int lb = low_bits(lo, hi);
    uint32_t mask = lb == 32 ? 0u : ~((1u << lb) - 1u);
    uint32_t prefix[NSEL];
    int r[NSEL];
#pragma unroll
    for (int s = 0; s < NSEL; ++s) {
        prefix[s] = lo & mask;
        r[s] = rank[s];
    }
    for (int low = lb; low > 0;) {
        const int bits = min(DIGIT_BITS, low);
        const bool first = low == lb;
        low -= bits;  // this digit is bits [low, low + bits)
        const uint32_t digit = (1u << bits) - 1u;
        if (!first) {
            row.template for_each<NT>([=, &sh](int, uint32_t vk) {
                const uint32_t kx = key(vk);
#pragma unroll
                for (int s = 0; s < NSEL; ++s) {
                    if ((kx & mask) == prefix[s]) atomicAdd(&sh.hist[s][copy][(kx >> low) & digit], 1);
                }
            });
        }
        __syncthreads();
        if (warp < (first ? 1 : NSEL)) {  // warp s scans selection s
            int c[8], below;
            const int t = take_bins(sh.hist[warp], c, below);
            pick_bin(c, below, t, warp == 0 ? r[0] : r[NSEL - 1], sh.pick[warp]);
            if (first && NSEL > 1) pick_bin(c, below, t, r[NSEL - 1], sh.pick[NSEL - 1]);
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < NSEL; ++s) {
            prefix[s] |= (uint32_t)sh.pick[s][0] << low;
            r[s] -= sh.pick[s][1];
        }
        mask |= digit << low;
    }
#pragma unroll
    for (int s = 0; s < NSEL; ++s) {
        found[s] = prefix[s];
        n_below[s] = rank[s] - r[s];
    }
}

// The k smallest: the n_under entries whose keys lie below kth, then the
// first `ties` entries equal to it, each group by column; emit(slot, key,
// column) for each.  Each warp walks a contiguous chunk of the row twice:
// a ballot pass counts its entries (and calls each(i, key) for every entry),
// and after one pass over the warp counts a second ballot pass hands out
// the slots.
template <int NT, class Row, class Emit, class Each>
__device__ void compact(const Row& row, uint32_t kth, int n_under, int ties, Emit emit,
                        Each each, Shared& sh) {
    constexpr int WARPS = NT / 32;
    const int N = row.N;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int chunk = ((N + WARPS - 1) / WARPS + 31) & ~31;
    const int i0 = warp * chunk, i1 = min(N, i0 + chunk);
    int n_lt = 0, n_eq = 0;
    for (int base = i0; base < i1; base += 32) {
        const int i = base + lane;
        const uint32_t kx = i < i1 ? row.key(i) : 0xffffffffu;
        if (i < i1) each(i, kx);
        n_lt += __popc(__ballot_sync(FULL, i < i1 && kx < kth));
        n_eq += __popc(__ballot_sync(FULL, i < i1 && kx == kth));
    }
    if (lane == 0) {
        sh.warp_lt[warp] = n_lt;
        sh.warp_eq[warp] = n_eq;
    }
    __syncthreads();
    n_lt = n_eq = 0;
    for (int w = 0; w < warp; ++w) {
        n_lt += sh.warp_lt[w];
        n_eq += sh.warp_eq[w];
    }
    const unsigned before = (1u << lane) - 1u;
    for (int base = i0; base < i1 && (n_lt < n_under || n_eq < ties); base += 32) {
        const int i = base + lane;
        const uint32_t kx = i < i1 ? row.key(i) : 0xffffffffu;
        const bool lt = i < i1 && kx < kth, eq = i < i1 && kx == kth;
        const unsigned m_lt = __ballot_sync(FULL, lt), m_eq = __ballot_sync(FULL, eq);
        if (lt) {
            emit(n_lt + __popc(m_lt & before), kx, i);
        } else if (eq) {
            const int t = n_eq + __popc(m_eq & before);
            if (t < ties) emit(n_under + t, kx, i);
        }
        n_lt += __popc(m_lt);
        n_eq += __popc(m_eq);
    }
}

// Warp-wide exclusive prefix sum of v over the lanes; `total` gets the sum
__device__ __forceinline__ int warp_scan(int v, int& total) {
    const int lane = threadIdx.x & 31;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    total = __shfl_sync(FULL, x, 31);
    return x - v;
}

// The k <= K_MAX smallest into sh.top_key / sh.top_col in one pass: the
// entries below kth take slots from a shared counter (the warp that orders
// the list sorts them), and each warp keeps the first `ties` entries equal
// to kth of its chunk; after one barrier the lowest `ties` columns of those
// fill the slots from n_under on.  A lane reads 4 consecutive entries (a
// quad) at a time, warp w a contiguous run of quads; warp 0 first takes
// the head entries before the first quad, the last warp last the tail
// after the last one, so each warp's entries are in column order.  each(i,
// key) is called for every entry once its key is read.  sh.n_lt is 0 on
// entry.
template <int NT, class Row, class Each>
__device__ void compact_small(const Row& row, uint32_t kth, int n_under, int ties, Each each,
                              Shared& sh) {
    constexpr int WARPS = NT / 32;
    const int N = row.N, head = row.head;
    const int quads = (N - head) >> 2, tail0 = head + 4 * quads;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per_warp = ((quads + WARPS - 1) / WARPS + 31) & ~31;
    const int q0 = warp * per_warp, q1 = min(quads, q0 + per_warp);
    int n_eq = 0;
    // the m <= 4 entries of a lane, columns col..col+m-1, every lane of the warp
    auto step = [&](const uint32_t (&kx)[4], int col, int m) {
        int lt = 0, eq = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < m) {
                each(col + j, kx[j]);
                lt += kx[j] < kth;
                eq += kx[j] == kth;
            }
        }
        if (__any_sync(FULL, lt)) {  // rare: at most k - 1 in the row
            int total, slot = warp_scan(lt, total);
            int base = 0;
            if (lane == 0) base = atomicAdd(&sh.n_lt, total);
            slot += __shfl_sync(FULL, base, 0);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < m && kx[j] < kth) {
                    sh.top_key[slot] = kx[j];
                    sh.top_col[slot] = col + j;
                    ++slot;
                }
            }
        }
        if (n_eq < ties && __any_sync(FULL, eq)) {
            int total, t = n_eq + warp_scan(eq, total);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < m && kx[j] == kth) {
                    if (t < ties) sh.eq_col[warp][t] = col + j;
                    ++t;
                }
            }
            n_eq += total;
        }
    };
    uint32_t kx[4] = {0u, 0u, 0u, 0u};
    if (warp == 0) {
        kx[0] = lane < head ? row.key(lane) : 0u;
        step(kx, lane, lane < head ? 1 : 0);
    }
    for (int qb = q0; qb < q1; qb += 32) {
        const int q = qb + lane;
        const bool ok = q < q1;
        row.quad(ok ? q : q0, kx);
        step(kx, head + 4 * q, ok ? 4 : 0);
    }
    if (warp == WARPS - 1) {
        const int t = tail0 + lane;
        kx[0] = t < N ? row.key(t) : 0u;
        step(kx, t, t < N ? 1 : 0);
    }
    if (lane == 0) sh.warp_eq[warp] = min(n_eq, ties);
    __syncthreads();
    if (warp == 0 && lane < ties) {  // the lane-th tie in column order
        int t = lane;
        for (int w = 0; w < WARPS; ++w) {
            if (t < sh.warp_eq[w]) {
                sh.top_key[n_under + lane] = kth;
                sh.top_col[n_under + lane] = sh.eq_col[w][t];
                break;
            }
            t -= sh.warp_eq[w];
        }
    }
}

struct ToGlobal {
    float* top;
    int64_t* idx;
    __device__ void operator()(int slot, uint32_t kx, int col) const {
        top[slot] = key_value(kx);
        idx[slot] = col;
    }
};

// Everything after the first pass over the row, which gave each thread its
// sum s and extreme keys lo, hi
template <int NT, class Row>
__device__ void digest_row(const Row& row, int k, double s, uint32_t lo, uint32_t hi,
                           float* stats, float* top, int64_t* idx, Shared& sh) {
    constexpr int WARPS = NT / 32;
    const int N = row.N;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the mean and the extreme keys: warp totals, one barrier, then every
    // thread adds them in warp order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if (lane == 0) {
        sh.red[0][warp] = s;
        sh.lo[warp] = lo;
        sh.hi[warp] = hi;
    }
    __syncthreads();  // also publishes a staged row's keys
    s = 0.0;
    for (int w = 0; w < WARPS; ++w) {
        s += sh.red[0][w];
        lo = min(lo, sh.lo[w]);
        hi = max(hi, sh.hi[w]);
    }
    const double mean = s / N;
    // the second moment pass also counts the first digit of the median
    // and k-th value selection
    const FirstDigit value_digit(lo, hi);
    double q = 0.0;
    row.template for_each<NT>([&](int, uint32_t kx) {
        const double d = key_value(kx) - mean;
        q += d * d;
        value_digit.count(kx, sh);
    });
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(FULL, q, o);
    if (lane == 0) sh.red[1][warp] = q;
    __syncthreads();
    double m2 = 0.0;
    for (int w = 0; w < WARPS; ++w) m2 += sh.red[1][w];

    // the upper median (rank N/2) and the k-th smallest (rank k-1) together
    const int ranks[2] = {N / 2, k - 1};
    uint32_t found[2];
    int below[2];
    radix_select<NT>(row, ValueKey{}, lo, hi, ranks, found, below, sh);
    const float median = key_value(found[0]);
    const uint32_t kth = found[1];
    // the MAD: rank N/2 of |d - median|, which lie in [0, the larger
    // deviation of the row's extremes] (rounding is monotone).  Its first
    // digit is counted by the compaction's pass over the row, which, for a
    // staged row and k <= K_MAX, also replaces each key by its deviation's
    // (the row's values are not read again)
    const DeviationKey deviation{median};
    const uint32_t spread = max(deviation(hi), deviation(lo));
    const FirstDigit mad_digit(order_key(0.0f), spread);
    const bool replace = Row::WRITABLE && k <= K_MAX;
    auto count_deviation = [&](int i, uint32_t kx) {
        const uint32_t dk = deviation(kx);
        mad_digit.count(dk, sh);
        if (replace) row.set(i, dk);
    };

    const int n_under = below[1];
    float* top_row = top + (size_t)blockIdx.x * k;
    int64_t* idx_row = idx + (size_t)blockIdx.x * k;
    if (k <= K_MAX) {
        compact_small<NT>(row, kth, n_under, k - n_under, count_deviation, sh);
    } else {
        compact<NT>(row, kth, n_under, k - n_under, ToGlobal{top_row, idx_row}, count_deviation,
                    sh);
    }
    __syncthreads();
    const int mad_rank[1] = {N / 2};
    uint32_t mad_key[1];
    int mad_below[1];
    if (replace) {
        radix_select<NT>(row, ValueKey{}, order_key(0.0f), spread, mad_rank, mad_key, mad_below,
                         sh);
    } else {
        radix_select<NT>(row, deviation, order_key(0.0f), spread, mad_rank, mad_key, mad_below, sh);
    }

    if (k <= K_MAX && warp == 0) {  // rank of each entry in (key, column) order
        const uint32_t kx = lane < k ? sh.top_key[lane] : 0xffffffffu;
        const int col = lane < k ? sh.top_col[lane] : 0x7fffffff;
        int rank = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const uint32_t kj = __shfl_sync(FULL, kx, j);
            const int cj = __shfl_sync(FULL, col, j);
            rank += j < k && (kj < kx || (kj == kx && cj < col));
        }
        if (lane < k) {
            top_row[rank] = key_value(kx);
            idx_row[rank] = col;
        }
    }

    if (threadIdx.x == 0) {
        float* st = stats + (size_t)blockIdx.x * 4;
        st[0] = (float)mean;
        st[1] = (float)sqrt(m2 / (double)max(N - 1, 1));
        st[2] = median;
        st[3] = hi == 0xffffffffu ? key_value(hi) : key_value(mad_key[0]);
    }
}

__device__ void zero_hist(Shared& sh, int nt) {
    for (int i = threadIdx.x; i < 2 * COPIES * (BINS + 1); i += nt) (&sh.hist[0][0][0])[i] = 0;
    if (threadIdx.x == 0) sh.n_lt = 0;
}

// One block a row, the row staged in dynamic shared memory
__global__ void __launch_bounds__(THREADS)
row_digest_staged(const float* __restrict__ dmat, int N, int k, float* __restrict__ stats,
                  float* __restrict__ top, int64_t* __restrict__ idx) {
    __shared__ Shared sh;
    extern __shared__ __align__(16) uint32_t staged[];
    const float* row = dmat + (size_t)blockIdx.x * N;
    // row entry i at keys[i], with keys + head on 16 bytes: the aligned
    // body in one bulk copy, the head and tail entries by plain loads
    const int head = min(N, (int)((16 - ((uintptr_t)row & 15)) & 15) / 4);
    const int body = (N - head) & ~3;
    uint32_t* keys = staged + ((4 - head) & 3);
    if (threadIdx.x == 0) mbar_init(&sh.landed, 1);
    zero_hist(sh, THREADS);
    __syncthreads();
    if (threadIdx.x == 0 && body > 0) bulk_copy(keys + head, row + head, body * 4, &sh.landed);
    if (threadIdx.x < N - body) {
        const int i = threadIdx.x < head ? threadIdx.x : body + threadIdx.x;
        keys[i] = __float_as_uint(row[i]);
    }
    if (body > 0) mbar_wait(&sh.landed, 0);
    __syncthreads();
    // the first moment pass turns the row into order keys in place
    double s = 0.0;
    uint32_t lo = 0xffffffffu, hi = 0u;
    auto to_key = [&](uint32_t& bits) {
        const float v = __uint_as_float(bits);
        s += v;
        bits = order_key(v);
        lo = min(lo, bits);
        hi = max(hi, bits);
    };
    if ((int)threadIdx.x < head) to_key(keys[threadIdx.x]);
    uint4* quads = reinterpret_cast<uint4*>(keys + head);
    for (int q = threadIdx.x; q < body / 4; q += THREADS) {
        uint4 v = quads[q];
        to_key(v.x);
        to_key(v.y);
        to_key(v.z);
        to_key(v.w);
        quads[q] = v;
    }
    if (head + body + (int)threadIdx.x < N) to_key(keys[head + body + threadIdx.x]);
    digest_row<THREADS>(StagedRow{keys, N, head}, k, s, lo, hi, stats, top, idx, sh);
}

// One block a row, every pass reading the row from device memory
__global__ void __launch_bounds__(WIDE_THREADS)
row_digest_streamed(const float* __restrict__ dmat, int N, int k, float* __restrict__ stats,
                    float* __restrict__ top, int64_t* __restrict__ idx) {
    __shared__ Shared sh;
    const float* row = dmat + (size_t)blockIdx.x * N;
    zero_hist(sh, WIDE_THREADS);
    double s = 0.0;
    uint32_t lo = 0xffffffffu, hi = 0u;
    for (int i = threadIdx.x; i < N; i += WIDE_THREADS) {
        const float v = row[i];
        s += v;
        const uint32_t kx = order_key(v);
        lo = min(lo, kx);
        hi = max(hi, kx);
    }
    digest_row<WIDE_THREADS>(StreamedRow{row, N}, k, s, lo, hi, stats, top, idx, sh);
}

// Dynamic shared memory of a staged row of N entries, or 0 when the row
// exceeds STAGE_MAX and is streamed
int staged_bytes(int N) {
    const long long bytes = (((long long)N + 3) * 4 + 15) / 16 * 16;
    return bytes <= STAGE_MAX ? (int)bytes : 0;
}

}  // namespace

extern "C" int kpop_row_digest(const float* dmat, int B, int N, int k, float* stats,
                               float* top, int64_t* idx, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const int smem = staged_bytes(N);
    if (smem > 0) {
        cudaError_t err = cudaFuncSetAttribute(
            row_digest_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        row_digest_staged<<<B, THREADS, smem, (cudaStream_t)stream>>>(dmat, N, k, stats, top,
                                                                       idx);
    } else {
        row_digest_streamed<<<B, WIDE_THREADS, 0, (cudaStream_t)stream>>>(dmat, N, k, stats,
                                                                          top, idx);
    }
    return (int)cudaGetLastError();
}
