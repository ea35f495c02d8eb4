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
// What bounds it on the H100: one block owns one row and reads it about 10
// times at the relatedness shape (two moment passes, the median and the
// k-th value selected together in 3 digit passes, the MAD in 4, one
// compaction pass).  Device memory is read once per row (82 MB for the
// batch of 2048 x 10,000); the repeat passes come from L1 and L2, since a
// row is 40 KB and a few blocks share an SM.  The bound is the
// instructions of the histogram passes (key, compare, shared-memory
// atomic per element and digit) and the barriers between them, not DRAM.
// So the design cuts digit passes: the first pass also finds the row's
// smallest and largest keys, and a selection skips the leading bits those
// two share (every key between them shares them), and the median and the
// k-th value share their passes.  The histogram takes plain shared-memory
// atomics: warp aggregation by __match_any_sync measured slower on the
// card, though the leading digit of a distance row is nearly constant.
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
//   monotone;
// - the k smallest are the entries below the k-th value, then the entries
//   equal to it, lowest column first, each group in column order.  A stable
//   sort by value of that list (done by the caller) gives the (value,
//   column) order of the reference's stable sort;
// - mean and the sum of squared deviations accumulate in float64, in a
//   fixed order, so the result does not change from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int DIGIT_BITS = 8;
constexpr int BINS = 1 << DIGIT_BITS;
constexpr unsigned FULL = 0xffffffffu;
static_assert(BINS <= THREADS, "the bin scan takes one bin per thread");
static_assert(WARPS <= 32, "one warp scans the warp totals");

struct Shared {
    int hist[2][BINS];
    int warp[WARPS + 1];
    double red[WARPS];
    int pick[2][2];
    uint32_t lo, hi;
};

__device__ __forceinline__ uint32_t order_key(float f) {
    if (f != f) return 0xffffffffu;  // NaN: last
    uint32_t u = __float_as_uint(f);
    if (u == 0x80000000u) u = 0u;  // -0.0 is +0.0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
    return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

struct ValueKey {
    __device__ uint32_t operator()(float d) const { return order_key(d); }
};

struct DeviationKey {
    float median;
    __device__ uint32_t operator()(float d) const { return order_key(fabsf(d - median)); }
};

// Exclusive prefix sum of one int per thread over the block; `total` gets
// the block's sum.  Ends on a barrier, so `sh` may be reused at once.
__device__ int block_scan(int v, int& total, Shared& sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sh.warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int w = lane < WARPS ? sh.warp[lane] : 0;
        int s = w;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, s, o);
            if (lane >= o) s += y;
        }
        if (lane < WARPS) sh.warp[lane] = s - w;
        if (lane == 31) sh.warp[WARPS] = s;
    }
    __syncthreads();
    total = sh.warp[WARPS];
    const int out = sh.warp[warp] + x - v;
    __syncthreads();
    return out;
}

// Sum over the block, the same in every thread (warp totals added in order).
__device__ double block_sum(double v, Shared& sh) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = v;
    __syncthreads();
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += sh.red[w];
    __syncthreads();
    return s;
}

// Smallest `lo` and largest `hi` over the block, written back to both.
__device__ void block_min_max(uint32_t& lo, uint32_t& hi, Shared& sh) {
    if (threadIdx.x == 0) {
        sh.lo = 0xffffffffu;
        sh.hi = 0u;
    }
    __syncthreads();
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if ((threadIdx.x & 31) == 0) {
        atomicMin(&sh.lo, lo);
        atomicMax(&sh.hi, hi);
    }
    __syncthreads();
    lo = sh.lo;
    hi = sh.hi;
    __syncthreads();
}

// The keys of ranks rank[s] (0-based, ascending) among key(row[i]), i < N,
// found together, most significant digit first, and the number of keys
// below each.  Every key lies in [lo, hi], so the leading bits those two
// share are known and skipped: the digits cover only the bits below them.
template <int NSEL, class Key>
__device__ void radix_select(const float* __restrict__ row, int N, Key key, uint32_t lo,
                             uint32_t hi, const int (&rank)[NSEL], uint32_t (&found)[NSEL],
                             int (&n_below)[NSEL], Shared& sh) {
    const int low_bits = lo == hi ? 0 : 32 - __clz(lo ^ hi);
    uint32_t mask = low_bits == 32 ? 0u : ~((1u << low_bits) - 1u);
    uint32_t prefix[NSEL];
    int r[NSEL];
#pragma unroll
    for (int s = 0; s < NSEL; ++s) {
        prefix[s] = lo & mask;
        r[s] = rank[s];
    }
    for (int low = low_bits; low > 0;) {
        const int bits = min(DIGIT_BITS, low);
        low -= bits;  // this digit is bits [low, low + bits)
        const uint32_t digit = (1u << bits) - 1u;
        for (int i = threadIdx.x; i < NSEL * BINS; i += THREADS) sh.hist[i / BINS][i % BINS] = 0;
        __syncthreads();
        for (int i = threadIdx.x; i < N; i += THREADS) {
            const uint32_t kx = key(row[i]);
#pragma unroll
            for (int s = 0; s < NSEL; ++s) {
                if ((kx & mask) == prefix[s]) atomicAdd(&sh.hist[s][(kx >> low) & digit], 1);
            }
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < NSEL; ++s) {
            const int c = threadIdx.x < BINS ? sh.hist[s][threadIdx.x] : 0;
            int total;
            const int below = block_scan(c, total, sh);
            if (below <= r[s] && r[s] < below + c) {  // exactly one bin holds rank r
                sh.pick[s][0] = threadIdx.x;
                sh.pick[s][1] = below;
            }
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < NSEL; ++s) {
            prefix[s] |= (uint32_t)sh.pick[s][0] << low;
            r[s] -= sh.pick[s][1];
        }
        mask |= digit << low;
        __syncthreads();  // the next digit rewrites hist and pick
    }
#pragma unroll
    for (int s = 0; s < NSEL; ++s) {
        found[s] = prefix[s];
        n_below[s] = rank[s] - r[s];
    }
}

__global__ void __launch_bounds__(THREADS)
row_digest_kernel(const float* __restrict__ dmat, int N, int k, float* __restrict__ stats,
                  float* __restrict__ top, int32_t* __restrict__ idx) {
    __shared__ Shared sh;
    const float* row = dmat + (size_t)blockIdx.x * N;

    double s = 0.0;
    uint32_t lo = 0xffffffffu, hi = 0u;
    for (int i = threadIdx.x; i < N; i += THREADS) {
        s += row[i];
        const uint32_t kx = order_key(row[i]);
        lo = min(lo, kx);
        hi = max(hi, kx);
    }
    const double mean = block_sum(s, sh) / N;
    block_min_max(lo, hi, sh);
    double q = 0.0;
    for (int i = threadIdx.x; i < N; i += THREADS) {
        const double d = row[i] - mean;
        q += d * d;
    }
    const double m2 = block_sum(q, sh);

    // the upper median (rank N/2) and the k-th smallest (rank k-1) together
    const int ranks[2] = {N / 2, k - 1};
    uint32_t found[2];
    int below[2];
    radix_select(row, N, ValueKey(), lo, hi, ranks, found, below, sh);
    const float median = key_value(found[0]);
    const uint32_t kth = found[1];
    // the MAD: rank N/2 of |d - median|, which lie in [0, the larger
    // deviation of the row's extremes] (rounding is monotone)
    const DeviationKey deviation{median};
    const uint32_t spread = max(deviation(key_value(hi)), deviation(key_value(lo)));
    const int mad_rank[1] = {N / 2};
    uint32_t mad_key[1];
    int mad_below[1];
    radix_select(row, N, deviation, order_key(0.0f), spread, mad_rank, mad_key, mad_below, sh);
    const float mad = key_value(mad_key[0]);

    // the k smallest: the below[1] entries under the k-th value in column
    // order at [0, below[1]), then the first `ties` entries equal to it
    const int n_under = below[1];
    const int ties = k - n_under;
    float* top_row = top + (size_t)blockIdx.x * k;
    int32_t* idx_row = idx + (size_t)blockIdx.x * k;
    int n_lt = 0, n_eq = 0;
    for (int i0 = 0; i0 < N && (n_lt < n_under || n_eq < ties); i0 += THREADS) {
        const int i = i0 + threadIdx.x;
        uint32_t kx = 0;
        int flags = 0;  // bit 0: below the k-th value; bit 16: equal to it
        if (i < N) {
            kx = order_key(row[i]);
            flags = (int)(kx < kth) | ((int)(kx == kth) << 16);
        }
        int total;
        const int pos = block_scan(flags, total, sh);  // THREADS < 2^16: no carry
        int slot = -1;
        if (flags & 1) {
            slot = n_lt + (pos & 0xffff);
        } else if (flags) {
            const int t = n_eq + (pos >> 16);
            if (t < ties) slot = n_under + t;
        }
        if (slot >= 0) {
            top_row[slot] = key_value(kx);
            idx_row[slot] = i;
        }
        n_lt += total & 0xffff;
        n_eq += total >> 16;
    }

    if (threadIdx.x == 0) {
        float* st = stats + (size_t)blockIdx.x * 4;
        st[0] = (float)mean;
        st[1] = (float)sqrt(m2 / (double)max(N - 1, 1));
        st[2] = median;
        st[3] = mad;
    }
}

}  // namespace

extern "C" int kpop_row_digest(const float* dmat, int B, int N, int k, float* stats,
                               float* top, int32_t* idx, void* stream) {
    if (B > 0) {
        row_digest_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(dmat, N, k, stats, top,
                                                                    idx);
    }
    return (int)cudaGetLastError();
}
