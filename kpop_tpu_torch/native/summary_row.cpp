// The numbers of one distance-summary line, by selection
// (core/space.py::summarize_distance_row, lib/Matrix.ml:632-690).
//
// A line gives a row's mean, standard deviation, median and MAD, then its
// nearest entries: every index whose value is at most the req_len-th
// smallest, whole tie groups included, ordered by (value, index).  The
// numpy path sorts the row twice and lexsorts it once; here the median and
// the MAD are each one selection (select_rank), the k-th of a small req_len
// one scan (select_few), and only the entries at most the k-th are sorted.
//
// The result equals numpy's bit for bit:
// - the two sums follow numpy's pairwise summation (numpy's
//   loops_utils.h.src, @TYPE@_pairwise_sum) in its order, and the squares
//   are rounded before they are added (no fused multiply-add);
// - a row whose values hold a NaN, an infinity or a negative zero, or whose
//   length exceeds the caller's limit (a reduction of more elements than
//   numpy's ufunc buffer runs in pieces), is refused: numpy's placement of
//   NaN, the order of -0.0 against 0.0 and the summation in pieces are left
//   to the numpy path.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__clang__)
#pragma STDC FP_CONTRACT OFF
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

namespace {

constexpr uint64_t kExponent = 0x7ff0000000000000ull;
constexpr uint64_t kNegativeZero = 0x8000000000000000ull;

// numpy's PW_BLOCKSIZE: the largest run summed by eight accumulators
constexpr int64_t kPairwiseBlock = 128;

// sum of f(i) over [lo, lo + n) in numpy's pairwise order
template <class F>
double pairwise_sum(const F& f, int64_t lo, int64_t n) {
    if (n < 8) {
        double res = 0.;
        for (int64_t i = 0; i < n; ++i) res += f(lo + i);
        return res;
    }
    if (n <= kPairwiseBlock) {
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = f(lo + j);
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += f(lo + i + j);
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += f(lo + i);
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(f, lo, n2) + pairwise_sum(f, lo + n2, n - n2);
}

// runs at most this long go to std::nth_element
constexpr int64_t kSmallRun = 64;
// the most buckets a level of select_rank spreads a run over
constexpr int64_t kBuckets = 1024;
// the levels of buckets select_rank takes before std::nth_element
constexpr int kLevels = 3;

// The element of rank ``at`` among v[0:m), which it consumes.  Each level
// spreads the run over buckets of equal width between its least and its
// largest value, a map that keeps the order, and keeps the bucket that
// holds the rank; a short run, or one after kLevels levels, goes to
// std::nth_element.  A level's passes branch only on a rarely taken test,
// where std::nth_element alone mispredicts about one comparison in two.
double select_rank(double* v, int64_t m, int64_t at) {
    uint32_t count[kBuckets];
    for (int level = 0; level < kLevels && m > kSmallRun; ++level) {
        // eight lanes: the values hold no NaN, so any order gives the same
        double lo8[8], hi8[8];
        for (int j = 0; j < 8; ++j) lo8[j] = hi8[j] = v[0];
        int64_t i = 0;
        for (; i + 8 <= m; i += 8)
            for (int j = 0; j < 8; ++j) {
                lo8[j] = std::min(lo8[j], v[i + j]);
                hi8[j] = std::max(hi8[j], v[i + j]);
            }
        for (; i < m; ++i) {
            lo8[0] = std::min(lo8[0], v[i]);
            hi8[0] = std::max(hi8[0], v[i]);
        }
        const double lo = *std::min_element(lo8, lo8 + 8);
        const double hi = *std::max_element(hi8, hi8 + 8);
        if (lo == hi) return lo;
        const int64_t buckets = std::min(m, kBuckets);
        const double scale = static_cast<double>(buckets) / (hi - lo);
        if (!std::isfinite(scale) || scale == 0.0) break;
        // x - lo, its product and the truncation never decrease with x
        auto bucket = [lo, scale, buckets](double x) {
            const int64_t b = static_cast<int64_t>((x - lo) * scale);
            return b < buckets ? b : buckets - 1;
        };
        std::fill(count, count + buckets, 0u);
        for (int64_t i = 0; i < m; ++i) ++count[bucket(v[i])];
        int64_t t = 0, below = 0;
        while (below + count[t] <= at) below += count[t++];
        int64_t kept = 0;
        for (int64_t i = 0; i < m; ++i)
            if (bucket(v[i]) == t) v[kept++] = v[i];
        m = kept;
        at -= below;
    }
    std::nth_element(v, v + at, v + m);
    return v[at];
}

// ranks below this are found by one scan that keeps the fewest values
constexpr int64_t kFewest = 8;

// The element of rank ``at`` < kFewest among v[0:m), m > at: one scan that
// keeps the at + 1 least values in order, past which a value rarely falls.
double select_few(const double* v, int64_t m, int64_t at) {
    double few[kFewest];
    const int64_t k = at + 1;
    std::copy(v, v + k, few);
    std::sort(few, few + k);
    for (int64_t i = k; i < m; ++i) {
        const double x = v[i];
        if (x < few[at]) {
            int64_t j = at;
            for (; j > 0 && few[j - 1] > x; --j) few[j] = few[j - 1];
            few[j] = x;
        }
    }
    return few[at];
}

}  // namespace

// Computes a summary line's numbers for ``row[0:n]``: ``stats4`` gets the
// mean, the standard deviation (over n - 1), the median and the MAD (the
// elements at n // 2), and ``near`` the indices of every value at most the
// min(req_len, n)-th smallest, ordered by (value, index).  ``near`` and
// ``scratch`` hold n entries each.  Returns how many indices ``near`` got,
// or -1, writing nothing, for a row the numpy path must take: n < 2,
// n > max_n, req_len <= 0, or a value that is NaN, infinite or -0.0.
extern "C" int64_t kpop_summary_row(const double* row, int64_t n,
                                    int64_t req_len, int64_t max_n,
                                    double* stats4, int64_t* near,
                                    double* scratch) {
    if (n < 2 || n > max_n || req_len <= 0) return -1;
    // by the bits: an exponent of all ones (NaN, infinity) or -0.0
    uint64_t refused = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t bits;
        std::memcpy(&bits, row + i, sizeof bits);
        refused |= static_cast<uint64_t>((bits & kExponent) == kExponent) |
                   static_cast<uint64_t>(bits == kNegativeZero);
    }
    if (refused) return -1;
    std::copy(row, row + n, scratch);
    const double mean =
        pairwise_sum([row](int64_t i) { return row[i]; }, 0, n) /
        static_cast<double>(n);
    const double ss = pairwise_sum(
        [row, mean](int64_t i) {
            const double d = row[i] - mean;
            return d * d;
        },
        0, n);
    const double stddev = std::sqrt(ss / static_cast<double>(n - 1));
    const double median = select_rank(scratch, n, n / 2);
    const int64_t at = std::min(req_len, n) - 1;
    double kth;
    if (at < kFewest) {
        kth = select_few(row, n, at);
    } else {
        std::copy(row, row + n, scratch);
        kth = select_rank(scratch, n, at);
    }
    for (int64_t i = 0; i < n; ++i) scratch[i] = std::fabs(row[i] - median);
    const double mad = select_rank(scratch, n, n / 2);
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i)
        if (row[i] <= kth) near[m++] = i;
    std::sort(near, near + m, [row](int64_t a, int64_t b) {
        return row[a] < row[b] || (row[a] == row[b] && a < b);
    });
    stats4[0] = mean;
    stats4[1] = stddev;
    stats4[2] = median;
    stats4[3] = mad;
    return m;
}
