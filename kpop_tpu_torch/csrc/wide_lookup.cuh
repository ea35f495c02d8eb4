// The vocabulary lookups of the count (count_spectra.cu) and the embedding
// bag (embedding_bag.cu): the window codes of RUN consecutive windows of a
// read set, rolled base by base, -> their vocabulary rows, or V for a
// k-mer outside the vocabulary or a window that touches a break.
//
// LutFind: k up to lut_k_max, an int code read in a dense [base^k + 1]
// table (V where the k-mer is unknown): one L2 sector a window.
//
// WideFind: larger k (DNA up to 30, protein up to 12), a uint64 code
// split at base^k_lo into two int32 limbs (hi, lo), then looked up
//  - in the two-table cuckoo hash that kpop_tpu_torch/ops/cuckoo.py::
//    build_cuckoo builds, laid out for the card by ops/cuckoo.py::
//    probe_table: 2 S slots of 16 bytes {hi, lo, idx, 0} (the first
//    table's S, then the second's), then 2 S uint16 fingerprints, 0 for an
//    empty slot.  A key's slots are s1 and S + s2, by the uint32 mixes of
//    the host's _mix_np; the fingerprint stored at s1 is the top 16 bits
//    of the second mix and the one at S + s2 those of the first (0 read as
//    1), so a fingerprint is independent of the slot it sits in;
//  - or, when the host could not build the hash, by a lower-bound binary
//    search in the limbs sorted by (hi, lo), interleaved as int2 {hi, lo}
//    so that a step reads one sector.
// Replaces kpop_tpu/ops/encode.py::window_codes_batch_wide (the limbs),
// kpop_tpu/ops/cuckoo.py::cuckoo_lookup and
// kpop_tpu/ops/encode.py::searchsorted_2limb, which XLA ran on the TPU as
// separate passes over the [B, W] windows.
//
// What bounds the wide lookup.  At k = 16 and V = 1,011,930 the [6, S]
// table of build_cuckoo is 50 MB, the L2's size, and its probe was a chain
// of dependent 4-byte reads (hi, then lo, then idx, the second table only
// after the first missed): up to six L2 or HBM round trips a window, paid
// in full by the misses, which are 77 % of random reads.  Here a window
// costs one round trip to the fingerprints (2 S x 2 bytes, 8.4 MB at S =
// 2^21, so they stay in L2), both tables' issued together before either
// compare, and a hit one more to its 16-byte slot; a miss reads no slot (a
// false match, 2^-16 a probe, reads one and finds the key absent).  The
// codes of a thread's RUN windows are all computed first, so all their
// fingerprint loads are in flight at once, then all their slot loads.
// Measured on an H100 at phase 3's batch (k = 16, tools/probe_count.py),
// the count's lookup takes 0.076 ms against 0.12 for the chain.  Buckets
// of fingerprints by the first slot, one sector a miss, measured slower
// on these random reads: 0.104 ms with four 16-bit entries (16.8 MB) and
// 0.089 with four 8-bit ones (8.4 MB, and a path for the buckets that
// overflow), though 10 % faster on real reads, which mostly hit.  The
// sorted-limb search runs the RUN windows in lockstep, a branchless lower
// bound of ceil(log2 V) steps, so each step's RUN loads are in flight
// together.
#pragma once

#include <stdint.h>

namespace kpop {

struct LutFind {
    using Code = int;
    const int32_t* lut;
    int V;
    template <int RUN>
    __device__ __forceinline__ void rows(const Code (&code)[RUN], const bool (&ok)[RUN],
                                         int (&out)[RUN]) const {
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
            const int x = ok[r] ? lut[code[r]] : V;
            out[r] = (unsigned)x < (unsigned)V ? x : V;
        }
    }
};

// the uint32 arithmetic of the host's _mix_np before its mask
__device__ __forceinline__ uint32_t cuckoo_mix(uint32_t hi, uint32_t lo, uint32_t a, uint32_t b) {
    uint32_t x = (hi * a) ^ (lo * b);
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    return x;
}

// a stored fingerprint: the top 16 bits of a mix, never 0 (an empty slot)
__device__ __forceinline__ uint32_t cuckoo_fingerprint(uint32_t x) {
    const uint32_t f = x >> 16;
    return f ? f : 1u;
}

struct WideFind {
    using Code = uint64_t;
    int base, k_lo;
    uint64_t limb;            // base^k_lo
    const int4* slots;        // [2 S] {hi, lo, idx, 0}, then [2 S] uint16 fingerprints; or null
    uint32_t mask;            // S - 1
    uint32_t a1, b1, a2, b2;  // the hash's seeds
    const int2* limbs;        // [V] sorted {hi, lo}, when slots is null
    int V;

    __device__ __forceinline__ void split(Code code, int32_t& hi, int32_t& lo) const {
        if (base == 4) {
            hi = (int32_t)(code >> (2 * k_lo));
            lo = (int32_t)(code & (limb - 1));
        } else {
            hi = (int32_t)(code / limb);
            lo = (int32_t)(code % limb);
        }
    }

    template <int RUN>
    __device__ __forceinline__ void rows(const Code (&code)[RUN], const bool (&ok)[RUN],
                                         int (&out)[RUN]) const {
        int32_t hi[RUN], lo[RUN];
#pragma unroll
        for (int r = 0; r < RUN; ++r) split(code[r], hi[r], lo[r]);
        if (slots) {
            const uint32_t S = mask + 1;
            const uint16_t* fp = reinterpret_cast<const uint16_t*>(slots + 2 * (size_t)S);
            uint32_t s1[RUN], s2[RUN], want[RUN], got[RUN];
#pragma unroll
            for (int r = 0; r < RUN; ++r) {
                const uint32_t x1 = cuckoo_mix(hi[r], lo[r], a1, b1);
                const uint32_t x2 = cuckoo_mix(hi[r], lo[r], a2, b2);
                s1[r] = x1 & mask;
                s2[r] = S + (x2 & mask);
                want[r] = cuckoo_fingerprint(x2) | cuckoo_fingerprint(x1) << 16;
            }
            // every window's two fingerprints in flight at once
#pragma unroll
            for (int r = 0; r < RUN; ++r)
                got[r] = ok[r] ? (uint32_t)__ldg(fp + s1[r]) | (uint32_t)__ldg(fp + s2[r]) << 16 : 0u;
            // then the slots the fingerprints point at: the first table's
            // before the second's, the second read again only when both
            // match and the first slot holds another key
            int4 e[RUN];
#pragma unroll
            for (int r = 0; r < RUN; ++r) {
                const bool m1 = (got[r] & 0xffffu) == (want[r] & 0xffffu);
                const bool m2 = (got[r] >> 16) == (want[r] >> 16);
                e[r] = make_int4(-1, -1, V, 0);
                if (m1 || m2) e[r] = __ldg(slots + (m1 ? s1[r] : s2[r]));
                if (m1 && m2 && !(e[r].x == hi[r] && e[r].y == lo[r])) e[r] = __ldg(slots + s2[r]);
            }
#pragma unroll
            for (int r = 0; r < RUN; ++r) {
                const int x = e[r].x == hi[r] && e[r].y == lo[r] ? e[r].z : V;
                out[r] = ok[r] && (unsigned)x < (unsigned)V ? x : V;
            }
        } else {
            // the first entry not below (hi, lo), all RUN windows a step at
            // a time: [at, at + n] holds it
            int at[RUN];
#pragma unroll
            for (int r = 0; r < RUN; ++r) at[r] = 0;
            for (int n = V; n > 1;) {
                const int half = n >> 1;
#pragma unroll
                for (int r = 0; r < RUN; ++r) {
                    const int2 m = __ldg(limbs + at[r] + half);
                    if (m.x < hi[r] || (m.x == hi[r] && m.y < lo[r])) at[r] += half;
                }
                n -= half;
            }
#pragma unroll
            for (int r = 0; r < RUN; ++r) {
                const int2 m = __ldg(limbs + at[r]);
                const bool below = m.x < hi[r] || (m.x == hi[r] && m.y < lo[r]);
                const int2 e = below && at[r] + 1 < V ? __ldg(limbs + at[r] + 1) : m;
                // the first entry not below (hi, lo) is at[r] + below
                const bool hit = below ? at[r] + 1 < V && e.x == hi[r] && e.y == lo[r]
                                       : m.x == hi[r] && m.y == lo[r];
                out[r] = ok[r] && hit ? at[r] + below : V;
            }
        }
    }
};

// The host side of a wide entry point's vocabulary arguments: probe is
// ops/cuckoo.py::probe_table's layout of `slots` slots a table, limbs the
// sorted [V] {hi, lo}
inline WideFind wide_find(int base, int k_lo, const int32_t* probe, int slots, uint32_t a1,
                          uint32_t b1, uint32_t a2, uint32_t b2, const int32_t* limbs, int V) {
    WideFind f;
    f.base = base;
    f.k_lo = k_lo;
    f.limb = 1;
    for (int i = 0; i < k_lo; ++i) f.limb *= (uint64_t)base;
    f.slots = reinterpret_cast<const int4*>(probe);
    f.mask = (uint32_t)(slots - 1);
    f.a1 = a1, f.b1 = b1, f.a2 = a2, f.b2 = b2;
    f.limbs = reinterpret_cast<const int2*>(limbs);
    f.V = V;
    return f;
}

// The rows of the RUN windows w0 .. w0 + RUN - 1 of the read set at s (L
// bases, W = L - k + 1 windows): V past W, for a window that touches a
// base outside [0, base) (a -1 break) and for a k-mer outside the
// vocabulary.  One rolling forward code (and, for canonical DNA, reverse
// complement: its 2 bits a base shifted in at the top) over the RUN
// windows; the canonical code is the smaller one.
template <int RUN, class Find>
__device__ __forceinline__ void window_rows(const int8_t* __restrict__ s, int L, int k,
                                            int canonical, int base, const Find& find, int w0,
                                            int W, int (&out)[RUN]) {
    using Code = typename Find::Code;
    Code top = 1;  // base^(k-1)
    for (int j = 1; j < k; ++j) top *= base;
    // fwd = sum_j c[w+j] base^(k-1-j); rc = sum_j (3 - c[w+j]) 4^j;
    // last_bad = the last position that is not a base
    Code fwd = 0, rc = 0;
    int last_bad = w0 - 1;
    auto push = [&](int j) {
        int c = j < L ? s[j] : -1;
        if (c < 0 || c >= base) {
            last_bad = j;
            c = 0;
        }
        fwd = (base == 4 ? (fwd & (top - 1)) : fwd % top) * base + c;
        rc = (rc >> 2) + (Code)(3 - c) * top;
    };
    for (int j = w0; j < w0 + k - 1; ++j) push(j);
    Code code[RUN];
    bool ok[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
        const int w = w0 + r;
        push(w + k - 1);
        ok[r] = w < W && last_bad < w;
        code[r] = canonical && fwd > rc ? rc : fwd;
    }
    find.rows(code, ok, out);
}

}  // namespace kpop
