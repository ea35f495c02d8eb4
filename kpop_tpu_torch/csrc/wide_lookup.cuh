// The vocabulary lookups of the count (count_spectra.cu) and the embedding
// bag (embedding_bag.cu): a window code -> its vocabulary row, or V for a
// k-mer outside the vocabulary.
//
// LutFind: k up to lut_k_max, an int code read in a dense [base^k + 1]
// table (V where the k-mer is unknown).
//
// WideFind: larger k (DNA up to 30, protein up to 12), a uint64 code
// split at base^k_lo into two int32 limbs (hi, lo), then looked up
//  - in the two-table cuckoo hash [6, S] int32 that
//    kpop_tpu_torch/ops/cuckoo.py::build_cuckoo builds (rows t1_hi, t1_lo,
//    t1_idx, t2_hi, t2_lo, t2_idx; an empty slot has hi = -1): slot s1 of
//    the first table, then slot s2 of the second, by the same mix as the
//    host's _mix_np; at most six 4-byte reads;
//  - or, when the host could not build the hash, by a lower-bound binary
//    search in the limbs sorted by (hi, lo).
// Replaces kpop_tpu/ops/encode.py::window_codes_batch_wide (the limbs),
// kpop_tpu/ops/cuckoo.py::cuckoo_lookup and
// kpop_tpu/ops/encode.py::searchsorted_2limb, which XLA ran on the TPU as
// separate passes over the [B, W] windows.  Here the code stays in
// registers and each probe is a dependent 4-byte read of a table of
// 6 * 4 * S bytes (50 MB at V = 1M, about the H100's L2).
#pragma once

#include <stdint.h>

namespace kpop {

struct LutFind {
    using Code = int;
    const int32_t* lut;
    int V;
    __device__ __forceinline__ int operator()(Code code) const {
        const int x = lut[code];
        return (unsigned)x < (unsigned)V ? x : V;
    }
};

// the cuckoo hash's slot of (hi, lo): the uint32 arithmetic of _mix_np
__device__ __forceinline__ uint32_t cuckoo_mix(uint32_t hi, uint32_t lo, uint32_t a, uint32_t b,
                                               uint32_t mask) {
    uint32_t x = (hi * a) ^ (lo * b);
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    return x & mask;
}

struct WideFind {
    using Code = uint64_t;
    int base, k_lo;
    uint64_t limb;            // base^k_lo
    const int32_t* cuckoo;    // [6, S], or null
    uint32_t mask;            // S - 1
    uint32_t a1, b1, a2, b2;  // the hash's seeds
    const int32_t* vhi;       // [V] sorted limbs, when cuckoo is null
    const int32_t* vlo;
    int V;

    __device__ __forceinline__ int operator()(Code code) const {
        int32_t hi, lo;
        if (base == 4) {
            hi = (int32_t)(code >> (2 * k_lo));
            lo = (int32_t)(code & (limb - 1));
        } else {
            hi = (int32_t)(code / limb);
            lo = (int32_t)(code % limb);
        }
        int x = V;
        if (cuckoo) {
            const size_t S = (size_t)mask + 1;
            const uint32_t s1 = cuckoo_mix(hi, lo, a1, b1, mask);
            if (cuckoo[s1] == hi && cuckoo[S + s1] == lo) {
                x = cuckoo[2 * S + s1];
            } else {
                const uint32_t s2 = cuckoo_mix(hi, lo, a2, b2, mask);
                if (cuckoo[3 * S + s2] == hi && cuckoo[4 * S + s2] == lo) x = cuckoo[5 * S + s2];
            }
        } else {
            int l = 0, h = V;  // the first entry not below (hi, lo)
            while (l < h) {
                const int mid = (l + h) >> 1;
                const int32_t mh = vhi[mid];
                if (mh < hi || (mh == hi && vlo[mid] < lo)) l = mid + 1;
                else h = mid;
            }
            if (l < V && vhi[l] == hi && vlo[l] == lo) x = l;
        }
        return (unsigned)x < (unsigned)V ? x : V;
    }
};

// The host side of a wide entry point's vocabulary arguments
inline WideFind wide_find(int base, int k_lo, const int32_t* cuckoo, int slots, uint32_t a1,
                          uint32_t b1, uint32_t a2, uint32_t b2, const int32_t* vhi,
                          const int32_t* vlo, int V) {
    WideFind f;
    f.base = base;
    f.k_lo = k_lo;
    f.limb = 1;
    for (int i = 0; i < k_lo; ++i) f.limb *= (uint64_t)base;
    f.cuckoo = cuckoo;
    f.mask = (uint32_t)(slots - 1);
    f.a1 = a1, f.b1 = b1, f.a2 = a2, f.b2 = b2;
    f.vhi = vhi;
    f.vlo = vlo;
    f.V = V;
    return f;
}

}  // namespace kpop
