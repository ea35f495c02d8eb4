// Lint and encode a batch's raw sequence bytes into int8 base codes on the
// card.
//
// Replaces the JAX package's host encoder,
// kpop_tpu/native/kpop_native.cpp::kpop_encode_batch, which the JAX tool
// (and the port's "codes" wire) runs on the host: each byte is mapped
// through the alphabet's 256-entry lint table (core/kmers.py::_DNA_CODE or
// _PROT_CODE: a base code, -1 for a byte that breaks the k-mer windows, -2
// for a dash), dashes are removed with their flanks joined, and every
// column past a row's encoded length is -1.  The input is the serving
// step's upload (ops/encode.py::ByteRing): B rows of raw UTF-8 bytes at a
// row stride that is a multiple of 16, then each row's int32 byte length;
// the bytes past a row's length are never used.
//
// What bounds it on the H100: bytes.  B x L bytes read and B x width codes
// written, one byte each (a served batch of 64 read sets of 601,885
// bases: 38.5 MB each way, 23 us at 3.35 TB/s); the arithmetic is one
// table lookup a byte.  The dash removal moves positions, so a block must
// know how many bytes the row keeps before its chunk.  The design reads
// each byte with 16-byte loads, keeps the table in shared memory, and
// takes three launches:
// 1. encode_count: a block of 256 threads takes one chunk of CHUNK =
//    16,384 bytes of one row, a thread 64 consecutive bytes by four 16-byte
//    loads in flight together; each thread looks its bytes up into a 64-bit
//    mask of the positions it keeps (inside the row's length and not a
//    dash), and the block sums the masks' popcounts (a warp reduction, then
//    one over the warps) into work[row, chunk].
// 2. encode_scan: one block a row turns its chunks' counts into exclusive
//    prefix sums in place and writes the row's encoded length after them.
// 3. encode_write: the blocks of 1 read their bytes again (from L2 where
//    the batch fits it) and look them up, take each thread's offset inside
//    the chunk by a block scan of the popcounts, place the kept codes
//    contiguously in shared memory (a 16-byte store for each load whose
//    bytes are all kept on a 16-byte boundary; the codes are looked up a
//    second time there, a load at a time, which holds fewer registers than
//    keeping all 64), and write them at the chunk's prefix by consecutive
//    4-byte stores, whatever the row's alignment (each word shifted out of
//    two aligned words of shared memory); then -1 over the chunk's own
//    columns past the row's encoded length.  In a row without a dash
//    every chunk's prefix is its own start, so the codes land position
//    for position.
// The second read of the bytes costs a third more traffic than the bound;
// a single pass with a decoupled look-back would save it, for about 0.01
// ms of a card step of 4 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;                // bytes a load
constexpr int LOADS = 4;               // loads a thread, in flight together
constexpr int SPAN = VEC * LOADS;      // a thread's 64 consecutive bytes
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS * SPAN;  // 16,384: ops/encode.py::ENCODE_CHUNK
constexpr int MAX_CHUNKS = 65535;      // grid.y
constexpr int8_t DASH = -2;

// the lint table into shared memory (THREADS == 256 entries)
__device__ __forceinline__ void load_table(const int8_t* table, int8_t* tab) {
    tab[threadIdx.x] = table[threadIdx.x];
    __syncthreads();
}

// A row's byte length, inside its stride.
__device__ __forceinline__ long long row_length(const int32_t* lengths, int r, int stride) {
    const int n = lengths[r];
    return n < 0 ? 0 : (n > stride ? stride : n);
}

// This thread's SPAN bytes from position p0 of its row, by LOADS 16-byte
// loads issued together; a load at or past the row's length is not made.
__device__ __forceinline__ void load_span(const uint8_t* row, long long p0, long long len,
                                          uint4 v[LOADS]) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
        v[i] = p0 + i * VEC < len ? *reinterpret_cast<const uint4*>(row + p0 + i * VEC)
                                  : make_uint4(0, 0, 0, 0);
}

// The 16 codes of one load, a byte each in w[4].
__device__ __forceinline__ void lint16(const uint4& v, const int8_t* tab, uint32_t w[4]) {
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint32_t out = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
            out |= uint32_t(uint8_t(tab[(in[q] >> (8 * b)) & 0xff])) << (8 * b);
        w[q] = out;
    }
}

// The mask of the span's positions kept: inside the row's length and not a
// dash.
__device__ __forceinline__ unsigned long long keep_mask(const uint4 v[LOADS], long long p0,
                                                        long long len, const int8_t* tab) {
    unsigned long long keep = 0;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
        uint32_t w[4];
        lint16(v[i], tab, w);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
            if (p0 + i * VEC + j < len && int8_t(w[j >> 2] >> (8 * (j & 3))) != DASH)
                keep |= 1ull << (i * VEC + j);
    }
    return keep;
}

// The sum of v over the block, in every thread.
__device__ __forceinline__ int block_sum(int v, int* red) {
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) s += red[i];
    return s;
}

// The exclusive prefix of v over the block's threads, and in `total` the
// block's sum.  Ends with the block synchronized, so `sums` may be reused.
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
        before += i < warp ? sums[i] : 0;
        total += sums[i];
    }
    __syncthreads();
    return before + x - v;
}

__global__ void __launch_bounds__(THREADS)
    encode_count(const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
                 int stride, int chunks, const int8_t* __restrict__ table,
                 int32_t* __restrict__ work) {
    __shared__ int8_t tab[256];
    __shared__ int red[WARPS];
    load_table(table, tab);
    const int r = blockIdx.x, c = blockIdx.y;
    const long long len = row_length(lengths, r, stride);
    const long long p0 = (long long)c * CHUNK + threadIdx.x * SPAN;
    uint4 v[LOADS];
    load_span(bytes + (size_t)r * stride, p0, len, v);
    const int kept = block_sum(__popcll(keep_mask(v, p0, len, tab)), red);
    if (threadIdx.x == 0) work[(size_t)r * chunks + c] = kept;
}

__global__ void __launch_bounds__(THREADS)
    encode_scan(int32_t* __restrict__ work, int B, int chunks) {
    __shared__ int sums[WARPS];
    const int r = blockIdx.x;
    int32_t* counts = work + (size_t)r * chunks;
    int carry = 0;
    for (int c0 = 0; c0 < chunks; c0 += THREADS) {
        const int c = c0 + threadIdx.x;
        const int v = c < chunks ? counts[c] : 0;
        int total;
        const int before = block_scan(v, sums, total);
        if (c < chunks) counts[c] = carry + before;
        carry += total;
    }
    if (threadIdx.x == 0) work[(size_t)B * chunks + r] = carry;
}

__global__ void __launch_bounds__(THREADS)
    encode_write(const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths, int B,
                 int stride, int width, int chunks, const int8_t* __restrict__ table,
                 const int32_t* __restrict__ work, int8_t* __restrict__ out) {
    __shared__ int8_t tab[256];
    __shared__ int sums[WARPS];
    __shared__ __align__(16) int8_t staged[CHUNK + 16];  // + a word read past the end
    load_table(table, tab);
    const int r = blockIdx.x, c = blockIdx.y;
    const long long len = row_length(lengths, r, stride);
    const long long c0 = (long long)c * CHUNK;
    const long long p0 = c0 + threadIdx.x * SPAN;
    uint4 v[LOADS];
    load_span(bytes + (size_t)r * stride, p0, len, v);
    const unsigned long long keep = keep_mask(v, p0, len, tab);
    int kept;
    int at = block_scan(__popcll(keep), sums, kept);
    // the kept codes into staged from `at`, a load at a time: one 16-byte
    // store where all 16 are kept on a 16-byte boundary, else byte by byte
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
        const unsigned k16 = unsigned(keep >> (i * VEC)) & 0xffffu;
        uint32_t w[4];
        lint16(v[i], tab, w);
        if (k16 == 0xffffu && (at & 15) == 0) {
            *reinterpret_cast<uint4*>(staged + at) = make_uint4(w[0], w[1], w[2], w[3]);
            at += VEC;
        } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                if (k16 >> j & 1u) staged[at++] = int8_t(w[j >> 2] >> (8 * (j & 3)));
        }
    }
    __syncthreads();
    const long long base = work[(size_t)r * chunks + c];
    const long long encoded = work[(size_t)B * chunks + r];
    int8_t* dst = out + (size_t)r * width;
    // the kept codes to dst[base, base + n): the head bytes up to a 4-byte
    // boundary of dst, then words, each shifted out of two aligned words of
    // staged, then the tail bytes
    int8_t* d = dst + base;
    const int n = base < width ? (int)(kept < width - base ? kept : width - base) : 0;
    int head = (int)((4 - ((uintptr_t)d & 3)) & 3);
    head = head < n ? head : n;
    const int words = (n - head) >> 2;
    if ((int)threadIdx.x < head) d[threadIdx.x] = staged[threadIdx.x];
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(staged);
    uint32_t* dw = reinterpret_cast<uint32_t*>(d + head);
    for (int i = threadIdx.x; i < words; i += THREADS)
        dw[i] = head ? __funnelshift_r(sw[i], sw[i + 1], 8 * head) : sw[i];
    for (int i = head + 4 * words + threadIdx.x; i < n; i += THREADS) d[i] = staged[i];
    const long long end = c0 + CHUNK < width ? c0 + CHUNK : width;
    for (long long q = (encoded > c0 ? encoded : c0) + threadIdx.x; q < end; q += THREADS)
        dst[q] = -1;
}

}  // namespace

// bytes [B, stride] u8 (stride a multiple of 16, 16-byte aligned), lengths
// [B] int32, the lint table [256] int8, work [B * (chunks + 1)] int32 with
// chunks = ceil(max(stride, width) / CHUNK), out [B, width] int8
extern "C" int kpop_encode_bytes(const uint8_t* bytes, const int32_t* lengths, int B, int stride,
                                 int width, const int8_t* table, int32_t* work, int8_t* out,
                                 void* stream) {
    if (B < 0 || width < 1 || stride < VEC || stride % VEC || (uintptr_t)bytes % VEC)
        return (int)cudaErrorInvalidValue;
    // every byte of a row can land in [0, width) once dashes go
    const int chunks = int(((long long)(stride > width ? stride : width) + CHUNK - 1) / CHUNK);
    if (chunks > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(B, chunks);
    encode_count<<<grid, THREADS, 0, s>>>(bytes, lengths, stride, chunks, table, work);
    encode_scan<<<B, THREADS, 0, s>>>(work, B, chunks);
    encode_write<<<grid, THREADS, 0, s>>>(bytes, lengths, B, stride, width, chunks, table, work,
                                          out);
    return (int)cudaGetLastError();
}
