// Metric-weighted euclidean distance tile:
//
//     d[q, t] = sqrt(max(0, sum_j m_j (a[q,j]/na_q - b[t,j]/nb_t)^2))
//
// Replaces kpop_tpu/ops/pallas_pairwise.py::_dist_kernel (the repository's
// one Pallas kernel, launched by pairwise_distances_pallas).  On the
// serving path it computes distances_to_classes, [B, d] twisted reads
// against [C, d] classes (128 x 512 x 511 at the headline shape); the
// relatedness engine feeds it 4096 x 4096 x 512 blocks, and kpop-countdb
// --distances raw spectra, D the k-mer vocabulary (512 x 512 x 367,987).
//
// The expansion d^2 = na2_q + nb2_t - 2 cross_qt / (na_q nb_t), with
//     cross_qt = sum_j (m_j a_qj) b_tj,   na2_q = sum_j m_j a_qj^2 / na_q^2,
// runs as three kernels behind one entry point:
// 1. weighted_norms_kernel: na2 and nb2 in f32, once per row (a block per
//    row, a tree sum).
// 2. dist_tile_kernel: the cross term of a 128 x 128 output tile over one
//    slice of the feature axis, on the tensor cores, and the epilogue.
// 3. split_finish_kernel, only when the feature axis is split: the slices'
//    partial cross terms summed, then the epilogue.
//
// Split TF32 (3xTF32).  TF32 keeps 11 significant bits: a plain TF32
// product loses near-class distances to the cancellation in d^2 (parity is
// rtol 2e-4 / atol 1e-5, and 1e-4 against the host float64 chain).  Each
// value x is split into hi = tf32_rna(x) and lo = tf32_rna(x - hi)
// (cvt.rna.tf32.f32); hi + lo keeps 22 bits, and lo_a hi_b + hi_a lo_b +
// hi_a hi_b is accumulated in f32 (a product of two TF32 values is exact
// in f32).  That is the f32 product up to the dropped lo_a lo_b, about
// 2^-22 relative, so kpop_tpu_torch/config.py still pins cuBLAS to full f32
// (allow_tf32=False): these split products are not the 3-digit TF32 that
// the pin forbids.  The tensor cores' f32 accumulation does not round to
// nearest, and over a 512-feature slice it drifted to 3.4x the plain
// version's error, so each 32-feature chunk is summed in the tensor cores
// into a zeroed register tile and added to the accumulator with ordinary
// f32 adds.  The weight m is applied to a before its split; 1/na and 1/nb
// scale the cross term once, in the epilogue.
//
// The block: 512 threads.  Two producer warpgroups (72 registers each,
// setmaxnreg) bring 32-feature chunks of a and b into a ring of 3 stages
// and split b into B_hi / B_lo in the K-major layout wgmma reads.  Two
// consumer warpgroups (184 registers) each weight and split 64 rows of a
// in registers and issue wgmma.m64n128k8 (tf32, A from registers, B from
// shared memory): 12 per chunk.  Named barriers hand a stage over (FULL)
// and back (EMPTY), so the copies of the next two chunks and the split of
// the next one overlap this chunk's products.  The epilogue stages the
// tile in shared memory and writes rows whole.
//
// Copies, two routes.  When the row stride is a multiple of 16 bytes
// (D % 4 == 0: the relatedness blocks), one thread issues a 2D TMA box per
// operand and chunk (128-byte swizzle, rows and features past the operand
// zero-filled), completing on the stage's mbarrier.  Otherwise (D = 511,
// D = 367,987) TMA cannot describe the rows, and 4-byte cp.async costs
// four times the instructions, so each row's chunk is copied with 16-byte
// cp.async as the aligned window of 9 blocks that holds it, read from
// offset (row address % 16) / 4; src-size zero-fills rows past the edge
// and features past the slice.  A TMA box may hold the next slice's
// features in a slice's last chunk: both splits mask them.  No operand is
// padded or copied; a, b and m must start on 16 bytes.
//
// Split-K.  The grid is output tiles x S feature slices (S from
// kpop_tpu_torch/ops/pairwise.py::split_plan: about one wave of the 132
// SMs).  Slice s covers features [8 (s U / S), 8 ((s+1) U / S)) with
// U = ceil(D / 8), clipped to D.  With S = 1 the tile kernel runs the
// epilogue; with S > 1 each slice writes its partial cross term to an f32
// workspace [S, Q, T], and split_finish_kernel sums the slices in the
// order s = 0, 1, ..., S-1 before the sqrt: deterministic, no float
// atomics.  The larger of the two tile counts lies on grid.x (up to
// 2^31 - 1), the smaller on grid.y (up to 65535).
//
// What bounds it on the H100.  At 4096 x 4096 x 512 (TMA) the 12 wgmma
// of a chunk run near their 1.5k-cycle peak only when nothing else
// touches shared memory; the split of b, the split of a and the copies
// share it with them, and a block holds about 200 KB of shared memory and
// all 512 x 128 registers, so one block runs per SM and its epilogue
// overlaps nothing.  On the cp.async route (raw spectra) the copies cost
// more: about 4.0k cycles per chunk where the products alone take 2.2k.
// The norm pass reads each operand once at HBM speed (about 0.55 ms for
// the raw spectra's two 754 MB operands).  At the serving shape the three launches and the
// host bound it.  A fused digest epilogue (mean, median, MAD, top-k per
// row) for the relatedness engine is later work.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;       // output rows (of a) and columns (of b) per block
constexpr int WG_ROWS = 64;     // rows of a per consumer warpgroup (wgmma's M)
constexpr int CONSUMERS = 256;  // two warpgroups: split of a, wgmma, epilogue
constexpr int PRODUCERS = 256;  // two warpgroups: the copies and the split of b
constexpr int PRODUCER_REGS = 72;   // setmaxnreg: registers move from the
constexpr int CONSUMER_REGS = 184;  // producers to the accumulators
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int BK = 32;          // features per pipeline stage
constexpr int KSTEPS = BK / 8;  // wgmma k8 steps per stage
constexpr int STAGES = 3;       // depth of the ring
constexpr int UNIT = 8;         // split-K granule in features
constexpr int NORM_THREADS = 256;

// shared memory, in floats.  A stage of the ring holds the raw a and b
// tiles; B_hi and B_lo as [KSTEPS][TILE / 8 row groups][2 feature halves][8
// rows][4 features], the K-major core-matrix layout wgmma reads; and the
// weights.  The raw rows are, on the TMA route, 128-byte rows whose 16-byte
// blocks TMA swizzles by r % 8 (so a stage starts on 1024 bytes), and on
// the cp.async route the 16-byte aligned windows of RAW_LD floats that
// hold the chunk, element f of row r at (row address % 16) / 4 + f.  After
// the ring: the epilogue's row and column factors, and the stages'
// mbarriers.  The epilogue stages the output tile in the ring, rows padded
// to EPI_LD floats.
template <bool TMA>
struct Layout {
    static constexpr int RAW_LD = TMA ? BK : BK + 4;
    static constexpr int RAW_A = 0, RAW_B = TILE * RAW_LD, B_HI = 2 * TILE * RAW_LD,
                         B_LO = B_HI + TILE * BK, M_OFF = B_LO + TILE * BK;
    static constexpr int STAGE = TMA ? (M_OFF + BK + 255) / 256 * 256 : M_OFF + BK;
    // + 1024 bytes to align the ring
    static constexpr int SMEM_BYTES = (STAGES * STAGE + 4 * TILE) * (int)sizeof(float) +
                                      STAGES * (int)sizeof(uint64_t) + 1024;
    static_assert(STAGE % 4 == 0 && B_HI % 4 == 0, "16-byte aligned stages");
    static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
};
constexpr int FACTORS = 4 * TILE;
constexpr int EPI_LD = TILE + 4;
static_assert(TILE * EPI_LD <= STAGES * Layout<true>::STAGE, "the epilogue tile fits the ring");
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536, "register file");

// named barriers (0 is __syncthreads): the producers' own (cp.async route),
// the consumers' own, and for each stage FULL (producers -> consumers) and
// EMPTY (consumers -> producers)
constexpr int BAR_PRODUCER = 1;
constexpr int BAR_CONSUMER = 2;
constexpr int BAR_FULL = 3;
constexpr int BAR_EMPTY = BAR_FULL + STAGES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which the first `bytes` are
// read and the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a box of the 2D tensor map at (x, y) into shared memory, and bytes (a
// multiple of 16) by the copy engine, both completing on the mbarrier
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* mbar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
          "r"(smem_u32(mbar)) : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          uint64_t* mbar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(mbar)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* mbar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(mbar)), "r"(count)
                 : "memory");
}

// arrive, and expect bytes more from the copy engine in this phase
__device__ __forceinline__ void mbar_arrive(uint64_t* mbar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(mbar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* mbar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(mbar)), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// wgmma descriptor of a K-major operand in shared memory without swizzle:
// core matrices of 8 rows x 16 bytes, the two 4-feature halves of a k8 step
// 128 bytes apart (leading byte offset), 8-row groups 256 bytes apart
// (stride byte offset)
__device__ __forceinline__ uint64_t kmajor_desc(const float* p) {
    const uint64_t addr = smem_u32(p);
    return ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
           (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d[64 x 128] = a[64 x 8] b[128 x 8]^T (+ d when accumulate), a from
// registers, b from shared memory, tf32 inputs and f32 accumulators
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
          "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
          "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ float finish(float na2, float nb2, float cross,
                                        float inv_na, float inv_nb) {
    return sqrtf(fmaxf(na2 + nb2 - 2.0f * cross * inv_na * inv_nb, 0.0f));
}

// n2[r] = sum_j m_j x_rj^2 / n_r^2 over the rows of a, then of b
__global__ void __launch_bounds__(NORM_THREADS)
weighted_norms_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ m, const float* __restrict__ na,
                      const float* __restrict__ nb, float* __restrict__ n2,
                      int Q, int D) {
    const int r = blockIdx.x;
    const float* x = r < Q ? a + (size_t)r * D : b + (size_t)(r - Q) * D;
    float acc = 0.0f;
    for (int j = threadIdx.x; j < D; j += NORM_THREADS) {
        const float v = x[j];
        acc = fmaf(m[j] * v, v, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    __shared__ float warp_sum[NORM_THREADS / 32];
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < NORM_THREADS / 32; ++w) s += warp_sum[w];
        const float n = r < Q ? na[r] : nb[r - Q];
        n2[r] = s / (n * n);
    }
}

// the float offset of x within its 16-byte block
__device__ __forceinline__ int shift16(const float* x) {
    return (int)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
}

// bytes of the 16-byte copy from src that lie before end (0 .. 16)
__device__ __forceinline__ int bytes_before(const float* src, const float* end) {
    return (int)max(0ll, min(16ll, (long long)(end - src) * 4));
}

// the producer warpgroups: the raw a and b chunks into the ring (2D TMA,
// or cp.async of aligned windows), and the split of b into B_hi / B_lo
template <bool TMA>
__device__ __forceinline__ void produce(const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        const float* __restrict__ m,
                                        const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        float* ring, uint64_t* landed, int Q, int T, int D,
                                        int q0, int t0, int f_begin, int f_end, int nchunks,
                                        int ptid) {
    using L = Layout<TMA>;
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int len = f_end - f_begin;

    // cp.async route: lane lw = ptid % 8 copies 16-byte block lw of the
    // windows of rows lr, lr + 32, ... of a and b; thread ptid copies block
    // 8 of row ptid of a (ptid < TILE) or of b
    constexpr int LSTEP = PRODUCERS / 8;
    const int lr = ptid / 8, lw = ptid % 8;
    const size_t pass = (size_t)LSTEP * D;
    const float* pa = a + (size_t)(q0 + lr) * D + f_begin;
    const float* pb = b + (size_t)(t0 + lr) * D + f_begin;
    const int r8 = ptid % TILE;
    const bool on_a = ptid < TILE;
    const float* p8 = on_a ? a + (size_t)(q0 + r8) * D + f_begin : b + (size_t)(t0 + r8) * D + f_begin;
    const bool need8 = (on_a ? q0 + r8 < Q : t0 + r8 < T) && shift16(p8) > 0;
    const int dst8 = (on_a ? L::RAW_A : L::RAW_B) + r8 * L::RAW_LD + 32;

    // block k of the window of the row whose slice starts at row, or
    // nothing when the row is out of range; features past the slice are
    // zero-filled (every block is whole when the window ends inside the
    // slice)
    auto copy = [&](float* dst, const float* row, int k, int c, bool valid, bool whole) {
        const float* src = reinterpret_cast<const float*>(
                               reinterpret_cast<uintptr_t>(row + c * BK) & ~uintptr_t(15)) + 4 * k;
        const int bytes = whole ? 16 : bytes_before(src, row + len);
        cp_async16(dst, valid ? src : a, valid ? bytes : 0);
    };
    auto load = [&](int c) {
        float* st = ring + (c % STAGES) * L::STAGE;
        if constexpr (TMA) {
            // one thread: both boxes (rows and features past the operand
            // zero-filled) and the weights, cut at the end of m
            if (ptid == 0) {
                uint64_t* mbar = landed + c % STAGES;
                const float* msrc = m + f_begin + c * BK;
                const int mbytes = (int)(((min((long long)BK, (long long)(m + D - msrc)) + 3) & ~3ll) * 4);
                mbar_arrive(mbar, 2 * TILE * BK * (int)sizeof(float) + mbytes);
                tma_load(st + L::RAW_A, map_a, f_begin + c * BK, q0, mbar);
                tma_load(st + L::RAW_B, map_b, f_begin + c * BK, t0, mbar);
                bulk_copy(st + L::M_OFF, msrc, mbytes, mbar);
            }
        } else {
            const bool whole = c * BK + L::RAW_LD <= len;
#pragma unroll
            for (int i = 0; i < TILE / LSTEP; ++i) {
                const int r = lr + i * LSTEP;
                copy(st + L::RAW_A + r * L::RAW_LD + 4 * lw, pa + i * pass, lw, c, q0 + r < Q, whole);
                copy(st + L::RAW_B + r * L::RAW_LD + 4 * lw, pb + i * pass, lw, c, t0 + r < T, whole);
            }
            if (need8) copy(st + dst8, p8, 8, c, true, whole);
            if (ptid < BK / 4) {
                const float* src = m + f_begin + c * BK + 4 * ptid;
                cp_async16(st + L::M_OFF + 4 * ptid, src, bytes_before(src, m + f_end));
            }
            cp_async_commit();
        }
    };

#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
        if (p < nchunks) {
            load(p);
        } else if constexpr (!TMA) {
            cp_async_commit();
        }
    }

    // split mapping: warp w covers the 8-row groups 2 w and 2 w + 1, a step
    // 8 rows (lane / 4) x 4 features (lane % 4)
    constexpr int GROUPS = TILE / 8 / (PRODUCERS / 32);
    const int lane = ptid & 31, pw = ptid >> 5, g4 = lane >> 2, t4 = lane & 3;
    int src0[GROUPS];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
        const int r = (pw * GROUPS + j) * 8 + g4;
        src0[j] = L::RAW_B + r * L::RAW_LD + t4 +
                  (TMA ? 0 : shift16(b + (size_t)(t0 + r) * D + f_begin));
    }
    for (int c = 0; c < nchunks; ++c) {
        if constexpr (TMA) {
            mbar_wait(landed + c % STAGES, (c / STAGES) & 1);
        } else {
            cp_async_wait<STAGES - 2>();
            // chunk c has landed for every producer thread
            bar_sync(BAR_PRODUCER, PRODUCERS);
        }
        float* st = ring + (c % STAGES) * L::STAGE;
        // TMA copies whole boxes: a slice's last chunk may hold the next
        // slice's features, masked here and in the split of a
        const int valid_f = TMA ? min(BK, len - c * BK) : BK;
#pragma unroll
        for (int kq = 0; kq < BK / 4; ++kq) {
#pragma unroll
            for (int j = 0; j < GROUPS; ++j) {
                float x = st[src0[j] + (TMA ? (kq ^ g4) << 2 : kq * 4)];
                if (valid_f < BK && kq * 4 + t4 >= valid_f) x = 0.0f;
                const int dst = (kq >> 1) * (TILE * 8) + (pw * GROUPS + j) * 64 + (kq & 1) * 32 + g4 * 4 + t4;
                const uint32_t hi = tf32_rna(x);
                st[L::B_HI + dst] = __uint_as_float(hi);
                st[L::B_LO + dst] = __uint_as_float(tf32_rna(x - __uint_as_float(hi)));
            }
        }
        // the generic-proxy stores become visible to wgmma; the consumers
        // may start on chunk c
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(BAR_FULL + c % STAGES, THREADS);
        // refill the stage of chunk c - 1 once the consumers release it
        if (c + STAGES - 1 < nchunks) {
            if (c > 0) bar_sync(BAR_EMPTY + (c - 1) % STAGES, THREADS);
            load(c + STAGES - 1);
        } else if constexpr (!TMA) {
            cp_async_commit();
        }
    }
    if constexpr (!TMA) cp_async_wait<0>();
    // match the consumers' releases of the last stages
    for (int c = max(nchunks - STAGES, 0); c < nchunks; ++c)
        bar_sync(BAR_EMPTY + c % STAGES, THREADS);
}

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
dist_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ m, const float* __restrict__ na,
                 const float* __restrict__ nb, const float* __restrict__ n2,
                 float* __restrict__ out, float* __restrict__ part,
                 int Q, int T, int D, int S,
                 const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b) {
    using L = Layout<TMA>;
    extern __shared__ __align__(128) unsigned char smem[];
    float* ring = reinterpret_cast<float*>(                 // [STAGES][STAGE]
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    float* factors = ring + STAGES * L::STAGE;             // 1/na, na2, 1/nb, nb2
    uint64_t* landed = reinterpret_cast<uint64_t*>(factors + FACTORS);  // TMA route

    const int tiles_q = (Q + TILE - 1) / TILE, tiles_t = (T + TILE - 1) / TILE;
    const bool q_on_x = tiles_q >= tiles_t;
    const int q0 = (q_on_x ? blockIdx.x : blockIdx.y) * TILE;
    const int t0 = (q_on_x ? blockIdx.y : blockIdx.x) * TILE;
    const int s = blockIdx.z;
    const long long units = D > 0 ? ((long long)D + UNIT - 1) / UNIT : 1;
    const int f_begin = (int)min((long long)D, UNIT * (s * units / S));
    const int f_end = (int)min((long long)D, UNIT * ((s + 1) * units / S));
    const int nchunks = (f_end - f_begin + BK - 1) / BK;

    const int tid = threadIdx.x;
    if (TMA && tid < STAGES) mbar_init(landed + tid, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    if (tid >= CONSUMERS) {
        produce<TMA>(a, b, m, &map_a, &map_b, ring, landed, Q, T, D, q0, t0, f_begin, f_end,
                     nchunks, tid - CONSUMERS);
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (S == 1) {
        if (tid < TILE) {
            const int q = q0 + tid;
            factors[tid] = q < Q ? 1.0f / na[q] : 0.0f;
            factors[TILE + tid] = q < Q ? n2[q] : 0.0f;
        } else {
            const int t = t0 + tid - TILE;
            factors[TILE + tid] = t < T ? 1.0f / nb[t] : 0.0f;
            factors[2 * TILE + tid] = t < T ? n2[Q + t] : 0.0f;
        }
    }

    // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile; this
    // thread's A fragment rows are ar and ar + 8, features 8 ks + lane % 4
    // and 4 more
    const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
    const int g4 = lane >> 2, t4 = lane & 3;
    const int ar = wg * WG_ROWS + (warp & 3) * 16 + g4;
    const int src0 = L::RAW_A + ar * L::RAW_LD + t4 +
                     (TMA ? 0 : shift16(a + (size_t)(q0 + ar) * D + f_begin));
    const int src1 = L::RAW_A + (ar + 8) * L::RAW_LD + t4 +
                     (TMA ? 0 : shift16(a + (size_t)(q0 + ar + 8) * D + f_begin));
    // feature k of the thread's rows (both have row % 8 == lane / 4)
    auto at = [&](int src, int k) { return src + (TMA ? ((k >> 2) ^ g4) << 2 : k); };
    float acc[64], chunk[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = chunk[i] = 0.0f;

    for (int c = 0; c < nchunks; ++c) {
        const float* st = ring + (c % STAGES) * L::STAGE;
        const int valid_f = TMA ? min(BK, f_end - f_begin - c * BK) : BK;
        // weight and split a in registers: (row, feature) of fragment
        // registers 0..3 is (ar, k), (ar + 8, k), (ar, k + 4), (ar + 8, k + 4)
        auto split_a = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
            const int k = ks * 8;
            const float m0 = st[L::M_OFF + k + t4], m1 = st[L::M_OFF + k + 4 + t4];
            float x[4] = {st[at(src0, k)] * m0, st[at(src1, k)] * m0,
                          st[at(src0, k + 4)] * m1, st[at(src1, k + 4)] * m1};
            if (valid_f < BK) {
                if (k + t4 >= valid_f) x[0] = x[1] = 0.0f;
                if (k + 4 + t4 >= valid_f) x[2] = x[3] = 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                hi[i] = tf32_rna(x[i]);
                lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
            }
        };
        bar_sync(BAR_FULL + c % STAGES, THREADS);
        // the TMA writes of a become visible here too
        if (TMA) mbar_wait(landed + c % STAGES, (c / STAGES) & 1);
        uint32_t hi[KSTEPS][4], lo[KSTEPS][4];
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) split_a(ks, hi[ks], lo[ks]);
        // the chunk's 12 products go into chunk[] (the first one overwrites
        // it), and chunk[] into acc[] with f32 adds that round to nearest
        // (see the header)
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            const float* bhi = st + L::B_HI + ks * TILE * 8;
            const float* blo = st + L::B_LO + ks * TILE * 8;
            // the small terms first
            wgmma_tf32(chunk, lo[ks], kmajor_desc(bhi), ks > 0);
            wgmma_tf32(chunk, hi[ks], kmajor_desc(blo), 1);
            wgmma_tf32(chunk, hi[ks], kmajor_desc(bhi), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(chunk);
        bar_arrive(BAR_EMPTY + c % STAGES, THREADS);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += chunk[i];
    }

    // epilogue: the accumulators through shared memory (the ring is free
    // once both consumer warpgroups are past their last products), then
    // coalesced rows to global memory.  acc[4 j + i] is row ar (+8 for
    // i >= 2), column 8 j + 2 (lane % 4) (+1 for odd i).
    bar_sync(BAR_CONSUMER, CONSUMERS);
    float* tile = ring;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
        const int col = j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(tile + ar * EPI_LD + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(tile + (ar + 8) * EPI_LD + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    bar_sync(BAR_CONSUMER, CONSUMERS);
    // warp w writes rows w, w + 8, ...: 128 consecutive columns each
    float* dst = S == 1 ? out : part + (size_t)s * Q * T;
    for (int r = warp; r < TILE && q0 + r < Q; r += CONSUMERS / 32) {
        const size_t row = (size_t)(q0 + r) * T + t0;
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
            const int col = lane + 32 * i;
            if (t0 + col >= T) break;
            const float cross = tile[r * EPI_LD + col];
            dst[row + col] = S == 1 ? finish(factors[TILE + r], factors[3 * TILE + col], cross,
                                             factors[r], factors[2 * TILE + col])
                                    : cross;
        }
    }
}

// the slices' partial cross terms summed in the order s = 0 .. S-1, then
// the epilogue
__global__ void split_finish_kernel(const float* __restrict__ part,
                                    const float* __restrict__ na,
                                    const float* __restrict__ nb,
                                    const float* __restrict__ n2,
                                    float* __restrict__ out, int Q, int T, int S) {
    const size_t n = (size_t)Q * T;
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        float cross = 0.0f;
        for (int s = 0; s < S; ++s) cross += part[(size_t)s * n + i];
        const int q = (int)(i / T), t = (int)(i % T);
        out[i] = finish(n2[q], n2[Q + t], cross, 1.0f / na[q], 1.0f / nb[t]);
    }
}

// the 2D tensor map of rows [R, D] (row stride a multiple of 16 bytes),
// boxes of BK features x TILE rows, 128-byte swizzle, zeros out of range
cudaError_t encode_rows(CUtensorMap* map, const float* x, int R, int D) {
    static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
        encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)R};
    const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
    const cuuint32_t box[2] = {BK, TILE}, unit[2] = {1, 1};
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x),
                                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// ws: Q + T floats for the row norms, then S * Q * T for the partial cross
// terms when S > 1
extern "C" int kpop_pairwise_dist(const float* a, const float* b, const float* m,
                                  const float* na, const float* nb, float* out,
                                  float* ws, int Q, int T, int D, int S,
                                  void* stream) {
    if (Q <= 0 || T <= 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    float* n2 = ws;
    float* part = ws + (size_t)Q + T;

    weighted_norms_kernel<<<Q + T, NORM_THREADS, 0, st>>>(a, b, m, na, nb, n2, Q, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int tiles_q = (Q + TILE - 1) / TILE, tiles_t = (T + TILE - 1) / TILE;
    const dim3 grid(max(tiles_q, tiles_t), min(tiles_q, tiles_t), S);
    // TMA when the row stride is a multiple of 16 bytes
    const bool tma = D > 0 && D % 4 == 0;
    CUtensorMap map_a{}, map_b{};
    if (tma) {
        err = encode_rows(&map_a, a, Q, D);
        if (err == cudaSuccess) err = encode_rows(&map_b, b, T, D);
        if (err != cudaSuccess) return (int)err;
    }
    // the shared-memory opt-in, once per device and route
    static unsigned long long opted_in[2] = {0, 0};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !(opted_in[tma] >> dev & 1)) {
        err = tma ? cudaFuncSetAttribute(dist_tile_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<true>::SMEM_BYTES)
                  : cudaFuncSetAttribute(dist_tile_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<false>::SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) opted_in[tma] |= 1ull << dev;
    }
    if (tma)
        dist_tile_kernel<true><<<grid, THREADS, Layout<true>::SMEM_BYTES, st>>>(
            a, b, m, na, nb, n2, out, part, Q, T, D, S, map_a, map_b);
    else
        dist_tile_kernel<false><<<grid, THREADS, Layout<false>::SMEM_BYTES, st>>>(
            a, b, m, na, nb, n2, out, part, Q, T, D, S, map_a, map_b);
    err = cudaGetLastError();
    if (err != cudaSuccess || S == 1) return (int)err;

    const size_t n = (size_t)Q * T;
    const int blocks = (int)min((n + 255) / 256, (size_t)4096);
    split_finish_kernel<<<blocks, 256, 0, st>>>(part, na, nb, n2, out, Q, T, S);
    return (int)cudaGetLastError();
}
