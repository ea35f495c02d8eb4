// The CA Gram of the standardized residual, with the residual rebuilt on
// the fly from the compact table:
//
//     G = S^T S,   S[k, j] = x[k, j] alpha[k] beta[j] - u[k] v[j]
//
// in float64, for a wire table x [K, ns] of u8, u16, f32 or f64 and f64
// vectors alpha, u [K] and beta, v [ns].  Replaces the Gram of
// kpop_tpu/parallel/sharded.py::ca_fit_sharded: _gram_dd_from_compact_local
// (the resident compact path) with ops/dd.py::residual_dd.  The TPU has no
// float64, so the JAX package rebuilds S in double-double f32 limbs and sums
// S^T S as hi'hi + hi'lo + lo'hi with a Kahan carry across row blocks.  The
// H100 has float64 and FP64 tensor cores, so this kernel rebuilds S in
// float64 and multiplies on the FP64 tensor cores (DMMA,
// mma.sync.aligned.m16n8k8.row.col.f64: m8n8k4 runs at half the rate on the
// H100), with no limbs and no carry.  As in the JAX package, S never sits
// in device memory at 8 bytes an entry: the table stays on the card in its
// smallest exact wire type (188 MB of u8 at the headline 367,987 k-mers x
// 512 classes) and S exists only one chunk at a time, in shared memory.
//
// What bounds it on the H100: K ns (ns + 1) floating-point operations for
// the distinct entries of the symmetric G, 9.7e10 at the headline shape,
// about 1.44 ms at the 67 TFLOP/s of the FP64 tensor cores; the table is
// read in 0.06 ms.  So it is bound by operations.  The kernel does the
// products of 36 of the 64 tiles of G (1.09e11), and rebuilds each entry
// of S once for every tile of its column panel.  The rebuild's float64
// arithmetic shares the FP64 pipes with the products, so it is cut to a
// fused multiply-add and at most one multiply an entry:
//
//     S[k, j] = beta[j] alpha[k] T[k, j],   T[k, j] = x[k, j] - rho[k] gamma[j]
//     G[i, j] = beta[i] beta[j] sum_k (alpha[k]^2 T[k, i]) T[k, j]
//
// with rho = u / alpha and gamma = v / beta, which factors_kernel computes
// first (kpop_tpu_torch/ops/gram.py::factors is its plain version).  That
// is S exactly wherever alpha[k] = 0 implies u[k] = 0 and beta[j] = 0
// implies v[j] = 0, which the CA's vectors satisfy by construction;
// elsewhere rho or gamma is NaN and G comes out NaN.  T is
// the residual of the counts against their expectation rho gamma: no more
// cancellation than S's.  Loads of gamma from shared memory for each entry
// cost more than the arithmetic, so each thread holds the gamma of its 32
// columns in registers (232-248 of them: two blocks a multiprocessor).
//
// The design.  A block of 128 threads owns one 64 x 64 tile (I, J), J >= I,
// of G and one slice of the k-mer axis.  It walks its slice in chunks of 32
// rows.  Thread t rebuilds row t % 32 of the chunk in columns
// 16 (t / 32) .. 16 (t / 32) + 15 of both column panels, from 16-byte loads
// of the table when rows are 16-byte aligned (ns % 16 == 0), with alpha, u
// rho of its row and gamma of its columns in registers; it stores
// alpha^2 T in panel I and T in panel J (on a diagonal tile, one panel of
// alpha T serves both).  The panels are k-minor ([column][row], rows padded
// to 36), so both these stores and the DMMA fragment loads are free of bank
// conflicts.  The four warps, 2 x 2 over the tile, each run 2 x 4 DMMA
// tiles of 16 x 8 over the chunk, the sums held in registers.  The chunks
// are software-pipelined over two shared-memory buffers: the loads of chunk
// c + 1 are in flight into registers while the tensor cores multiply chunk
// c, then chunk c + 1 is rebuilt into the other buffer, one barrier per
// chunk.  Columns past ns and rows past the slice are rebuilt as 0, so
// nothing is padded.  The tile is scaled by beta[i] beta[j], written to its
// place and, off the diagonal, mirrored to (J, I).
//
// Split-K.  The grid is the nb (nb + 1) / 2 upper tiles (nb = ceil(ns / 64))
// on x and S slices of the k-mer axis on y (kpop_tpu_torch/ops/gram.py::
// split_plan: about three whole waves of two blocks an SM); slice s covers rows
// [s R, min(K, (s + 1) R)) for R rows per slice.  Blocks of one slice run
// together and share its rows in L2.  With S = 1 the tiles go straight to
// G; with S > 1 each slice writes its own [ns, ns] in an f64 workspace and
// slice_sum_kernel adds the slices in the order s = 0, 1, ..., S - 1:
// bit-reproducible, no float atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // output tile edge
constexpr int CHUNK = 32;     // k-mer rows per shared-memory chunk
constexpr int THREADS = 128;  // four warps, 2 x 2 over the tile
constexpr int LDK = CHUNK + 4;  // padded k-minor column: conflict-free
constexpr int SEG = TILE / (THREADS / CHUNK);  // columns a thread rebuilds
constexpr int PANEL = TILE * LDK;
// two buffers of the two panels
constexpr size_t SMEM_BYTES = 2 * 2 * PANEL * sizeof(double);

// D += A B on the FP64 tensor cores, 16 x 8 x 8.  Fragments (PTX ISA,
// mma.m16n8k8 .f64): g = lane / 4, q = lane % 4;
// a = A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4];  b = B[q][g], B[q+4][g];
// c = C[g][2q], C[g][2q+1], C[g+8][2q], C[g+8][2q+1].
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// SEG consecutive table values of one row, held as 16-byte words
template <typename T>
struct Seg {
    uint4 w[SEG * sizeof(T) / 16];
    __device__ __forceinline__ T& operator[](int j) { return reinterpret_cast<T*>(w)[j]; }
    __device__ __forceinline__ T operator[](int j) const {
        return reinterpret_cast<const T*>(w)[j];
    }
};

// one row's segment of a column panel: 16-byte loads when VEC (ns % 16 ==
// 0, x on 16 bytes), else one masked load a value
template <typename T, bool VEC>
__device__ __forceinline__ void load_seg(Seg<T>& s, const T* row, int c, int ns, bool ok) {
    if (VEC) {  // ns % 16 == 0: a segment lies wholly inside or past ns
        const uint4* p = reinterpret_cast<const uint4*>(row + c);
        const bool in = ok && c < ns;
#pragma unroll
        for (int i = 0; i < (int)(sizeof(s.w) / 16); ++i)
            s.w[i] = in ? p[i] : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
        for (int j = 0; j < SEG; ++j) s[j] = ok && c + j < ns ? row[c + j] : T(0);
    }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
gram_tile_kernel(const T* __restrict__ x, int K, int ns,
                 const double* __restrict__ alpha, const double* __restrict__ rho,
                 const double* __restrict__ beta, const double* __restrict__ gamma,
                 int rows_per_slice, double* __restrict__ out) {
    extern __shared__ double sS[];  // [buffer][panel][column][LDK]

    // upper tile (bi, bj), bi <= bj, from the linear index: row bi holds
    // the nb - bi tiles bj = bi, ..., nb - 1
    const int nb = (ns + TILE - 1) / TILE;
    int t = blockIdx.x, bi = 0;
    while (t >= nb - bi) {
        t -= nb - bi;
        ++bi;
    }
    const int bj = bi + t;
    const bool diag = bi == bj;
    const int I0 = bi * TILE, J0 = bj * TILE;
    const long k_begin = (long)blockIdx.y * rows_per_slice;
    const long k_end = min((long)K, k_begin + rows_per_slice);
    const int n_chunks = (int)max(0L, (k_end - k_begin + CHUNK - 1) / CHUNK);
    const int tid = threadIdx.x;

    // the rebuild: row r of the chunk, columns c0 .. c0 + SEG - 1 of each
    // panel; rows past the slice load x = 0 and alpha = rho = 0, columns
    // past ns x = 0 and gamma = 0, so they rebuild to 0
    const int r = tid % CHUNK;
    const int c0 = (tid / CHUNK) * SEG;
    double gI[SEG], gJ[SEG];  // gamma of the thread's columns, for the block
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
        gI[j] = I0 + c0 + j < ns ? gamma[I0 + c0 + j] : 0.0;
        gJ[j] = J0 + c0 + j < ns ? gamma[J0 + c0 + j] : 0.0;
    }
    Seg<T> nI, nJ;
    double n_alpha = 0.0, n_rho = 0.0;
    auto load = [&](int c) {
        const long k = k_begin + (long)c * CHUNK + r;
        const bool ok = k < k_end;
        const T* row = x + (size_t)k * ns;
        load_seg<T, VEC>(nI, row, I0 + c0, ns, ok);
        if (!diag) load_seg<T, VEC>(nJ, row, J0 + c0, ns, ok);
        n_alpha = ok ? alpha[k] : 0.0;
        n_rho = ok ? rho[k] : 0.0;
    };
    auto rebuild = [&](int buf) {
        double* pI = sS + (buf * 2) * PANEL;
        double* pJ = pI + PANEL;
        const double a = n_alpha, p = -n_rho;
        if (diag) {
#pragma unroll
            for (int j = 0; j < SEG; ++j)
                pI[(c0 + j) * LDK + r] = a * fma(p, gI[j], (double)nI[j]);
        } else {
            const double a2 = a * a;
#pragma unroll
            for (int j = 0; j < SEG; ++j) {
                pI[(c0 + j) * LDK + r] = a2 * fma(p, gI[j], (double)nI[j]);
                pJ[(c0 + j) * LDK + r] = fma(p, gJ[j], (double)nJ[j]);
            }
        }
    };

    // the products: warp (wm, wn) owns rows wm..wm+31, columns wn..wn+31
    // of the tile, as 2 x 4 tiles of 16 x 8; A[m][k] = panel I [m][k],
    // B[k][n] = panel J [n][k]
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, q = lane & 3;
    double acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
    auto products = [&](int buf) {
        const double* pI = sS + (buf * 2) * PANEL;
        const double* pJ = diag ? pI : pI + PANEL;
#pragma unroll
        for (int kk = 0; kk < CHUNK; kk += 8) {
            double fa[2][4], fb[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const double* p0 = pI + (wm + mi * 16 + g) * LDK + kk + q;
                const double* p1 = p0 + 8 * LDK;
                fa[mi][0] = p0[0];
                fa[mi][1] = p1[0];
                fa[mi][2] = p0[4];
                fa[mi][3] = p1[4];
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const double* p = pJ + (wn + ni * 8 + g) * LDK + kk + q;
                fb[ni][0] = p[0];
                fb[ni][1] = p[4];
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) dmma(acc[mi][ni], fa[mi], fb[ni]);
        }
    };

    // software pipeline: while the tensor cores multiply chunk c, the
    // loads of chunk c + 1 are in flight into registers; chunk c + 1 is
    // then rebuilt into the other buffer, with one barrier per chunk
    if (n_chunks > 0) load(0);
    rebuild(0);
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
        const int buf = c & 1;
        const bool next = c + 1 < n_chunks;
        if (next) load(c + 1);
        products(buf);
        if (next) rebuild(buf ^ 1);
        __syncthreads();
    }

    double* G = out + (size_t)blockIdx.y * ns * ns;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = I0 + wm + mi * 16 + g + (e >> 1) * 8;
            if (i >= ns) continue;
            const double b_i = beta[i];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int j = J0 + wn + ni * 8 + 2 * q + (e & 1);
                if (j < ns) {
                    const double val = acc[mi][ni][e] * (b_i * beta[j]);
                    G[(size_t)i * ns + j] = val;
                    if (!diag) G[(size_t)j * ns + i] = val;
                }
            }
        }
}

// rho = u / alpha and gamma = v / beta: 0 where the divisor and the
// dividend are 0, NaN where only the divisor is (S has no such factors
// there, and G comes out NaN rather than wrong)
__global__ void factors_kernel(const double* __restrict__ alpha, const double* __restrict__ u,
                               int K, const double* __restrict__ beta,
                               const double* __restrict__ v, int ns,
                               double* __restrict__ rho, double* __restrict__ gamma) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < K + ns;
         i += gridDim.x * blockDim.x) {
        const bool row = i < K;
        const double num = row ? u[i] : v[i - K], den = row ? alpha[i] : beta[i - K];
        const double f = den != 0.0 ? num / den : (num == 0.0 ? 0.0 : __longlong_as_double(0x7ff8000000000000LL));
        if (row) rho[i] = f; else gamma[i - K] = f;
    }
}

__global__ void slice_sum_kernel(const double* __restrict__ ws, int slices,
                                 size_t n, double* __restrict__ out) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        double s = 0.0;
        for (int j = 0; j < slices; ++j) s += ws[(size_t)j * n + i];
        out[i] = s;
    }
}

template <typename T>
cudaError_t launch_tiles(const void* x, int K, int ns, const double* alpha,
                         const double* rho, const double* beta, const double* gamma,
                         int slices, int rows_per_slice, double* dst,
                         cudaStream_t stream) {
    const bool vec = ns % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto kernel = vec ? gram_tile_kernel<T, true> : gram_tile_kernel<T, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const int nb = (ns + TILE - 1) / TILE;
    const dim3 grid(nb * (nb + 1) / 2, slices);
    kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        static_cast<const T*>(x), K, ns, alpha, rho, beta, gamma, rows_per_slice, dst);
    return cudaGetLastError();
}

}  // namespace

// wire: 0 u8, 1 u16, 2 f32, 3 f64.  workspace: K + ns f64 for rho and
// gamma, then [slices, ns, ns] f64 when slices > 1.
extern "C" int kpop_ca_gram(const void* x, int wire, int K, int ns,
                            const double* alpha, const double* u,
                            const double* beta, const double* v, int slices,
                            int rows_per_slice, double* out, double* workspace,
                            void* stream) {
    if (K <= 0 || ns <= 0 || slices <= 0 || rows_per_slice <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    double* rho = workspace;
    double* gamma = rho + K;
    const int fblocks = (K + ns + 255) / 256 < 1024 ? (K + ns + 255) / 256 : 1024;
    factors_kernel<<<fblocks, 256, 0, st>>>(alpha, u, K, beta, v, ns, rho, gamma);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    double* partial = gamma + ns;
    double* dst = slices > 1 ? partial : out;
    switch (wire) {
        case 0: err = launch_tiles<uint8_t>(x, K, ns, alpha, rho, beta, gamma, slices, rows_per_slice, dst, st); break;
        case 1: err = launch_tiles<uint16_t>(x, K, ns, alpha, rho, beta, gamma, slices, rows_per_slice, dst, st); break;
        case 2: err = launch_tiles<float>(x, K, ns, alpha, rho, beta, gamma, slices, rows_per_slice, dst, st); break;
        case 3: err = launch_tiles<double>(x, K, ns, alpha, rho, beta, gamma, slices, rows_per_slice, dst, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess || slices == 1) return (int)err;
    const size_t n = (size_t)ns * ns;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    slice_sum_kernel<<<blocks, 256, 0, st>>>(partial, slices, n, out);
    return (int)cudaGetLastError();
}
