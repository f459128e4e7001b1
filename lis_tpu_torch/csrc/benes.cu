// Kernels B, C, D · the Benes shuffle passes of the CST SpMV.
//
// A Benes pass with digit d = 128 and stride s views the flat (M,) array
// as x[p, a, w] (p < M/(128 s), a < 128, w < s) and permutes a within
// every column (p, w):
//
//     out[p, a, w] = x[p, idx[p s + w, a], w]        idx: (M/128, 128) uint8
//
// B · benes_pass         replaces lis_tpu/ops/shuffle.py::_fused_pass32
//                        (pallas_call at :450 and :473)
// C · benes_pass_rowsum  replaces ::_fused_pass_rowsum32 (:544, :568)
// D · benes_small_run    replaces ::_fused_small32 (:652)
//
// Bound on the H100: bytes.  A pass reads 8 B of x (f64) and 1 B of idx
// and writes 8 B per slot; the row-sum pass writes 8/Kp B; a fused run of
// k passes pays one read and one write for all k.  The gathers themselves
// stay in shared memory, where their random lane order costs nothing in
// device-memory traffic.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B and C: one block owns kRows consecutive idx rows r = p s + w.  When
// s >= kRows those rows share p and cover w0..w0+kRows-1, so the block's x
// tile is 128 strided runs of kRows contiguous values; when s < kRows they
// cover kRows/s whole (128, s) panels, one contiguous run.  Either way the
// tile lands in shared memory as xs[a][j] (j = r - r0), the idx rows as
// is[j][a], and the output is read back as xs[is[j][a]][j].
// ---------------------------------------------------------------------------
constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kIdxPitch = 132;      // bytes: 4-aligned, spreads the banks

// Global offset and tile coordinates of the e-th element of the tile.
// The element order makes consecutive e contiguous in memory.
__device__ __forceinline__ int64_t tile_elem(int e, int64_t r0, int ls,
                                             int& j, int& a) {
    if (ls >= 5) {                                  // s >= kRows
        a = e >> 5;
        j = e & (kRows - 1);
        const int64_t p = r0 >> ls;
        const int64_t w0 = r0 & ((int64_t(1) << ls) - 1);
        return (p << (ls + 7)) + ((int64_t)a << ls) + w0 + j;
    }
    const int pl = e >> (ls + 7);                   // panel within tile
    const int rem = e & ((128 << ls) - 1);
    a = rem >> ls;
    j = (pl << ls) + (rem & ((1 << ls) - 1));
    return r0 * 128 + e;
}

template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x,
                                          const uint8_t* __restrict__ idx,
                                          int64_t r0, int ls,
                                          T (*xs)[kRows + 1],
                                          uint8_t (*is)[kIdxPitch]) {
    const uint32_t* ig = reinterpret_cast<const uint32_t*>(idx + r0 * 128);
    for (int e = threadIdx.x; e < kRows * 32; e += kThreads) {
        *reinterpret_cast<uint32_t*>(&is[e >> 5][(e & 31) * 4]) = ig[e];
    }
    for (int e = threadIdx.x; e < kRows * 128; e += kThreads) {
        int j, a;
        const int64_t off = tile_elem(e, r0, ls, j, a);
        xs[a][j] = x[off];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
benes_pass_kernel(const T* __restrict__ x, const uint8_t* __restrict__ idx,
                  T* __restrict__ out, int ls) {
    __shared__ T xs[128][kRows + 1];
    __shared__ __align__(16) uint8_t is[kRows][kIdxPitch];
    const int64_t r0 = (int64_t)blockIdx.x * kRows;
    load_tile(x, idx, r0, ls, xs, is);
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * 128; e += kThreads) {
        int j, a;
        const int64_t off = tile_elem(e, r0, ls, j, a);
        out[off] = xs[is[j][a]][j];
    }
}

// C: the same tile, then sums of Kp consecutive w of every (p, a).  The
// sum of the group starting at row r lands at y[F / Kp] with F the flat
// slot of (p, a, w).  Kp < kRows: a tile holds kRows/Kp whole groups per
// a.  Kp >= kRows: a block walks Kp/kRows tiles and thread a carries its
// running sum across them (summation order: w ascending, in runs of
// kRows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
benes_pass_rowsum_kernel(const T* __restrict__ x,
                         const uint8_t* __restrict__ idx,
                         T* __restrict__ y, int ls, int lkp) {
    __shared__ T xs[128][kRows + 1];
    __shared__ __align__(16) uint8_t is[kRows][kIdxPitch];
    const int kp = 1 << lkp;
    const int ntile = kp > kRows ? kp / kRows : 1;
    const int64_t rb = (int64_t)blockIdx.x * kRows * ntile;
    const int64_t smask = (int64_t(1) << ls) - 1;
    T acc = T(0);
    for (int t = 0; t < ntile; ++t) {
        const int64_t r0 = rb + (int64_t)t * kRows;
        load_tile(x, idx, r0, ls, xs, is);
        __syncthreads();
        if (kp >= kRows) {
            if (threadIdx.x < 128) {
                const int a = threadIdx.x;
                T s = T(0);
                for (int j = 0; j < kRows; ++j) s += xs[is[j][a]][j];
                acc += s;
            }
        } else {
            const int gpt = kRows >> lkp;               // groups per a
            for (int o = threadIdx.x; o < 128 * gpt; o += kThreads) {
                const int a = o / gpt;
                const int j0 = (o % gpt) << lkp;
                T s = T(0);
                for (int jj = 0; jj < kp; ++jj) {
                    const int j = j0 + jj;
                    s += xs[is[j][a]][j];
                }
                const int64_t r = r0 + j0;
                const int64_t F = ((r >> ls) << (ls + 7))
                                  + ((int64_t)a << ls) + (r & smask);
                y[F >> lkp] = s;
            }
        }
        __syncthreads();
    }
    if (kp >= kRows && threadIdx.x < 128) {
        const int64_t F = ((rb >> ls) << (ls + 7))
                          + ((int64_t)threadIdx.x << ls) + (rb & smask);
        y[F >> lkp] = acc;
    }
}

// ---------------------------------------------------------------------------
// D: a run of passes with s in {1, 128} never moves a value out of its
// aligned 16384-slot tile T[a][w] (slot = b*16384 + a*128 + w).  An s = 1
// pass gathers within row a (T[a][w] <- T[a][idx[b*128+a][w]]), an
// s = 128 pass within column w (T[a][w] <- T[idx[b*128+w][a]][w]).  One
// block holds one tile in shared memory (pitch 129 so a column walk hits
// distinct banks: 132,096 B at f64, under the 227 KB limit but with no
// room for a second buffer), so each pass gathers in place: a warp owns a
// whole row or column, reads its 128 gathered values into registers,
// __syncwarp()s, then writes them back.  __syncthreads() separates passes.
// The optional Kp row sum reduces w-groups of Kp within each row.
// ---------------------------------------------------------------------------
constexpr int kRunThreads = 512;
constexpr int kPitch = 129;
constexpr int kMaxRun = 8;

struct RunArgs {
    const uint8_t* idx[kMaxRun];
    int s[kMaxRun];
    int n;
};

template <typename T>
__global__ void __launch_bounds__(kRunThreads)
benes_small_run_kernel(const T* __restrict__ x, RunArgs run,
                       T* __restrict__ out, int lkp) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* tile = reinterpret_cast<T*>(smem);
    const int64_t b = blockIdx.x;
    const T* xb = x + b * 16384;
    for (int e = threadIdx.x; e < 16384; e += kRunThreads)
        tile[(e >> 7) * kPitch + (e & 127)] = xb[e];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int p = 0; p < run.n; ++p) {
        const uint8_t* ib = run.idx[p] + b * 16384;
        const bool rows = run.s[p] == 1;
        for (int q = warp; q < 128; q += kRunThreads / 32) {
            const uint8_t* iq = ib + q * 128;
            T v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int l = lane + 32 * k;
                v[k] = rows ? tile[q * kPitch + iq[l]]
                            : tile[iq[l] * kPitch + q];
            }
            __syncwarp();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int l = lane + 32 * k;
                if (rows) tile[q * kPitch + l] = v[k];
                else tile[l * kPitch + q] = v[k];
            }
            __syncwarp();
        }
        __syncthreads();
    }
    if (lkp < 0) {
        T* ob = out + b * 16384;
        for (int e = threadIdx.x; e < 16384; e += kRunThreads)
            ob[e] = tile[(e >> 7) * kPitch + (e & 127)];
        return;
    }
    const int nout = 16384 >> lkp;
    const int per_row = 128 >> lkp;
    T* ob = out + b * nout;
    for (int o = threadIdx.x; o < nout; o += kRunThreads) {
        const int a = o / per_row;
        const int w0 = (o % per_row) << lkp;
        T s = T(0);
        for (int j = 0; j < (1 << lkp); ++j) s += tile[a * kPitch + w0 + j];
        ob[o] = s;
    }
}

template <typename T>
void launch_pass(const void* x, const void* idx, void* out, int64_t M,
                 int64_t s, cudaStream_t st) {
    const int64_t blocks = M / 128 / kRows;
    benes_pass_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(idx),
        static_cast<T*>(out), lis_ilog2(s));
}

template <typename T>
void launch_rowsum(const void* x, const void* idx, void* y, int64_t M,
                   int64_t s, int64_t kp, cudaStream_t st) {
    const int64_t rows_per_block = kp > kRows ? kp : kRows;
    const int64_t blocks = M / 128 / rows_per_block;
    benes_pass_rowsum_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(idx),
        static_cast<T*>(y), lis_ilog2(s), lis_ilog2(kp));
}

template <typename T>
void launch_run(const void* x, const RunArgs& run, void* out, int64_t M,
                int lkp, cudaStream_t st) {
    const int smem = 128 * kPitch * (int)sizeof(T);
    cudaFuncSetAttribute(benes_small_run_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    benes_small_run_kernel<T><<<(unsigned)(M / 16384), kRunThreads, smem,
                                st>>>(static_cast<const T*>(x), run,
                                      static_cast<T*>(out), lkp);
}

}  // namespace

// x, out (M,); idx (M/128, 128).  s is a power of two, M/128 a multiple
// of 32.
LIS_EXPORT int lis_benes_pass(int dtype, const void* x, const void* idx,
                              void* out, int64_t M, int64_t s,
                              void* stream) {
    LIS_DISPATCH(dtype, launch_pass, x, idx, out, M, s,
                 static_cast<cudaStream_t>(stream));
}

// y (M/Kp,).  Kp is a power of two dividing s; M/128 a multiple of
// max(32, Kp).
LIS_EXPORT int lis_benes_pass_rowsum(int dtype, const void* x,
                                     const void* idx, void* y, int64_t M,
                                     int64_t s, int64_t kp, void* stream) {
    LIS_DISPATCH(dtype, launch_rowsum, x, idx, y, M, s, kp,
                 static_cast<cudaStream_t>(stream));
}

// idxs: host array of n device pointers (each (M/128, 128)); ss: host
// array of n strides, each 1 or 128; lkp = log2(Kp) or -1 for no row sum.
LIS_EXPORT int lis_benes_small_run(int dtype, const void* x,
                                   const void* idxs, const void* ss, int n,
                                   void* out, int64_t M, int lkp,
                                   void* stream) {
    if (n < 1 || n > kMaxRun) return (int)cudaErrorInvalidValue;
    RunArgs run{};
    for (int i = 0; i < n; ++i) {
        run.idx[i] = static_cast<const uint8_t* const*>(idxs)[i];
        run.s[i] = static_cast<const int*>(ss)[i];
        if (run.s[i] != 1 && run.s[i] != 128)
            return (int)cudaErrorInvalidValue;
    }
    run.n = n;
    LIS_DISPATCH(dtype, launch_run, x, run, out, M, lkp,
                 static_cast<cudaStream_t>(stream));
}
