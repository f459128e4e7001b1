// Kernels Q and R · bes_spmv / bes_spmvh — the BES slab products, read
// from the slab's compact per-tile form.
//
// lis_tpu has no Pallas kernel here: XLA fuses the window reshapes and the
// broadcast-multiply-reduce of lis_tpu/matrix/bes.py::BESMatrix.matvec
// (:184-191) and the reduce plus overlap-add of matvech (:193-212) into
// its own loops, streaming the (T, W, R) dense slab, slab[t, w, r] =
// A[t R + r, t s + c0 + w], as the TPU's vector unit wants it.  With s
// the column stride of the windows, the products are
//
//   Q:  y[t R + r] = sum_{w < W} slab[t, w, r] * x[t s + c0 + w]
//   R:  y[j]       = sum_{t, w : t s + c0 + w = j} sum_r conj(slab[t, w, r])
//                                                     * x[t R + r]
//
// x is 0 outside [0, ncols) (Q) and past nrows (R); Q drops rows past
// nrows.  Bound on the H100: bytes.  A routed slab holds about 21 slots
// for every nonzero, so the kernels read only the nonzeros, from the
// compact form that lis_tpu_torch/matrix/bes.py::bes_pack derives from the
// slab (exact zeros left out): sliced ELL, each tile's lists cut in
// slices of 32 (a warp's), a slice a column-major block as wide as its
// longest list, so that a warp reads 32 consecutive entries at a time.
// List a of tile t lies in slice g = t ceil(A / 32) + a / 32, its k-th
// entry at ptr[g] + 32 k + a % 32:
//
//   Q's lists (A = R): row r's nonzero slots in increasing w, value and
//     window offset w (uint8 where W <= 256, else uint16), and the row's
//     length len[t R + r];
//   R's lists (A = W): window column w's nonzero rows in increasing r,
//     value and row offset r (uint8 where R <= 256, else uint16), and the
//     column's length len[t W + w].
//
// The bytes a call needs are then the nonzeros' values and offsets, x and
// y (the lists' lengths and padding are this layout's own), against the
// dense slab's T W R values.
//
// Q: one CTA per tile t, one thread per row r.  The CTA stages x's window
// x[t s + c0 .. + W) in shared memory (coalesced, 0 outside [0, ncols)),
// then each thread sums its row's list in increasing w, reading x from
// shared memory: the plain version's order with the exact-zero terms left
// out.  A window of more than 48 KB (W > 6144 f64, 3072 complex128) is
// staged in passes, each thread walking its list across them.
//
// R: two launches.  The first forms win[t, w] = sum_r conj(slab[t, w, r])
// x[t R + r] (one CTA per t, the tile's rows of x in shared memory, a
// thread per window column summing its list in increasing r).  The second
// overlap-adds the windows: one thread per output column j adds, for
// c = 0 .. W/s - 1 in that order, the entry of window column c s .. c s +
// s - 1 that lands on j, the order in which the plain version's W/s
// shifted adds reach it.  There are no atomics, so the result does not
// depend on scheduling.
//
// Terms of exact-zero slots are not formed: a non-finite x[j] reaches only
// the rows (columns) that hold an entry in column j (row j), as in
// torch.sparse and the CSR product, where the plain version's 0 * inf
// makes every row whose window covers j NaN.  On finite x the result is
// the plain version's up to the sign of a zero.
//
// Types: values and x of one type (float, double, complex64, complex128),
// or real values with the complex x of the same width, which streams the
// real values as they are (a complex x is never truncated to the slab's
// type).
#include "common.cuh"

namespace {

constexpr int kStageBytes = 48 * 1024;  // x window staged per pass (Q)
constexpr int kMaxR = 1024;      // rows a block: one thread each (Q)
constexpr int kMaxW = 32767;     // window columns: 16-bit offsets, lengths
constexpr int kSlice = 32;       // lists a slice of the compact form
constexpr int kWinThreads = 256; // CTA of R's first stage
constexpr int kAddThreads = 256; // CTA of R's second stage

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
    T re, im;
};

template <typename T> __device__ __forceinline__ T zero_of(T) { return T(0); }
template <typename T>
__device__ __forceinline__ Cx<T> zero_of(Cx<T>) { return Cx<T>{T(0), T(0)}; }

template <typename T> __device__ __forceinline__ T conj_of(T v) { return v; }
template <typename T>
__device__ __forceinline__ Cx<T> conj_of(Cx<T> v) { return Cx<T>{v.re, -v.im}; }

__device__ __forceinline__ void mul_acc(float& a, float v, float x) { a += v * x; }
__device__ __forceinline__ void mul_acc(double& a, double v, double x) { a += v * x; }
template <typename T>
__device__ __forceinline__ void mul_acc(Cx<T>& a, T v, Cx<T> x) {
    a.re += v * x.re;
    a.im += v * x.im;
}
template <typename T>
__device__ __forceinline__ void mul_acc(Cx<T>& a, Cx<T> v, Cx<T> x) {
    a.re += v.re * x.re - v.im * x.im;
    a.im += v.re * x.im + v.im * x.re;
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(double& a, double b) { a += b; }
template <typename T>
__device__ __forceinline__ void add_to(Cx<T>& a, Cx<T> b) {
    a.re += b.re;
    a.im += b.im;
}

// The compact lists of one product and the shape they came from.
struct Lists {
    const void* val;      // values, in the slab's type
    const void* off;      // window (Q) or row (R) offsets, uint8 / uint16
    const int16_t* len;   // list lengths, (T R) rows or (T W) columns
    const int64_t* ptr;   // (T ceil(A / 32) + 1) slice starts
    int64_t T, W, R, s, c0, nrows, ncols;
};

// ---- Q --------------------------------------------------------------------
template <typename V, typename U, typename O>
__global__ void __launch_bounds__(kMaxR)
bes_spmv_kernel(const V* __restrict__ val, const O* __restrict__ off,
                const int16_t* __restrict__ len,
                const int64_t* __restrict__ ptr, const U* __restrict__ x,
                U* __restrict__ y, int W, int R, int64_t s, int64_t c0,
                int64_t nrows, int64_t ncols) {
    extern __shared__ __align__(16) unsigned char smem[];
    U* xs = reinterpret_cast<U*>(smem);
    constexpr int kTile = kStageBytes / int(sizeof(U));
    const int64_t t = blockIdx.x;
    const int r = threadIdx.x;
    const int64_t base = t * s + c0;
    const int64_t p0 = ptr[t * ((R + kSlice - 1) / kSlice) + r / kSlice] +
                       r % kSlice;
    const V* v = val + p0;
    const O* o = off + p0;
    const int n = len[t * R + r];
    U acc = zero_of(U{});
    if (W <= kTile) {                       // the whole window at once
        for (int k = r; k < W; k += R) {
            const int64_t j = base + k;
            xs[k] = (j >= 0 && j < ncols) ? x[j] : zero_of(U{});
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < n; ++k)
            mul_acc(acc, v[k * kSlice], xs[o[k * kSlice]]);
    } else {                                // passes of kTile columns
        int k = 0;
        for (int w0 = 0; w0 < W; w0 += kTile) {
            const int nw = min(kTile, W - w0);
            __syncthreads();                // the last pass is consumed
            for (int i = r; i < nw; i += R) {
                const int64_t j = base + w0 + i;
                xs[i] = (j >= 0 && j < ncols) ? x[j] : zero_of(U{});
            }
            __syncthreads();
            for (; k < n; ++k) {
                const int w = int(o[k * kSlice]) - w0;
                if (w >= nw) break;         // the list goes on next pass
                mul_acc(acc, v[k * kSlice], xs[w]);
            }
        }
    }
    const int64_t row = t * R + r;
    if (row < nrows) y[row] = acc;
}

// ---- R, first stage: win[t, w] --------------------------------------------
template <typename V, typename U, typename O>
__global__ void __launch_bounds__(kWinThreads)
bes_win_kernel(const V* __restrict__ val, const O* __restrict__ off,
               const int16_t* __restrict__ len,
               const int64_t* __restrict__ ptr, const U* __restrict__ x,
               U* __restrict__ win, int W, int R, int64_t nrows) {
    extern __shared__ __align__(16) unsigned char smem[];
    U* xs = reinterpret_cast<U*>(smem);
    const int64_t t = blockIdx.x;
    for (int r = threadIdx.x; r < R; r += kWinThreads) {
        const int64_t row = t * R + r;
        xs[r] = row < nrows ? x[row] : zero_of(U{});
    }
    __syncthreads();
    const int64_t g0 = t * ((W + kSlice - 1) / kSlice);
    for (int w = threadIdx.x; w < W; w += kWinThreads) {
        const int64_t p0 = ptr[g0 + w / kSlice] + w % kSlice;
        const V* v = val + p0;
        const O* o = off + p0;
        const int n = len[t * W + w];
        U acc = zero_of(U{});
#pragma unroll 4
        for (int k = 0; k < n; ++k)
            mul_acc(acc, conj_of(v[k * kSlice]), xs[o[k * kSlice]]);
        win[t * W + w] = acc;
    }
}

// ---- R, second stage: the overlap-add of the windows ----------------------
template <typename U>
__global__ void __launch_bounds__(kAddThreads)
bes_overlap_kernel(const U* __restrict__ win, U* __restrict__ y, int64_t T,
                   int W, int64_t s, int64_t c0, int64_t ncols) {
    const int64_t j = blockIdx.x * int64_t(kAddThreads) + threadIdx.x;
    if (j >= ncols) return;
    const int64_t span = T * s;
    const int64_t nc = W / s;
    U acc = zero_of(U{});
    for (int64_t c = 0; c < nc; ++c) {
        const int64_t q = j - c0 - c * s;   // position in the shifted copy c
        if (q < 0) break;                   // q only falls as c grows
        if (q >= span) continue;
        const int64_t t = q / s;
        add_to(acc, win[t * W + c * s + (q - t * s)]);
    }
    y[j] = acc;
}

template <typename V, typename U, typename O>
int run(bool h, const Lists& a, const void* x, void* y, void* work,
        cudaStream_t st) {
    const V* val = static_cast<const V*>(a.val);
    const O* off = static_cast<const O*>(a.off);
    const U* xu = static_cast<const U*>(x);
    if (!h) {
        constexpr int64_t kTile = kStageBytes / int64_t(sizeof(U));
        const size_t sm = size_t(a.W < kTile ? a.W : kTile) * sizeof(U);
        if (a.T > 0)
            bes_spmv_kernel<V, U, O><<<(unsigned)a.T, (unsigned)a.R, sm, st>>>(
                val, off, a.len, a.ptr, xu, static_cast<U*>(y), (int)a.W,
                (int)a.R, a.s, a.c0, a.nrows, a.ncols);
        return (int)cudaGetLastError();
    }
    U* win = static_cast<U*>(work);
    if (a.T > 0) {
        bes_win_kernel<V, U, O><<<(unsigned)a.T, kWinThreads,
                                  size_t(a.R) * sizeof(U), st>>>(
            val, off, a.len, a.ptr, xu, win, (int)a.W, (int)a.R, a.nrows);
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    const int64_t blocks = (a.ncols + kAddThreads - 1) / kAddThreads;
    if (blocks > 0)
        bes_overlap_kernel<U><<<(unsigned)blocks, kAddThreads, 0, st>>>(
            win, static_cast<U*>(y), a.T, (int)a.W, a.s, a.c0, a.ncols);
    return (int)cudaGetLastError();
}

template <typename V, typename U>
int by_offset(bool h, int otype, const Lists& a, const void* x, void* y,
              void* work, cudaStream_t st) {
    switch (otype) {
    case 0: return run<V, U, uint8_t>(h, a, x, y, work, st);
    case 1: return run<V, U, uint16_t>(h, a, x, y, work, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

// vtype / xtype: 0 float, 1 double, 2 complex64, 3 complex128;
// otype: 0 uint8, 1 uint16 offsets
int dispatch(bool h, int vtype, int xtype, int otype, const Lists& a,
             const void* x, void* y, void* work, void* stream) {
    if (a.T < 0 || a.W < 1 || a.W > kMaxW || a.R < 1 || a.R > kMaxR ||
        a.s < 1 || a.nrows < 0 || a.ncols < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (vtype * 4 + xtype) {
    case 0 * 4 + 0: return by_offset<float, float>(h, otype, a, x, y, work, st);
    case 1 * 4 + 1: return by_offset<double, double>(h, otype, a, x, y, work, st);
    case 2 * 4 + 2: return by_offset<Cx<float>, Cx<float>>(h, otype, a, x, y, work, st);
    case 3 * 4 + 3: return by_offset<Cx<double>, Cx<double>>(h, otype, a, x, y, work, st);
    case 0 * 4 + 2: return by_offset<float, Cx<float>>(h, otype, a, x, y, work, st);
    case 1 * 4 + 3: return by_offset<double, Cx<double>>(h, otype, a, x, y, work, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Q's lists (val, off, len (T*R,), ptr (T*ceil(R/32)+1,)), x (ncols,),
// y (nrows,); work unused.
LIS_EXPORT int lis_bes_spmv(int vtype, int xtype, int otype, const void* val,
                            const void* off, const void* len,
                            const void* ptr, const void* x, void* y,
                            void* work, int64_t T, int64_t W, int64_t R,
                            int64_t s, int64_t c0, int64_t nrows,
                            int64_t ncols, void* stream) {
    const Lists a{val, off, static_cast<const int16_t*>(len),
                  static_cast<const int64_t*>(ptr), T, W, R, s, c0, nrows,
                  ncols};
    return dispatch(false, vtype, xtype, otype, a, x, y, work, stream);
}

// R's lists (val, off, len (T*W,), ptr (T*ceil(W/32)+1,)), x (nrows,),
// y (ncols,), work (T*W,) of x's type.
LIS_EXPORT int lis_bes_spmvh(int vtype, int xtype, int otype,
                             const void* val, const void* off,
                             const void* len, const void* ptr,
                             const void* x, void* y, void* work, int64_t T,
                             int64_t W, int64_t R, int64_t s, int64_t c0,
                             int64_t nrows, int64_t ncols, void* stream) {
    const Lists a{val, off, static_cast<const int16_t*>(len),
                  static_cast<const int64_t*>(ptr), T, W, R, s, c0, nrows,
                  ncols};
    return dispatch(true, vtype, xtype, otype, a, x, y, work, stream);
}
