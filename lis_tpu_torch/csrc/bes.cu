// Kernels Q and R · bes_spmv / bes_spmvh — the BES slab products.
//
// lis_tpu has no Pallas kernel here: XLA fuses the window reshapes and the
// broadcast-multiply-reduce of lis_tpu/matrix/bes.py::BESMatrix.matvec
// (:184-191) and the reduce plus overlap-add of matvech (:193-212) into
// its own loops.  PyTorch would run W/s slices, a concatenation, a product
// as large as the slab and a reduction, so the port writes the loops by
// hand.  With slab the (T, W, R) row-major dense slab, R rows a block and
// s the column stride of the windows:
//
//   Q:  y[t R + r] = sum_{w < W} slab[t, w, r] * x[t s + c0 + w]
//   R:  y[j]       = sum_{t, w : t s + c0 + w = j} sum_r conj(slab[t, w, r])
//                                                     * x[t R + r]
//
// x is 0 outside [0, ncols) (Q) and past nrows (R); Q drops rows past
// nrows.  Bound on the H100: bytes.  The slab is read once, T W R
// elements, beside the window reads of x (T s + W elements) and the
// output.
//
// Q: one CTA per row block t, one thread per row r.  The CTA stages its
// window of x in shared memory (tiles of kTile, coalesced); for each w a
// warp reads 32 consecutive slab[t, w, r], so every slab load is
// coalesced, and each thread sums its row in the order of w, as the plain
// version's sum over axis 1 does.
//
// R: two launches.  The first forms win[t, w] = sum_r conj(slab[t, w, r])
// x[t R + r] (one CTA per t, the CTA's rows of x in shared memory, a warp
// per w that reduces over r with shuffles).  The second overlap-adds the
// windows: one thread per output column j adds, for c = 0 .. W/s - 1 in
// that order, the entry of window column c s .. c s + s - 1 that lands on
// j — the order in which the plain version's W/s shifted adds reach it.
// There are no atomics, so the result does not depend on scheduling.
//
// Types: slab and x of one type (float, double, complex64, complex128), or
// a real slab with the complex x of the same width, which streams the real
// slab as it is (a complex x is never truncated to the slab's type).  All
// indexing of the slab is 64-bit: a 4 GiB slab holds 2^29 doubles.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;      // x window elements staged per pass (Q)
constexpr int kMaxR = 1024;      // rows a block: one thread each (Q)
constexpr int kWinThreads = 256; // CTA of R's first stage: 8 warps
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

__device__ __forceinline__ float shfl_down(float v, int d) {
    return __shfl_down_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ double shfl_down(double v, int d) {
    return __shfl_down_sync(0xffffffffu, v, d);
}
template <typename T>
__device__ __forceinline__ Cx<T> shfl_down(Cx<T> v, int d) {
    return Cx<T>{shfl_down(v.re, d), shfl_down(v.im, d)};
}

// ---- Q --------------------------------------------------------------------
template <typename V, typename U>
__global__ void __launch_bounds__(kMaxR)
bes_spmv_kernel(const V* __restrict__ slab, const U* __restrict__ x,
                U* __restrict__ y, int W, int R, int64_t s, int64_t c0,
                int64_t nrows, int64_t ncols) {
    __shared__ __align__(16) unsigned char buf[kTile * sizeof(U)];
    U* xs = reinterpret_cast<U*>(buf);
    const int64_t t = blockIdx.x;
    const int r = threadIdx.x;
    const int64_t base = t * s + c0;
    const V* sl = slab + t * int64_t(W) * R + r;
    U acc = zero_of(U{});
    for (int w0 = 0; w0 < W; w0 += kTile) {
        const int nw = min(kTile, W - w0);
        __syncthreads();                    // the last tile is consumed
        for (int k = r; k < nw; k += R) {
            const int64_t j = base + w0 + k;
            xs[k] = (j >= 0 && j < ncols) ? x[j] : zero_of(U{});
        }
        __syncthreads();
        const V* p = sl + int64_t(w0) * R;
#pragma unroll 8
        for (int k = 0; k < nw; ++k) mul_acc(acc, p[int64_t(k) * R], xs[k]);
    }
    const int64_t row = t * R + r;
    if (row < nrows) y[row] = acc;
}

// ---- R, first stage: win[t, w] --------------------------------------------
template <typename V, typename U>
__global__ void __launch_bounds__(kWinThreads)
bes_win_kernel(const V* __restrict__ slab, const U* __restrict__ x,
               U* __restrict__ win, int W, int R, int64_t nrows) {
    __shared__ __align__(16) unsigned char buf[kMaxR * sizeof(U)];
    U* xs = reinterpret_cast<U*>(buf);
    const int64_t t = blockIdx.x;
    for (int r = threadIdx.x; r < R; r += kWinThreads) {
        const int64_t row = t * R + r;
        xs[r] = row < nrows ? x[row] : zero_of(U{});
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    constexpr int kWarps = kWinThreads / 32;
    for (int w = warp; w < W; w += kWarps) {
        const V* sl = slab + (t * W + w) * int64_t(R);
        U acc = zero_of(U{});
        for (int r = lane; r < R; r += 32) mul_acc(acc, conj_of(sl[r]), xs[r]);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) add_to(acc, shfl_down(acc, d));
        if (lane == 0) win[t * W + w] = acc;
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

template <typename V, typename U>
int launch(bool h, const void* slab, const void* x, void* y, void* work,
           int64_t T, int64_t W, int64_t R, int64_t s, int64_t c0,
           int64_t nrows, int64_t ncols, cudaStream_t st) {
    if (!h) {
        if (T > 0)
            bes_spmv_kernel<V, U><<<(unsigned)T, (unsigned)R, 0, st>>>(
                static_cast<const V*>(slab), static_cast<const U*>(x),
                static_cast<U*>(y), (int)W, (int)R, s, c0, nrows, ncols);
        return (int)cudaGetLastError();
    }
    if (T > 0) {
        bes_win_kernel<V, U><<<(unsigned)T, kWinThreads, 0, st>>>(
            static_cast<const V*>(slab), static_cast<const U*>(x),
            static_cast<U*>(work), (int)W, (int)R, nrows);
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    const int64_t blocks = (ncols + kAddThreads - 1) / kAddThreads;
    if (blocks > 0)
        bes_overlap_kernel<U><<<(unsigned)blocks, kAddThreads, 0, st>>>(
            static_cast<const U*>(work), static_cast<U*>(y), T, (int)W, s, c0,
            ncols);
    return (int)cudaGetLastError();
}

// vtype / xtype: 0 float, 1 double, 2 complex64, 3 complex128
int dispatch(bool h, int vtype, int xtype, const void* slab, const void* x,
             void* y, void* work, int64_t T, int64_t W, int64_t R, int64_t s,
             int64_t c0, int64_t nrows, int64_t ncols, void* stream) {
    if (T < 0 || W < 1 || W > (int64_t(1) << 30) || R < 1 || R > kMaxR ||
        s < 1 || nrows < 0 || ncols < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (vtype * 4 + xtype) {
    case 0 * 4 + 0: return launch<float, float>(h, slab, x, y, work, T, W, R, s, c0, nrows, ncols, st);
    case 1 * 4 + 1: return launch<double, double>(h, slab, x, y, work, T, W, R, s, c0, nrows, ncols, st);
    case 2 * 4 + 2: return launch<Cx<float>, Cx<float>>(h, slab, x, y, work, T, W, R, s, c0, nrows, ncols, st);
    case 3 * 4 + 3: return launch<Cx<double>, Cx<double>>(h, slab, x, y, work, T, W, R, s, c0, nrows, ncols, st);
    case 0 * 4 + 2: return launch<float, Cx<float>>(h, slab, x, y, work, T, W, R, s, c0, nrows, ncols, st);
    case 1 * 4 + 3: return launch<double, Cx<double>>(h, slab, x, y, work, T, W, R, s, c0, nrows, ncols, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// slab (T*W*R,), x (ncols,), y (nrows,); work unused.
LIS_EXPORT int lis_bes_spmv(int vtype, int xtype, const void* slab,
                            const void* x, void* y, void* work, int64_t T,
                            int64_t W, int64_t R, int64_t s, int64_t c0,
                            int64_t nrows, int64_t ncols, void* stream) {
    return dispatch(false, vtype, xtype, slab, x, y, work, T, W, R, s, c0,
                    nrows, ncols, stream);
}

// slab (T*W*R,), x (nrows,), y (ncols,), work (T*W,) of x's type.
LIS_EXPORT int lis_bes_spmvh(int vtype, int xtype, const void* slab,
                             const void* x, void* y, void* work, int64_t T,
                             int64_t W, int64_t R, int64_t s, int64_t c0,
                             int64_t nrows, int64_t ncols, void* stream) {
    return dispatch(true, vtype, xtype, slab, x, y, work, T, W, R, s, c0,
                    nrows, ncols, stream);
}
