// Kernels E and F · dia_spmv / dia_spmvh — the DIA matrix-vector products.
//
// lis_tpu has no Pallas kernel here: XLA fuses the shift-multiply-add
// chain of lis_tpu/matrix/dia.py::DIAMatrix.matvec (:119) and the square
// branch of matvech (:136-146) into one loop.  PyTorch runs two launches
// and one temporary per diagonal, so the port writes the loop by hand.
// With val the (nnd, n) row-major diagonals of the n x ncols matrix A,
// val[k, i] = A[i, i + off_k]:
//
//     E:  y[i] = sum_k val[k, i] * x[i + off_k]      i < n,  0 <= i + off_k < ncols
//     F:  y[j] = sum_k conj(val[k, j - off_k]) * x[j - off_k]
//                                                    j < ncols, 0 <= j - off_k < n
//
// F is y = A^H x for the same rectangular A: x has n entries, y has ncols.
// A rank of a distributed DIA operator (lis_tpu_torch/parallel/dist.py)
// holds its nlocal rows as an nlocal x (nlocal + 2 hw) matrix over
// [left halo | own | right halo] columns; F gives the columns' partial
// sums, whose halo parts go back to their owners (the reference's
// lis_reduce).  Square A (ncols = n) is the serial matvech.
//
// Bound on the H100: bytes.  The diagonals are read exactly once,
// (nnd n + 2 n) elements with the vector in and out; the nnd shifted reads
// of x come from L1 and L2.  Design: one thread per row, consecutive
// threads on consecutive rows, so every diagonal is one coalesced stream;
// the loop over k runs in the order of the offsets (the plain version sums
// in that order too) with the offsets in shared memory.  The bounds guard
// replaces lis_tpu's padded copy of x: a term whose column falls outside
// the matrix is dropped and x is never read outside its ends.  All
// indexing is 64-bit: 512 diagonals of 7 M rows pass 2^31 elements.
//
// Types: val and x of one type (float, double, complex64, complex128), or
// real val with the complex x of the same width, which streams the real
// diagonals as they are.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNnd = 512;

// torch's complex layout: (re, im) pairs
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

// acc += v * x
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

// H = false: kernel E (y has n entries, x has ncols).
// H = true:  kernel F (y has ncols entries, x has n).
template <typename V, typename U, bool H>
__global__ void __launch_bounds__(kThreads)
dia_kernel(const V* __restrict__ val, const int64_t* __restrict__ off,
           const U* __restrict__ x, U* __restrict__ y, int64_t n,
           int64_t ncols, int nnd) {
    __shared__ int64_t offs[kMaxNnd];
    for (int k = threadIdx.x; k < nnd; k += kThreads) offs[k] = off[k];
    __syncthreads();
    const int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x;
    if (i >= (H ? ncols : n)) return;
    U acc = zero_of(U{});
#pragma unroll 4
    for (int k = 0; k < nnd; ++k) {
        if (H) {
            // row r = i - off of diagonal k lands in column i
            const int64_t r = i - offs[k];
            if (r >= 0 && r < n)
                mul_acc(acc, conj_of(val[int64_t(k) * n + r]), x[r]);
        } else {
            const int64_t j = i + offs[k];
            const V v = val[int64_t(k) * n + i];
            if (j >= 0 && j < ncols) mul_acc(acc, v, x[j]);
        }
    }
    y[i] = acc;
}

template <typename V, typename U>
void launch(bool h, const void* val, const void* off, const void* x, void* y,
            int64_t n, int64_t ncols, int nnd, cudaStream_t st) {
    const int64_t blocks = ((h ? ncols : n) + kThreads - 1) / kThreads;
    if (blocks == 0) return;
    if (h)
        dia_kernel<V, U, true><<<(unsigned)blocks, kThreads, 0, st>>>(
            static_cast<const V*>(val), static_cast<const int64_t*>(off),
            static_cast<const U*>(x), static_cast<U*>(y), n, ncols, nnd);
    else
        dia_kernel<V, U, false><<<(unsigned)blocks, kThreads, 0, st>>>(
            static_cast<const V*>(val), static_cast<const int64_t*>(off),
            static_cast<const U*>(x), static_cast<U*>(y), n, ncols, nnd);
}

// vtype / xtype: 0 float, 1 double, 2 complex64, 3 complex128
int dispatch(bool h, int vtype, int xtype, const void* val, const void* off,
             const void* x, void* y, int64_t n, int64_t ncols, int64_t nnd,
             void* stream) {
    if (nnd < 0 || nnd > kMaxNnd || n < 0 || ncols < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int key = vtype * 4 + xtype;
    switch (key) {
    case 0 * 4 + 0: launch<float, float>(h, val, off, x, y, n, ncols, (int)nnd, st); break;
    case 1 * 4 + 1: launch<double, double>(h, val, off, x, y, n, ncols, (int)nnd, st); break;
    case 2 * 4 + 2: launch<Cx<float>, Cx<float>>(h, val, off, x, y, n, ncols, (int)nnd, st); break;
    case 3 * 4 + 3: launch<Cx<double>, Cx<double>>(h, val, off, x, y, n, ncols, (int)nnd, st); break;
    case 0 * 4 + 2: launch<float, Cx<float>>(h, val, off, x, y, n, ncols, (int)nnd, st); break;
    case 1 * 4 + 3: launch<double, Cx<double>>(h, val, off, x, y, n, ncols, (int)nnd, st); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// val (nnd*n,), off (nnd,) int64, x (ncols,), y (n,).
LIS_EXPORT int lis_dia_spmv(int vtype, int xtype, const void* val,
                            const void* off, const void* x, void* y,
                            int64_t n, int64_t ncols, int64_t nnd,
                            void* stream) {
    return dispatch(false, vtype, xtype, val, off, x, y, n, ncols, nnd, stream);
}

// val (nnd*n,), off (nnd,) int64, x (n,), y (ncols,).
LIS_EXPORT int lis_dia_spmvh(int vtype, int xtype, const void* val,
                             const void* off, const void* x, void* y,
                             int64_t n, int64_t ncols, int64_t nnd,
                             void* stream) {
    return dispatch(true, vtype, xtype, val, off, x, y, n, ncols, nnd, stream);
}
