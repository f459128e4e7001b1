// Kernels H and I · dia_relax / dia_relaxh — one relaxed triangular sweep
// over DIA diagonals.
//
// lis_tpu has no Pallas kernel here: XLA fuses the sweeps
// y <- (rhs - T.matvec(y)) * w of lis_tpu/precon/ssor.py (:60-84),
// lis_tpu/precon/ilu.py::ILUDiaPrecon (:319-337),
// lis_tpu/solvers/stationary.py::_LowerSweep (:61-65) and
// lis_tpu/ops/trisolve.py::relaxed_sweeps (:110) into one loop each.
// PyTorch would run two launches and one temporary per diagonal, plus the
// subtraction and the scaling.  With val the (nnd, n) row-major diagonals
// of T (a strict triangle, or all of a square A), val[k, i] = T[i, i+off_k]:
//
//   H:  out[i] = (rhs[i]*rs[i] - sum_k val[k,i] * t[i+off_k]) * w[i]
//   I:  out[j] = (rhs[j]*rs[j] - sum_k conj(val[k,j-off_k]) * t[j-off_k]) * w[j]
//
// where the term vector t is, by ymode:
//   0: absent (no sum: out = rhs*rs*w, the start of a sweep);
//   1: s[j]*y[j] (y given; s a prescale, absent meaning 1);
//   2: (rhs[j]*rs[j])*w[j], the start vector computed in place, so that a
//      sweep series needs no launch for its start.
// rs, s and w are optional (null: 1).  Terms whose index falls outside
// [0, n) are dropped, as kernel E drops them.
//
// Bound on the H100: bytes.  T is read once, the vectors once each, with
// the shifted reads of t served by L1 and L2: (nnd + 4..6) n elements.
// Design: one thread per row, consecutive threads on consecutive rows, so
// every diagonal is one coalesced stream (I reads val[k, j - off_k],
// unaligned but coalesced, as kernel F does); offsets in shared memory.
// Every product and sum is rounded on its own (__dmul_rn / __dadd_rn, no
// fused multiply-add), in the order of the offsets, so that on real data
// the kernel equals its plain PyTorch version bit for bit.
//
// Types: val and the vectors of one type (float, double, complex64,
// complex128), or real val with complex vectors of the same width (the
// scales rs, s and w have val's type).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNnd = 512;

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
    T re, im;
};

__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ Cx<T> mul_(Cx<T> a, Cx<T> b) {
    return Cx<T>{sub_(mul_(a.re, b.re), mul_(a.im, b.im)),
                 add_(mul_(a.re, b.im), mul_(a.im, b.re))};
}
template <typename T>
__device__ __forceinline__ Cx<T> mul_(Cx<T> a, T b) {
    return Cx<T>{mul_(a.re, b), mul_(a.im, b)};
}
template <typename T>
__device__ __forceinline__ Cx<T> add_(Cx<T> a, Cx<T> b) {
    return Cx<T>{add_(a.re, b.re), add_(a.im, b.im)};
}
template <typename T>
__device__ __forceinline__ Cx<T> sub_(Cx<T> a, Cx<T> b) {
    return Cx<T>{sub_(a.re, b.re), sub_(a.im, b.im)};
}

template <typename T> __device__ __forceinline__ T zero_of(T) { return T(0); }
template <typename T>
__device__ __forceinline__ Cx<T> zero_of(Cx<T>) { return Cx<T>{T(0), T(0)}; }

template <typename T> __device__ __forceinline__ T conj_of(T v) { return v; }
template <typename T>
__device__ __forceinline__ Cx<T> conj_of(Cx<T> v) { return Cx<T>{v.re, -v.im}; }

// TRANS = false: kernel H; TRANS = true: kernel I.  MODE: the term vector
// (see the head of the file).
template <typename V, typename U, bool TRANS, int MODE>
__global__ void __launch_bounds__(kThreads)
relax_kernel(const V* __restrict__ val, const int64_t* __restrict__ off,
             const U* __restrict__ rhs, const V* __restrict__ rs,
             const U* __restrict__ y, const V* __restrict__ s,
             const V* __restrict__ w, U* __restrict__ out, int64_t n,
             int nnd) {
    __shared__ int64_t offs[kMaxNnd];
    for (int k = threadIdx.x; k < nnd; k += kThreads) offs[k] = off[k];
    __syncthreads();
    const int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x;
    if (i >= n) return;
    U acc = zero_of(U{});
    if (MODE != 0) {
#pragma unroll 4
        for (int k = 0; k < nnd; ++k) {
            // j: the index of the term; the value is T[i, j] (H) or
            // conj(T[j, i]) (I)
            const int64_t j = TRANS ? i - offs[k] : i + offs[k];
            if (j < 0 || j >= n) continue;
            const V v = TRANS ? conj_of(val[int64_t(k) * n + j])
                              : val[int64_t(k) * n + i];
            U t;
            if (MODE == 1) {
                t = y[j];
                if (s) t = mul_(t, s[j]);
            } else {
                t = rhs[j];
                if (rs) t = mul_(t, rs[j]);
                if (w) t = mul_(t, w[j]);
            }
            acc = add_(acc, mul_(t, v));
        }
    }
    U o = rhs[i];
    if (rs) o = mul_(o, rs[i]);
    if (MODE != 0) o = sub_(o, acc);
    if (w) o = mul_(o, w[i]);
    out[i] = o;
}

struct Args {
    const void *val, *off, *rhs, *rs, *y, *s, *w;
    void* out;
    int64_t n;
    int nnd;
};

template <typename V, typename U, bool TRANS, int MODE>
void launch_mode(const Args& a, cudaStream_t st) {
    const int64_t blocks = (a.n + kThreads - 1) / kThreads;
    if (blocks == 0) return;
    relax_kernel<V, U, TRANS, MODE><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const V*>(a.val), static_cast<const int64_t*>(a.off),
        static_cast<const U*>(a.rhs), static_cast<const V*>(a.rs),
        static_cast<const U*>(a.y), static_cast<const V*>(a.s),
        static_cast<const V*>(a.w), static_cast<U*>(a.out), a.n, a.nnd);
}

template <typename V, typename U>
int launch(bool trans, int ymode, const Args& a, cudaStream_t st) {
    switch (ymode * 2 + (trans ? 1 : 0)) {
    case 0: launch_mode<V, U, false, 0>(a, st); break;
    case 1: launch_mode<V, U, true, 0>(a, st); break;
    case 2: launch_mode<V, U, false, 1>(a, st); break;
    case 3: launch_mode<V, U, true, 1>(a, st); break;
    case 4: launch_mode<V, U, false, 2>(a, st); break;
    case 5: launch_mode<V, U, true, 2>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// vtype / utype: 0 float, 1 double, 2 complex64, 3 complex128.
// val (nnd*n,), off (nnd,) int64; rhs, y, out (n,) of utype; rs, s, w
// (n,) of vtype or null; y null unless ymode == 1.
LIS_EXPORT int lis_dia_relax(int vtype, int utype, int trans, int ymode,
                             const void* val, const void* off, const void* rhs,
                             const void* rs, const void* y, const void* s,
                             const void* w, void* out, int64_t n, int64_t nnd,
                             void* stream) {
    if (nnd < 0 || nnd > kMaxNnd || n < 0 || ymode < 0 || ymode > 2 ||
        (ymode == 1 && y == nullptr))
        return (int)cudaErrorInvalidValue;
    const Args a{val, off, rhs, rs, y, s, w, out, n, (int)nnd};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool t = trans != 0;
    switch (vtype * 4 + utype) {
    case 0 * 4 + 0: return launch<float, float>(t, ymode, a, st);
    case 1 * 4 + 1: return launch<double, double>(t, ymode, a, st);
    case 2 * 4 + 2: return launch<Cx<float>, Cx<float>>(t, ymode, a, st);
    case 3 * 4 + 3: return launch<Cx<double>, Cx<double>>(t, ymode, a, st);
    case 0 * 4 + 2: return launch<float, Cx<float>>(t, ymode, a, st);
    case 1 * 4 + 3: return launch<double, Cx<double>>(t, ymode, a, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
