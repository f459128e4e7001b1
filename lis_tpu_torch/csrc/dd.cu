// Kernels M-P · the double-double ("quad") vector work of the _quad solvers.
//
// lis_tpu has no Pallas kernel here: its double-double path is jnp code
// (lis_tpu/core/ddreal.py) that XLA fuses into one loop per expression.
// In eager PyTorch each error-free transform is some ten launches, a DD
// matvec hundreds, so the port writes the loops by hand:
//
//   M dd_dia_spmv   y = A x (trans: A^T x) over the (nnd, n) DIA diagonals
//                   (ddreal.py:365-406, DDDiaOperator._mv / matvech)
//   N dd_ell_spmv   y = A x over ELL arrays, lis_tpu's row tree
//                   (ddreal.py:271-310, matvec_dd_ell / _dd_row_reduce)
//   O dd_reduce     sum / dot / nrm2 / nrm1 by the halving tree of
//                   _dd_sum (ddreal.py:218-268)
//   P dd_update     axpy / xpay / scal (ddreal.py:196-207) and the
//                   elementwise add, sub, mul, div, sqrt (:130-183)
//
// Each template takes f64 limbs (-f quad) or f32 limbs (-f df).
//
// Exactness.  The transforms are exact only if every product and every
// sum is rounded on its own: nvcc contracts a*b + c into an FMA by
// default, which turns the error terms of SPLIT and TWO_PROD into zeros
// and the whole path into plain double.  So every operation below is an
// explicit round-to-nearest intrinsic (__dadd_rn, __dsub_rn, __dmul_rn,
// __ddiv_rn, __dsqrt_rn and their f32 forms), which nvcc never contracts;
// the build flags are those of the other kernels.  TWO_PROD is Dekker's
// split (no FMA), in the plain version's order, so every kernel equals its
// plain PyTorch version bit for bit.
//
// Bound on the H100: bytes for all four.  About 30 operations an entry
// of M and 20-40 an element of O and P stay under the FP64 peak's time for
// the bytes they stream.
#include "common.cuh"

namespace {

__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }

template <typename T> struct Splitter;
template <> struct Splitter<float> { static constexpr float v = 4097.0f; };
template <> struct Splitter<double> { static constexpr double v = 134217729.0; };

template <typename T>
struct DD {
    T hi, lo;
};

template <typename T>
__device__ __forceinline__ DD<T> two_sum(T a, T b) {
    const T s = add_(a, b);
    const T v = sub_(s, a);
    return {s, add_(sub_(a, sub_(s, v)), sub_(b, v))};
}

template <typename T>
__device__ __forceinline__ DD<T> quick_two_sum(T a, T b) {
    const T s = add_(a, b);
    return {s, sub_(b, sub_(s, a))};
}

template <typename T>
__device__ __forceinline__ void split(T a, T& hi, T& lo) {
    const T t = mul_(Splitter<T>::v, a);
    hi = sub_(t, sub_(t, a));
    lo = sub_(a, hi);
}

template <typename T>
__device__ __forceinline__ DD<T> two_prod(T a, T b) {
    const T p = mul_(a, b);
    T ah, al, bh, bl;
    split(a, ah, al);
    split(b, bh, bl);
    const T e = add_(add_(add_(sub_(mul_(ah, bh), p), mul_(ah, bl)),
                          mul_(al, bh)), mul_(al, bl));
    return {p, e};
}

// accurate QUAD_ADD
template <typename T>
__device__ __forceinline__ DD<T> dd_add(DD<T> x, DD<T> y) {
    DD<T> h = two_sum(x.hi, y.hi);
    const DD<T> l = two_sum(x.lo, y.lo);
    h = quick_two_sum(h.hi, add_(h.lo, l.hi));
    return quick_two_sum(h.hi, add_(h.lo, l.lo));
}

template <typename T>
__device__ __forceinline__ DD<T> dd_mul(DD<T> x, DD<T> y) {
    const DD<T> p = two_prod(x.hi, y.hi);
    return quick_two_sum(p.hi, add_(add_(p.lo, mul_(x.hi, y.lo)),
                                    mul_(x.lo, y.hi)));
}

// QUAD_SQRT, one Newton step (ddreal.py::sqrt)
template <typename T>
__device__ __forceinline__ DD<T> dd_sqrt(DD<T> x) {
    const T s = sqrt_(x.hi);
    if (s == T(0)) return {T(0), T(0)};
    const DD<T> p = two_prod(s, s);
    const T corr = div_(add_(sub_(x.hi, p.hi), sub_(x.lo, p.lo)),
                        mul_(T(2), s));
    return quick_two_sum(s, corr);
}

// ---- M: dd_dia_spmv ------------------------------------------------------
// One thread a row, the diagonals in the order of the offsets, as the
// plain version.  A column outside the matrix reads x as 0 (lis_tpu's
// zero-padded x) and still adds its term; the transpose reads A's own
// diagonals at row i - off (value 0 outside), so no shifted copy exists.
constexpr int kDiaThreads = 256;
constexpr int kMaxNnd = 512;

template <typename T, bool TRANS, bool LO>
__global__ void __launch_bounds__(kDiaThreads)
dia_kernel(const T* __restrict__ val, const T* __restrict__ vlo,
           const int64_t* __restrict__ off, const T* __restrict__ xh,
           const T* __restrict__ xl, T* __restrict__ yh, T* __restrict__ yl,
           int64_t n, int64_t ncols, int nnd) {
    __shared__ int64_t offs[kMaxNnd];
    for (int k = threadIdx.x; k < nnd; k += kDiaThreads) offs[k] = off[k];
    __syncthreads();
    const int64_t i = blockIdx.x * int64_t(kDiaThreads) + threadIdx.x;
    if (i >= n) return;
    DD<T> acc{T(0), T(0)};
    for (int k = 0; k < nnd; ++k) {
        T v, vl = T(0), h = T(0), l = T(0);
        if (TRANS) {
            const int64_t r = i - offs[k];
            const bool in = r >= 0 && r < n;
            v = in ? val[int64_t(k) * n + r] : T(0);
            if (LO) vl = in ? vlo[int64_t(k) * n + r] : T(0);
            if (in) { h = xh[r]; l = xl[r]; }
        } else {
            const int64_t j = i + offs[k];
            v = val[int64_t(k) * n + i];
            if (LO) vl = vlo[int64_t(k) * n + i];
            if (j >= 0 && j < ncols) { h = xh[j]; l = xl[j]; }
        }
        DD<T> t = two_prod(v, h);
        t.lo = add_(t.lo, mul_(v, l));
        if (LO) t.lo = add_(t.lo, mul_(vl, h));
        acc = dd_add(acc, t);
    }
    yh[i] = acc.hi;
    yl[i] = acc.lo;
}

template <typename T>
void dia_launch(int trans, const void* val, const void* vlo, const void* off,
                const void* xh, const void* xl, void* yh, void* yl, int64_t n,
                int64_t ncols, int nnd, cudaStream_t st) {
    const int64_t blocks = (n + kDiaThreads - 1) / kDiaThreads;
    if (blocks == 0) return;
    const T* v = static_cast<const T*>(val);
    const T* vl = static_cast<const T*>(vlo);
    const int64_t* o = static_cast<const int64_t*>(off);
    const T* h = static_cast<const T*>(xh);
    const T* l = static_cast<const T*>(xl);
    T* oh = static_cast<T*>(yh);
    T* ol = static_cast<T*>(yl);
    const dim3 g((unsigned)blocks);
    if (trans && vlo) dia_kernel<T, true, true><<<g, kDiaThreads, 0, st>>>(v, vl, o, h, l, oh, ol, n, ncols, nnd);
    else if (trans) dia_kernel<T, true, false><<<g, kDiaThreads, 0, st>>>(v, vl, o, h, l, oh, ol, n, ncols, nnd);
    else if (vlo) dia_kernel<T, false, true><<<g, kDiaThreads, 0, st>>>(v, vl, o, h, l, oh, ol, n, ncols, nnd);
    else dia_kernel<T, false, false><<<g, kDiaThreads, 0, st>>>(v, vl, o, h, l, oh, ol, n, ncols, nnd);
}

// ---- N: dd_ell_spmv ------------------------------------------------------
// One warp a row: lane l holds the row's terms l, l + 32, ... (R = 1, 2
// or 4 registers: rows of up to 32, 64 or 128 entries; longer rows below),
// so the row's
// index and value loads are one contiguous span.  Then the plain
// version's tree: while more than one term is left, an odd count gets one
// zero term at its end and term j takes term j + half, fetched from its
// lane by a shuffle.
constexpr int kEllWarps = 8;
constexpr int kMaxW = 128;

template <typename T, int R, bool LO>
__global__ void __launch_bounds__(kEllWarps * 32)
ell_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
           const T* __restrict__ vlo, const T* __restrict__ xh,
           const T* __restrict__ xl, T* __restrict__ yh, T* __restrict__ yl,
           int64_t n, int w) {
    const int lane = threadIdx.x & 31;
    const int64_t row = blockIdx.x * int64_t(kEllWarps) + (threadIdx.x >> 5);
    if (row >= n) return;                  // the whole warp: one row
    const int64_t base = row * w;
    T th[R], tl[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int l = lane + 32 * r;
        th[r] = T(0);
        tl[r] = T(0);
        if (l < w) {
            const int32_t c = idx[base + l];
            const T v = val[base + l];
            const T h = xh[c];
            DD<T> t = two_prod(v, h);
            t.lo = add_(t.lo, mul_(v, xl[c]));
            if (LO) t.lo = add_(t.lo, mul_(vlo[base + l], h));
            th[r] = t.hi;
            tl[r] = t.lo;
        }
    }
    for (int m = w; m > 1;) {
        const int valid = m;
        m += m & 1;
        const int half = m >> 1;
        T nh[R], nl[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = lane + 32 * r;
            const int k = j + half;
            T ph = T(0), pl = T(0);
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
                const T vh = __shfl_sync(0xffffffffu, th[rr], k & 31);
                const T vl = __shfl_sync(0xffffffffu, tl[rr], k & 31);
                if (rr == (k >> 5)) { ph = vh; pl = vl; }
            }
            if (k >= valid) { ph = T(0); pl = T(0); }   // the zero pad
            nh[r] = th[r];
            nl[r] = tl[r];
            if (j < half) {
                const DD<T> s = dd_add(DD<T>{th[r], tl[r]}, DD<T>{ph, pl});
                nh[r] = s.hi;
                nl[r] = s.lo;
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) { th[r] = nh[r]; tl[r] = nl[r]; }
        m = half;
    }
    if (lane == 0) {
        yh[row] = th[0];
        yl[row] = tl[0];
    }
}

template <typename T, int R>
void ell_launch_r(const void* idx, const void* val, const void* vlo,
                  const void* xh, const void* xl, void* yh, void* yl,
                  int64_t n, int w, cudaStream_t st) {
    const dim3 g((unsigned)((n + kEllWarps - 1) / kEllWarps));
    const int32_t* i = static_cast<const int32_t*>(idx);
    const T* v = static_cast<const T*>(val);
    const T* vl = static_cast<const T*>(vlo);
    const T* h = static_cast<const T*>(xh);
    const T* l = static_cast<const T*>(xl);
    T* oh = static_cast<T*>(yh);
    T* ol = static_cast<T*>(yl);
    if (vlo) ell_kernel<T, R, true><<<g, kEllWarps * 32, 0, st>>>(i, v, vl, h, l, oh, ol, n, w);
    else ell_kernel<T, R, false><<<g, kEllWarps * 32, 0, st>>>(i, v, vl, h, l, oh, ol, n, w);
}

// Rows longer than kMaxW: one warp a row (a block), its terms and the tree
// in dynamic shared memory (2 (w + 1) values: the zero pad of an odd
// level sits at index m).  Within a level lane j writes term j < half and
// reads term j + half >= half, so a level needs no barrier but the one
// after it.
template <typename T, bool LO>
__global__ void __launch_bounds__(32)
ell_long_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                const T* __restrict__ vlo, const T* __restrict__ xh,
                const T* __restrict__ xl, T* __restrict__ yh,
                T* __restrict__ yl, int w) {
    extern __shared__ unsigned char smem[];
    T* sh = reinterpret_cast<T*>(smem);
    T* sl = sh + w + 1;
    const int lane = threadIdx.x;
    const int64_t row = blockIdx.x;
    const int64_t base = row * w;
    for (int l = lane; l < w; l += 32) {
        const int32_t c = idx[base + l];
        const T v = val[base + l];
        const T h = xh[c];
        DD<T> t = two_prod(v, h);
        t.lo = add_(t.lo, mul_(v, xl[c]));
        if (LO) t.lo = add_(t.lo, mul_(vlo[base + l], h));
        sh[l] = t.hi;
        sl[l] = t.lo;
    }
    __syncwarp();
    for (int m = w; m > 1;) {
        if (m & 1) {
            if (lane == 0) { sh[m] = T(0); sl[m] = T(0); }
            ++m;
            __syncwarp();
        }
        const int half = m >> 1;
        for (int j = lane; j < half; j += 32) {
            const DD<T> r = dd_add(DD<T>{sh[j], sl[j]},
                                   DD<T>{sh[j + half], sl[j + half]});
            sh[j] = r.hi;
            sl[j] = r.lo;
        }
        __syncwarp();
        m = half;
    }
    if (lane == 0) {
        yh[row] = sh[0];
        yl[row] = sl[0];
    }
}

template <typename T>
int ell_launch(const void* idx, const void* val, const void* vlo,
               const void* xh, const void* xl, void* yh, void* yl, int64_t n,
               int w, cudaStream_t st) {
    if (n == 0) return 0;
    if (w <= 32) ell_launch_r<T, 1>(idx, val, vlo, xh, xl, yh, yl, n, w, st);
    else if (w <= 64) ell_launch_r<T, 2>(idx, val, vlo, xh, xl, yh, yl, n, w, st);
    else if (w <= kMaxW) ell_launch_r<T, 4>(idx, val, vlo, xh, xl, yh, yl, n, w, st);
    else {
        const size_t smem = 2 * (size_t(w) + 1) * sizeof(T);
        auto k = vlo ? ell_long_kernel<T, true> : ell_long_kernel<T, false>;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        k<<<(unsigned)n, 32, smem, st>>>(
            static_cast<const int32_t*>(idx), static_cast<const T*>(val),
            static_cast<const T*>(vlo), static_cast<const T*>(xh),
            static_cast<const T*>(xl), static_cast<T*>(yh),
            static_cast<T*>(yl), w);
    }
    return 0;
}

// ---- O: dd_reduce --------------------------------------------------------
// lis_tpu's _dd_sum: the m = 2^k padded terms (zeros past n), then level
// by level a[i] = a[i] + a[i + half] until one is left, then
// quick_two_sum (and sqrt for nrm2).  Level L adds the pairs whose
// indices differ in bit k - L, so the tree adds the high index bits
// first and the low ones last.  Layout: thread t of T = G*B threads owns
// the terms t + T*j, j < J = m / T.  Its first log2(J) levels are a
// halving tree over j; walking j in bit-reversed order makes that tree a
// neighbour tree over the walk, which a stack of log2(J) partials adds in
// the same pairs and the same left/right order.  The loads of one step
// are consecutive across a warp.  The last log2(T) levels are the halving
// tree over t: the same walk again, in one block of kFinal threads over
// the T partials (a second launch when G > 1), then a halving tree in
// shared memory and the finish in thread 0.
enum { R_SUM = 0, R_DOT = 1, R_NRM2 = 2, R_NRM1 = 3 };
constexpr int kRedThreads = 256;
constexpr int kFinal = 1024;
constexpr int kMaxDepth = 40;

template <typename T>
__device__ __forceinline__ DD<T> term(int mode, int64_t i, int64_t n,
                                      const T* __restrict__ xh,
                                      const T* __restrict__ xl,
                                      const T* __restrict__ yh,
                                      const T* __restrict__ yl) {
    if (i >= n) return {T(0), T(0)};
    const DD<T> x{xh[i], xl[i]};
    if (mode == R_DOT) return dd_mul(x, DD<T>{yh[i], yl[i]});
    if (mode == R_NRM2) return dd_mul(x, x);
    if (mode == R_NRM1) {
        // torch.sign: 0 for 0 and for NaN
        const T sg = x.hi > T(0) ? T(1) : (x.hi < T(0) ? T(-1) : T(0));
        return {fabs(x.hi), mul_(sg, x.lo)};
    }
    return x;
}

__device__ __forceinline__ int64_t bitrev(int64_t p, int bits) {
    return bits == 0 ? 0 : int64_t(__brevll(uint64_t(p)) >> (64 - bits));
}

// The halving tree over the J = m / T terms of thread t (global index),
// walked in bit-reversed order with a stack.  With J >= 8 the walk goes in
// chunks of 8 positions, each a whole subtree of height 3: its 8 terms are
// loaded together and added in registers, and only the chunk's sum goes
// through the stack.
template <typename T>
__device__ DD<T> walk(int mode, int64_t t, int64_t T_, int64_t J, int bits,
                      int64_t n, const T* xh, const T* xl, const T* yh,
                      const T* yl) {
    DD<T> stack[kMaxDepth];
    int depth = 0;
    if (J < 8) {
        for (int64_t p = 0; p < J; ++p) {
            DD<T> v = term(mode, bitrev(p, bits) * T_ + t, n, xh, xl, yh, yl);
            for (int64_t q = p; q & 1; q >>= 1) v = dd_add(stack[--depth], v);
            stack[depth++] = v;
        }
        return stack[0];
    }
    for (int64_t c = 0; c < J / 8; ++c) {
        DD<T> v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
            v[u] = term(mode, bitrev(8 * c + u, bits) * T_ + t, n, xh, xl,
                        yh, yl);
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = dd_add(v[2 * u], v[2 * u + 1]);
        v[0] = dd_add(v[0], v[1]);
        v[1] = dd_add(v[2], v[3]);
        DD<T> s = dd_add(v[0], v[1]);
        for (int64_t q = c; q & 1; q >>= 1) s = dd_add(stack[--depth], s);
        stack[depth++] = s;
    }
    return stack[0];
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_first(int mode, const T* __restrict__ xh, const T* __restrict__ xl,
             const T* __restrict__ yh, const T* __restrict__ yl, int64_t n,
             int64_t J, int bits, T* __restrict__ part) {
    const int64_t T_ = int64_t(gridDim.x) * kRedThreads;
    const int64_t t = blockIdx.x * int64_t(kRedThreads) + threadIdx.x;
    const DD<T> s = walk(mode, t, T_, J, bits, n, xh, xl, yh, yl);
    part[t] = s.hi;
    part[T_ + t] = s.lo;
}

// One block of B threads: the walk over m terms (J = m / B each), the
// shared-memory halving tree over the B threads, then the finish.
template <typename T>
__global__ void __launch_bounds__(kFinal)
reduce_final(int mode, int finish, const T* __restrict__ xh,
             const T* __restrict__ xl, const T* __restrict__ yh,
             const T* __restrict__ yl, int64_t n, int64_t J, int bits,
             T* __restrict__ out) {
    __shared__ T sh[kFinal], sl[kFinal];
    const int B = blockDim.x;
    const int t = threadIdx.x;
    const DD<T> s = walk(mode, t, B, J, bits, n, xh, xl, yh, yl);
    sh[t] = s.hi;
    sl[t] = s.lo;
    __syncthreads();
    for (int half = B >> 1; half > 0; half >>= 1) {
        if (t < half) {
            const DD<T> r = dd_add(DD<T>{sh[t], sl[t]},
                                   DD<T>{sh[t + half], sl[t + half]});
            sh[t] = r.hi;
            sl[t] = r.lo;
        }
        __syncthreads();
    }
    if (t == 0) {
        DD<T> r = quick_two_sum(sh[0], sl[0]);
        if (finish == R_NRM2) r = dd_sqrt(r);
        out[0] = r.hi;
        out[1] = r.lo;
    }
}

template <typename T>
void reduce_launch(int mode, const void* xh, const void* xl, const void* yh,
                   const void* yl, int64_t n, int64_t m, int blocks,
                   void* part, void* out, cudaStream_t st) {
    const T* h = static_cast<const T*>(xh);
    const T* l = static_cast<const T*>(xl);
    const T* y1 = static_cast<const T*>(yh);
    const T* y2 = static_cast<const T*>(yl);
    if (blocks == 0) {
        const int B = int(m < kFinal ? m : kFinal);
        const int64_t J = m / B;
        reduce_final<T><<<1, B, 0, st>>>(mode, mode, h, l, y1, y2, n, J,
                                         lis_ilog2(J), static_cast<T*>(out));
        return;
    }
    const int64_t T_ = int64_t(blocks) * kRedThreads;
    const int64_t J = m / T_;
    T* p = static_cast<T*>(part);
    reduce_first<T><<<blocks, kRedThreads, 0, st>>>(mode, h, l, y1, y2, n, J,
                                                    lis_ilog2(J), p);
    const int64_t J2 = T_ / kFinal;
    reduce_final<T><<<1, kFinal, 0, st>>>(R_SUM, mode, p, p + T_, nullptr,
                                          nullptr, T_, J2, lis_ilog2(J2),
                                          static_cast<T*>(out));
}

// ---- P: dd_update --------------------------------------------------------
// The elementwise DD operations: the vector updates with a DD scalar read
// on the device, and the elementwise add, sub, mul, div and sqrt, which
// on 0-d pairs are the solvers' scalar algebra: one launch where the
// plain version is 20-100 torch operations.
enum { U_AXPY = 0, U_XPAY = 1, U_SCAL = 2, U_ADD = 3, U_SUB = 4, U_MUL = 5,
       U_DIV = 6, U_SQRT = 7 };

template <typename T>
__device__ __forceinline__ DD<T> dd_neg(DD<T> x) { return {-x.hi, -x.lo}; }

// DD times a float
template <typename T>
__device__ __forceinline__ DD<T> mul_d(DD<T> x, T a) {
    const DD<T> p = two_prod(x.hi, a);
    return quick_two_sum(p.hi, add_(p.lo, mul_(x.lo, a)));
}

// QUAD_DIV with two Newton corrections (ddreal.py::div)
template <typename T>
__device__ __forceinline__ DD<T> dd_div(DD<T> x, DD<T> y) {
    const T q1 = div_(x.hi, y.hi);
    DD<T> r = dd_add(x, dd_neg(mul_d(y, q1)));
    const T q2 = div_(r.hi, y.hi);
    r = dd_add(r, dd_neg(mul_d(y, q2)));
    const T q3 = div_(r.hi, y.hi);
    const DD<T> s = quick_two_sum(q1, q2);
    return two_sum(s.hi, add_(q3, s.lo));
}
constexpr int kUpdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kUpdThreads)
update_kernel(int mode, const T* __restrict__ ah, const T* __restrict__ al,
              const T* __restrict__ xh, const T* __restrict__ xl,
              const T* __restrict__ yh, const T* __restrict__ yl,
              T* __restrict__ oh, T* __restrict__ ol, int64_t n) {
    const int64_t i = blockIdx.x * int64_t(kUpdThreads) + threadIdx.x;
    if (i >= n) return;
    const DD<T> x{xh[i], xl[i]};
    DD<T> r;
    if (mode == U_SCAL) {
        r = dd_mul(DD<T>{*ah, *al}, x);
    } else if (mode == U_SQRT) {
        r = dd_sqrt(x);
    } else {
        const DD<T> y{yh[i], yl[i]};
        if (mode == U_AXPY) r = dd_add(y, dd_mul(DD<T>{*ah, *al}, x));
        else if (mode == U_XPAY) r = dd_add(x, dd_mul(DD<T>{*ah, *al}, y));
        else if (mode == U_ADD) r = dd_add(x, y);
        else if (mode == U_SUB) r = dd_add(x, dd_neg(y));
        else if (mode == U_MUL) r = dd_mul(x, y);
        else r = dd_div(x, y);
    }
    oh[i] = r.hi;
    ol[i] = r.lo;
}

template <typename T>
void update_launch(int mode, const void* ah, const void* al, const void* xh,
                   const void* xl, const void* yh, const void* yl, void* oh,
                   void* ol, int64_t n, cudaStream_t st) {
    const int64_t blocks = (n + kUpdThreads - 1) / kUpdThreads;
    if (blocks == 0) return;
    update_kernel<T><<<(unsigned)blocks, kUpdThreads, 0, st>>>(
        mode, static_cast<const T*>(ah), static_cast<const T*>(al),
        static_cast<const T*>(xh), static_cast<const T*>(xl),
        static_cast<const T*>(yh), static_cast<const T*>(yl),
        static_cast<T*>(oh), static_cast<T*>(ol), n);
}

}  // namespace

// dtype 0 f32 limbs, 1 f64 limbs.  val, vlo (nullptr: none) (nnd*n,), off
// (nnd,) int64, x and y limbs (n,); trans needs a square A.
LIS_EXPORT int lis_dd_dia_spmv(int dtype, int trans, const void* val,
                               const void* vlo, const void* off,
                               const void* xh, const void* xl, void* yh,
                               void* yl, int64_t n, int64_t ncols,
                               int64_t nnd, void* stream) {
    if (nnd < 0 || nnd > kMaxNnd || n < 0) return (int)cudaErrorInvalidValue;
    LIS_DISPATCH(dtype, dia_launch, trans, val, vlo, off, xh, xl, yh, yl, n,
                 ncols, (int)nnd, static_cast<cudaStream_t>(stream));
}

// idx (n*w,) int32, val and vlo (nullptr: none) (n*w,), x limbs, y limbs
// (n,); rows past kMaxW entries take shared memory, 16 (w + 1) bytes at
// f64, at most the 227 KB a block can have.
LIS_EXPORT int lis_dd_ell_spmv(int dtype, const void* idx, const void* val,
                               const void* vlo, const void* xh,
                               const void* xl, void* yh, void* yl, int64_t n,
                               int64_t w, void* stream) {
    if (w < 1 || n < 0 || n > 0x7fffffff ||
        2 * (w + 1) * (dtype == 0 ? 4 : 8) > 232448)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int rc;
    if (dtype == 0) rc = ell_launch<float>(idx, val, vlo, xh, xl, yh, yl, n, (int)w, st);
    else if (dtype == 1) rc = ell_launch<double>(idx, val, vlo, xh, xl, yh, yl, n, (int)w, st);
    else return (int)cudaErrorInvalidValue;
    return rc ? rc : (int)cudaGetLastError();
}

// mode 0 sum, 1 dot (y given), 2 nrm2, 3 nrm1; m the padded power of two
// >= n; blocks 0 (one block) or a power of two with blocks*256 <= m;
// part (2*blocks*256,), out (2,) = hi, lo.
LIS_EXPORT int lis_dd_reduce(int dtype, int mode, const void* xh,
                             const void* xl, const void* yh, const void* yl,
                             int64_t n, int64_t m, int64_t blocks, void* part,
                             void* out, void* stream) {
    if (mode < 0 || mode > 3 || m < 1 || (m & (m - 1)) || m < n ||
        blocks < 0 || (blocks & (blocks - 1)) ||
        int64_t(blocks) * kRedThreads > m ||
        (blocks > 0 && int64_t(blocks) * kRedThreads < kFinal) ||
        (blocks == 0 && m / kFinal >= (int64_t(1) << kMaxDepth)))
        return (int)cudaErrorInvalidValue;
    LIS_DISPATCH(dtype, reduce_launch, mode, xh, xl, yh, yl, n, m,
                 (int)blocks, part, out, static_cast<cudaStream_t>(stream));
}

// mode 0 axpy (y + a x), 1 xpay (x + a y), 2 scal (a x), 3 x + y,
// 4 x - y, 5 x * y, 6 x / y, 7 sqrt(x), elementwise; a = (*ah, *al) on the
// device (read by modes 0-2 only), y unused by modes 2 and 7.
LIS_EXPORT int lis_dd_update(int dtype, int mode, const void* ah,
                             const void* al, const void* xh, const void* xl,
                             const void* yh, const void* yl, void* oh,
                             void* ol, int64_t n, void* stream) {
    if (mode < 0 || mode > 7 || n < 0) return (int)cudaErrorInvalidValue;
    LIS_DISPATCH(dtype, update_launch, mode, ah, al, xh, xl, yh, yl, oh, ol,
                 n, static_cast<cudaStream_t>(stream));
}
