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
#include <cooperative_groups.h>

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
// Bound: bytes (index and values read once, x's limbs gathered from L2).
// A warp per row left 30 of 64 lanes idle at 34 entries and spent most of
// its FP64 issue on shuffles and masked adds, so a block stages a span of
// `rows` consecutive rows instead: in ELL their entries are one
// contiguous stretch of index and value, streamed coalesced by all 256
// threads.  Each thread takes pairs (r, j), j < h = ceil(w/2): the
// TWO_PROD terms j and j + h of row r (the zero pad where j + h = w),
// added at once: that is the first level of lis_tpu's row tree
// (_dd_row_reduce), so only h terms a row reach shared memory.  A thread
// loads kEllBatch pairs' indices and values, then gathers their x, then
// adds: the loads of a batch are in flight together, which the memory's
// latency needs.  Then one thread a row walks the rest of the tree in
// shared memory, with every lane busy (an ELL row has w entries whatever
// its true length): while more than one term is left an odd count gets
// one zero term at its end and term j takes term j + half.  A row's h
// terms sit at a stride of h | 1 values, odd, so a warp's 32 rows fall in
// distinct banks.  The gathers, random over x, are what the card spends
// most on, so a first small launch lays x's limbs side by side and a
// gather brings both in one sector.  The staged kernel takes rows of up
// to kMaxStageW entries; the wrapper takes it up to 64 (ddreal.py
// _ELL_STAGE_W, where ell_long_kernel below, rows = 0, measured faster).
constexpr int kEllThreads = 256;
constexpr int kEllBatch = 4;
constexpr int kMaxStageW = 128;

// x's limbs side by side, so that one gather brings both in one sector
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };
template <typename T> using pair_t = typename Pair<T>::type;

template <typename T>
__global__ void __launch_bounds__(kEllThreads)
ell_pack_kernel(const T* __restrict__ xh, const T* __restrict__ xl,
                pair_t<T>* __restrict__ xp, int64_t n) {
    const int64_t i = blockIdx.x * int64_t(kEllThreads) + threadIdx.x;
    if (i < n) xp[i] = pair_t<T>{xh[i], xl[i]};
}

template <typename T, bool LO>
__device__ __forceinline__ DD<T> ell_term(const int32_t* __restrict__ idx,
                                          const T* __restrict__ val,
                                          const T* __restrict__ vlo,
                                          const pair_t<T>* __restrict__ xp,
                                          int64_t e) {
    const pair_t<T> g = xp[idx[e]];
    const T v = val[e];
    DD<T> t = two_prod(v, g.x);
    t.lo = add_(t.lo, mul_(v, g.y));
    if (LO) t.lo = add_(t.lo, mul_(vlo[e], g.x));
    return t;
}

template <typename T, bool LO>
__global__ void __launch_bounds__(kEllThreads, 2)
ell_stage_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                 const T* __restrict__ vlo, const pair_t<T>* __restrict__ xp,
                 T* __restrict__ yh, T* __restrict__ yl, int64_t n, int w,
                 int rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = (w + 1) >> 1;
    const int S = h | 1;
    T* sh = reinterpret_cast<T*>(smem);
    T* sl = sh + rows * S;
    const int64_t row0 = int64_t(blockIdx.x) * rows;
    const int nr = int(n - row0 < rows ? n - row0 : rows);
    const unsigned P = unsigned(nr) * unsigned(h);
    // kEllBatch pairs a thread at once: all their index and value loads,
    // then all their gathers of x, then the arithmetic, so that enough
    // loads are in flight to cover the memory's latency
    for (unsigned p0 = threadIdx.x; p0 < P; p0 += kEllBatch * kEllThreads) {
        unsigned at[kEllBatch];
        int jp[kEllBatch];
        int32_t c[kEllBatch][2];
        T v[kEllBatch][2], vl[kEllBatch][2];
#pragma unroll
        for (int u = 0; u < kEllBatch; ++u) {
            const unsigned p = p0 + u * kEllThreads;
            const unsigned r = p / unsigned(h);
            const int j = int(p - r * unsigned(h));
            const int64_t e = (row0 + r) * w + j;
            at[u] = r * S + j;
            jp[u] = j;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const bool in = p < P && (k == 0 || j + h < w);
                c[u][k] = in ? idx[e + k * h] : 0;
                v[u][k] = in ? val[e + k * h] : T(0);
                vl[u][k] = LO && in ? vlo[e + k * h] : T(0);
            }
        }
        pair_t<T> g[kEllBatch][2];
#pragma unroll
        for (int u = 0; u < kEllBatch; ++u) {
#pragma unroll
            for (int k = 0; k < 2; ++k) g[u][k] = xp[c[u][k]];
        }
#pragma unroll
        for (int u = 0; u < kEllBatch; ++u) {
            if (p0 + u * kEllThreads >= P) break;
            DD<T> t[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                t[k] = two_prod(v[u][k], g[u][k].x);
                t[k].lo = add_(t[k].lo, mul_(v[u][k], g[u][k].y));
                if (LO) t[k].lo = add_(t[k].lo, mul_(vl[u][k], g[u][k].x));
            }
            // term j + h past the row is lis_tpu's zero pad: (0, 0)
            if (w > 1) {
                if (jp[u] + h >= w) t[1] = DD<T>{T(0), T(0)};
                t[0] = dd_add(t[0], t[1]);
            }
            sh[at[u]] = t[0].hi;
            sl[at[u]] = t[0].lo;
        }
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r >= nr) return;
    T* th = sh + r * S;
    T* tl = sl + r * S;
    for (int m = h; m > 1;) {
        const int valid = m;
        m += m & 1;
        const int half = m >> 1;
        for (int j = 0; j < half; ++j) {
            DD<T> b{T(0), T(0)};
            if (j + half < valid) b = DD<T>{th[j + half], tl[j + half]};
            const DD<T> s = dd_add(DD<T>{th[j], tl[j]}, b);
            th[j] = s.hi;
            tl[j] = s.lo;
        }
        m = half;
    }
    yh[row0 + r] = th[0];
    yl[row0 + r] = tl[0];
}

// Long rows: one warp a row (a block), its terms and the
// tree in dynamic shared memory (2 (w + 1) values: the zero pad of an odd
// level sits at index m).  Within a level lane j writes term j < half and
// reads term j + half >= half, so a level needs no barrier but the one
// after it.
template <typename T, bool LO>
__global__ void __launch_bounds__(32)
ell_long_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                const T* __restrict__ vlo, const pair_t<T>* __restrict__ xp,
                T* __restrict__ yh, T* __restrict__ yl, int w) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* sh = reinterpret_cast<T*>(smem);
    T* sl = sh + w + 1;
    const int lane = threadIdx.x;
    const int64_t row = blockIdx.x;
    const int64_t base = row * w;
    for (int l = lane; l < w; l += 32) {
        const DD<T> t = ell_term<T, LO>(idx, val, vlo, xp, base + l);
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
               const void* xh, const void* xl, void* xpack, void* yh,
               void* yl, int64_t n, int64_t nx, int w, int rows,
               cudaStream_t st) {
    if (n == 0) return 0;
    const int32_t* i = static_cast<const int32_t*>(idx);
    const T* v = static_cast<const T*>(val);
    const T* vl = static_cast<const T*>(vlo);
    pair_t<T>* xp = static_cast<pair_t<T>*>(xpack);
    T* oh = static_cast<T*>(yh);
    T* ol = static_cast<T*>(yl);
    if (nx > 0)
        ell_pack_kernel<T><<<(unsigned)((nx + kEllThreads - 1) / kEllThreads),
                             kEllThreads, 0, st>>>(static_cast<const T*>(xh),
                                                   static_cast<const T*>(xl),
                                                   xp, nx);
    size_t smem;
    if (rows > 0) {
        smem = 2 * size_t(rows) * (((w + 1) >> 1) | 1) * sizeof(T);
        auto k = vlo ? ell_stage_kernel<T, true> : ell_stage_kernel<T, false>;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        k<<<(unsigned)((n + rows - 1) / rows), kEllThreads, smem, st>>>(
            i, v, vl, xp, oh, ol, n, w, rows);
        return 0;
    }
    smem = 2 * (size_t(w) + 1) * sizeof(T);
    auto k = vlo ? ell_long_kernel<T, true> : ell_long_kernel<T, false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    k<<<(unsigned)n, 32, smem, st>>>(i, v, vl, xp, oh, ol, w);
    return 0;
}

// ---- O: dd_reduce --------------------------------------------------------
// lis_tpu's _dd_sum: the m = 2^k padded terms (zeros past n), then level
// by level a[i] = a[i] + a[i + half] until one is left, then
// quick_two_sum (and sqrt for nrm2).  Level L adds the pairs whose
// indices differ in bit k - L, so the tree adds the high index bits
// first and the low ones last.  The tree fixes the order of the
// additions, not where they run.  Write index i = t + T*j with thread
// t = b*B + s (block b of G, position s of B threads) and b = r + R*u
// (group r of R, member u of g = G/R):
//
//   pass 1   thread t: the halving tree over j (the top bits), J = m/T
//            terms walked in bit-reversed order, where it is a neighbour
//            tree: register subtrees of kChunk, the next chunk's loads in
//            flight, and a stack above them;
//   groups   after a grid barrier, block r < R: for each s, the halving
//            tree over u (G's top bits) of the g partials of group r, so
//            the R groups run on R SMs at once;
//   final    after a second barrier, block 0: for each s, the halving
//            tree over r; then over s, the levels down to 32 in shared
//            memory and the last five by shuffles; then the finish in
//            thread 0.
//
// The blocks meet at grid barriers of one cooperative launch, with G at
// most 128 so that every block is resident at once: one launch a call and
// no counters to zero (a launch with arrival counters in the call's
// scratch, zeroed by a memset, and a two-launch form measured slower).
// Up to 2^15 padded terms one block of up to kFinal threads does all
// (G = 0).
enum { R_SUM = 0, R_DOT = 1, R_NRM2 = 2, R_NRM1 = 3 };
constexpr int kRedThreads = 256;
constexpr int kFinal = 1024;
constexpr int kMaxDepth = 40;
constexpr int kChunk = 4;           // terms a thread loads ahead in pass 1
constexpr int kMaxGrid = 128;       // resident at once on 114+ SMs

// term j*stride + t of the reduction: load() reads its raw limbs (zeros
// past n, whose term is (+0, +0) like the plain version's padding), term()
// forms it, so a walk can issue the next chunk's loads before it adds
template <typename T>
struct Terms {
    struct Raw { T xh, xl, yh, yl; };
    int mode;
    int64_t n, stride, t;
    const T *xh, *xl, *yh, *yl;

    __device__ __forceinline__ Raw load(int64_t j) const {
        const int64_t i = j * stride + t;
        Raw r{T(0), T(0), T(0), T(0)};
        if (i < n) {
            r.xh = xh[i];
            r.xl = xl[i];
            if (mode == R_DOT) {
                r.yh = yh[i];
                r.yl = yl[i];
            }
        }
        return r;
    }

    __device__ __forceinline__ DD<T> term(const Raw& r) const {
        const DD<T> x{r.xh, r.xl};
        if (mode == R_DOT) return dd_mul(x, DD<T>{r.yh, r.yl});
        if (mode == R_NRM2) return dd_mul(x, x);
        if (mode == R_NRM1) {
            // torch.sign: 0 for 0 and for NaN
            const T sg = x.hi > T(0) ? T(1) : (x.hi < T(0) ? T(-1) : T(0));
            return {fabs(x.hi), mul_(sg, x.lo)};
        }
        return x;
    }
};

// partial j of a strided set written by other blocks of this launch: read
// from L2 (ld.cg), never from a stale L1 line
template <typename T>
struct Parts {
    using Raw = DD<T>;
    const T *hi, *lo;
    int64_t base, stride;

    __device__ __forceinline__ Raw load(int64_t j) const {
        const int64_t i = base + j * stride;
        return {__ldcg(hi + i), __ldcg(lo + i)};
    }

    __device__ __forceinline__ DD<T> term(const Raw& r) const { return r; }
};

__device__ __forceinline__ int64_t bitrev(int64_t p, int bits) {
    return bits == 0 ? 0 : int64_t(__brevll(uint64_t(p)) >> (64 - bits));
}

// The halving tree over the J = 2^bits values f(j), walked in
// bit-reversed order with a stack.  With J >= C the walk goes in chunks of
// C positions, each a whole subtree of height log2(C) added in registers,
// and only the chunk's sum goes through the stack; the loads of chunk
// c + 1 are issued before the adds of chunk c.
template <typename T, int C, typename F>
__device__ DD<T> walk(const F& f, int64_t J, int bits) {
    DD<T> stack[kMaxDepth];
    int depth = 0;
    if (J < C) {
        for (int64_t p = 0; p < J; ++p) {
            DD<T> v = f.term(f.load(bitrev(p, bits)));
            for (int64_t q = p; q & 1; q >>= 1) v = dd_add(stack[--depth], v);
            stack[depth++] = v;
        }
        return stack[0];
    }
    typename F::Raw nxt[C];
#pragma unroll
    for (int u = 0; u < C; ++u) nxt[u] = f.load(bitrev(u, bits));
    for (int64_t c = 0; c < J / C; ++c) {
        typename F::Raw cur[C];
#pragma unroll
        for (int u = 0; u < C; ++u) cur[u] = nxt[u];
        if (c + 1 < J / C) {
#pragma unroll
            for (int u = 0; u < C; ++u)
                nxt[u] = f.load(bitrev(C * (c + 1) + u, bits));
        }
        DD<T> v[C];
#pragma unroll
        for (int u = 0; u < C; ++u) v[u] = f.term(cur[u]);
#pragma unroll
        for (int width = C; width > 1; width >>= 1) {
#pragma unroll
            for (int k = 0; k < width / 2; ++k)
                v[k] = dd_add(v[2 * k], v[2 * k + 1]);
        }
        DD<T> s = v[0];
        for (int64_t q = c; q & 1; q >>= 1) s = dd_add(stack[--depth], s);
        stack[depth++] = s;
    }
    return stack[0];
}

// The halving tree over the block's B = blockDim.x <= MAXB values v (one
// a thread), then the finish into out[0], out[1] by thread 0.  Levels
// down to 32 in shared memory, the last five by shuffles in warp 0.
template <typename T, int MAXB>
__device__ void block_finish(DD<T> v, int finish, T* __restrict__ out) {
    __shared__ T sh[MAXB], sl[MAXB];
    const int B = blockDim.x;
    const int t = threadIdx.x;
    int half = B >> 1;
    if (half >= 32) {
        sh[t] = v.hi;
        sl[t] = v.lo;
        __syncthreads();
        for (; half >= 32; half >>= 1) {
            if (t < half) {
                const DD<T> r = dd_add(DD<T>{sh[t], sl[t]},
                                       DD<T>{sh[t + half], sl[t + half]});
                sh[t] = r.hi;
                sl[t] = r.lo;
            }
            __syncthreads();
        }
        if (t >= 32) return;
        v = DD<T>{sh[t], sl[t]};
    }
    const unsigned mask = B >= 32 ? 0xffffffffu : (1u << B) - 1u;
    for (; half > 0; half >>= 1) {
        const T oh = __shfl_down_sync(mask, v.hi, half);
        const T ol = __shfl_down_sync(mask, v.lo, half);
        if (t < half) v = dd_add(v, DD<T>{oh, ol});
    }
    if (t == 0) {
        DD<T> r = quick_two_sum(v.hi, v.lo);
        if (finish == R_NRM2) r = dd_sqrt(r);
        out[0] = r.hi;
        out[1] = r.lo;
    }
}

// One block of B <= kFinal threads: the walk over m terms (J = m / B
// each), then block_finish.
template <typename T>
__global__ void __launch_bounds__(kFinal)
reduce_block(int mode, const T* __restrict__ xh, const T* __restrict__ xl,
             const T* __restrict__ yh, const T* __restrict__ yl, int64_t n,
             int64_t J, int bits, T* __restrict__ out) {
    const Terms<T> f{mode, n, int64_t(blockDim.x), int64_t(threadIdx.x),
                     xh, xl, yh, yl};
    block_finish<T, kFinal>(walk<T, kChunk>(f, J, bits), mode, out);
}

struct Grid {
    int64_t n, J;
    int bits, G, R, gbits, rbits;
};

template <typename T>
__global__ void __launch_bounds__(kRedThreads, 2)
reduce_grid(int mode, const T* __restrict__ xh, const T* __restrict__ xl,
            const T* __restrict__ yh, const T* __restrict__ yl, Grid p,
            T* scratch) {
    constexpr int B = kRedThreads;
    const int s = threadIdx.x;
    const int b = blockIdx.x;
    const int64_t TT = int64_t(p.G) * B;
    T* out = scratch;
    T* ph = scratch + 2;
    T* pl = ph + TT;
    T* qh = pl + TT;
    T* ql = qh + int64_t(p.R) * B;
    const Terms<T> f{mode, p.n, TT, int64_t(b) * B + s, xh, xl, yh, yl};
    const DD<T> v = walk<T, kChunk>(f, p.J, p.bits);
    ph[int64_t(b) * B + s] = v.hi;
    pl[int64_t(b) * B + s] = v.lo;
    cooperative_groups::this_grid().sync();
    if (b < p.R) {
        const DD<T> g = walk<T, 8>(Parts<T>{ph, pl, int64_t(b) * B + s,
                                            int64_t(p.R) * B},
                                   p.G / p.R, p.gbits);
        qh[int64_t(b) * B + s] = g.hi;
        ql[int64_t(b) * B + s] = g.lo;
    }
    cooperative_groups::this_grid().sync();
    if (b != 0) return;
    block_finish<T, B>(walk<T, 8>(Parts<T>{qh, ql, s, B}, p.R, p.rbits), mode,
                       out);
}

template <typename T>
int reduce_launch(int mode, const void* xh, const void* xl, const void* yh,
                  const void* yl, int64_t n, int64_t m, int blocks,
                  int groups, void* scratch, cudaStream_t st) {
    const T* h = static_cast<const T*>(xh);
    const T* l = static_cast<const T*>(xl);
    const T* y1 = static_cast<const T*>(yh);
    const T* y2 = static_cast<const T*>(yl);
    T* out = static_cast<T*>(scratch);
    if (blocks == 0) {
        const int B = int(m < kFinal ? m : kFinal);
        const int64_t J = m / B;
        reduce_block<T><<<1, B, 0, st>>>(mode, h, l, y1, y2, n, J,
                                         lis_ilog2(J), out);
        return 0;
    }
    const int64_t TT = int64_t(blocks) * kRedThreads;
    Grid p{n, m / TT, lis_ilog2(m / TT), blocks, groups,
           lis_ilog2(blocks / groups), lis_ilog2(groups)};
    void* args[] = {&mode, &h, &l, &y1, &y2, &p, &out};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)reduce_grid<T>, dim3(blocks), dim3(kRedThreads), args,
        0, st);
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

// idx (n*w,) int32 in [0, nx), val and vlo (nullptr: none) (n*w,), x
// limbs (nx,), xpack (2*nx,) scratch for them side by side, y limbs (n,);
// rows > 0: the staged kernel, that many rows a block (w up to
// kMaxStageW, 2 rows (ceil(w/2) | 1) values of shared memory); rows = 0:
// a warp a row, 2 (w + 1) values of shared memory.  Either within the
// 227 KB a block can have.
LIS_EXPORT int lis_dd_ell_spmv(int dtype, const void* idx, const void* val,
                               const void* vlo, const void* xh,
                               const void* xl, void* xpack, void* yh,
                               void* yl, int64_t n, int64_t nx, int64_t w,
                               int64_t rows, void* stream) {
    const int64_t es = dtype == 0 ? 4 : 8;
    if (w < 1 || n < 0 || n > 0x7fffffff || nx < 0 || rows < 0 ||
        rows > kEllThreads || (rows > 0 && w > kMaxStageW) ||
        (rows > 0 ? 2 * rows * (((w + 1) >> 1) | 1)
                  : 2 * (w + 1)) * es > 232448)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int rc;
    if (dtype == 0) rc = ell_launch<float>(idx, val, vlo, xh, xl, xpack, yh, yl, n, nx, (int)w, (int)rows, st);
    else if (dtype == 1) rc = ell_launch<double>(idx, val, vlo, xh, xl, xpack, yh, yl, n, nx, (int)w, (int)rows, st);
    else return (int)cudaErrorInvalidValue;
    const int last = (int)cudaGetLastError();   // read, so it clears
    return rc ? rc : last;
}

// mode 0 sum, 1 dot (y given), 2 nrm2, 3 nrm1; m the padded power of two
// >= n; blocks 0 (one block, m / kFinal terms a thread) or a power of two
// from 4 to 128 of 256-thread blocks with blocks * 256 <= m, in groups (a
// power of two dividing blocks), launched cooperatively.  scratch: out
// (2,) = hi, lo, then with blocks > 0 the partials, 2 (blocks + groups)
// 256 values.
LIS_EXPORT int lis_dd_reduce(int dtype, int mode, const void* xh,
                             const void* xl, const void* yh, const void* yl,
                             int64_t n, int64_t m, int64_t blocks,
                             int64_t groups, void* scratch, void* stream) {
    if (mode < 0 || mode > 3 || m < 1 || (m & (m - 1)) || m < n ||
        blocks < 0 || (blocks & (blocks - 1)) || blocks > kMaxGrid ||
        int64_t(blocks) * kRedThreads > m ||
        (blocks > 0 && (blocks < 4 || groups < 1 || (groups & (groups - 1))
                        || blocks % groups)) ||
        (blocks == 0 && m / kFinal >= (int64_t(1) << kMaxDepth)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int rc;
    if (dtype == 0) rc = reduce_launch<float>(mode, xh, xl, yh, yl, n, m, (int)blocks, (int)groups, scratch, st);
    else if (dtype == 1) rc = reduce_launch<double>(mode, xh, xl, yh, yl, n, m, (int)blocks, (int)groups, scratch, st);
    else return (int)cudaErrorInvalidValue;
    const int last = (int)cudaGetLastError();   // read, so it clears
    return rc ? rc : last;
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
