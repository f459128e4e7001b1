// Double-double arithmetic and lis_tpu's halving tree, shared by kernels
// M-P (dd.cu) and the fused CG step S (dd_cg.cu).
//
// Exactness.  The transforms are exact only if every product and every
// sum is rounded on its own: nvcc contracts a*b + c into an FMA by
// default, which turns the error terms of SPLIT and TWO_PROD into zeros
// and the whole path into plain double.  So every operation below is an
// explicit round-to-nearest intrinsic (__dadd_rn, __dsub_rn, __dmul_rn,
// __ddiv_rn, __dsqrt_rn and their f32 forms), which nvcc never contracts;
// the build flags are those of the other kernels.  TWO_PROD is Dekker's
// split (no FMA), in the plain version's order (lis_tpu_torch/core/
// ddreal.py), so every kernel equals its plain PyTorch version bit for bit.
#pragma once

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

// ---- the halving tree of _dd_sum (kernel O, and S's reductions) ----------
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
//            tree: register subtrees of C, the next chunk's loads in
//            flight, and a stack above them;
//   groups   after a grid barrier, block r < R: for each s, the halving
//            tree over u (G's top bits) of the g partials of group r, so
//            the R groups run on R SMs at once;
//   final    after a second barrier, block 0: for each s, the halving
//            tree over r; then over s, the levels down to 32 in shared
//            memory and the last five by shuffles; then the finish in
//            thread 0.
//
// Any power-of-two grid adds in the same order: the walk's result at
// position t is the tree's level log2(J) there, whatever T is.  The blocks
// meet at grid barriers of one cooperative launch, every block resident
// at once.  Up to 2^15 padded terms one block of up to kFinal threads
// does all (G = 0).
//
// A tree carries one DD sum (DD<T>) or two side by side (DD2<T>, the two
// reductions of S's update pass): each is added as it would be alone.
enum { R_SUM = 0, R_DOT = 1, R_NRM2 = 2, R_NRM1 = 3 };
constexpr int kRedThreads = 256;
constexpr int kFinal = 1024;
constexpr int kMaxDepth = 40;
constexpr int kChunk = 4;           // terms a thread loads ahead in pass 1
constexpr int kMaxGrid = 128;       // resident at once on 114+ SMs

template <typename T>
struct DD2 {
    DD<T> a, b;
};

template <typename T>
__device__ __forceinline__ DD2<T> dd_add(const DD2<T>& x, const DD2<T>& y) {
    return {dd_add(x.a, y.a), dd_add(x.b, y.b)};
}

// a tree's value as K DD sums
template <typename V> struct Lanes;
template <typename T> struct Lanes<DD<T>> {
    using limb = T;
    static constexpr int K = 1;
    __device__ static DD<T>& at(DD<T>& v, int) { return v; }
};
template <typename T> struct Lanes<DD2<T>> {
    using limb = T;
    static constexpr int K = 2;
    __device__ static DD<T>& at(DD2<T>& v, int k) { return k ? v.b : v.a; }
};

// term j*stride + t of kernel O's reductions: load() reads its raw limbs
// (zeros past n, whose term is (+0, +0) like the plain version's
// padding), term() forms it, so a walk can issue the next chunk's loads
// before it adds
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

// The partials of a tree in device memory, `len` a set: sum k's hi limbs
// at a[2k len + i], its lo limbs at a[(2k + 1) len + i]
template <typename V>
__device__ __forceinline__ void put_part(typename Lanes<V>::limb* a,
                                         int64_t len, int64_t i, V v) {
#pragma unroll
    for (int k = 0; k < Lanes<V>::K; ++k) {
        a[2 * k * len + i] = Lanes<V>::at(v, k).hi;
        a[(2 * k + 1) * len + i] = Lanes<V>::at(v, k).lo;
    }
}

// partial j of a strided set written by other blocks of this launch: read
// from L2 (ld.cg), never from a stale L1 line
template <typename V>
struct Parts {
    using Raw = V;
    using T = typename Lanes<V>::limb;
    const T* a;
    int64_t len, base, stride;

    __device__ __forceinline__ Raw load(int64_t j) const {
        const int64_t i = base + j * stride;
        V v;
#pragma unroll
        for (int k = 0; k < Lanes<V>::K; ++k)
            Lanes<V>::at(v, k) = DD<T>{__ldcg(a + 2 * k * len + i),
                                       __ldcg(a + (2 * k + 1) * len + i)};
        return v;
    }

    __device__ __forceinline__ V term(const Raw& r) const { return r; }
};

__device__ __forceinline__ int64_t bitrev(int64_t p, int bits) {
    return bits == 0 ? 0 : int64_t(__brevll(uint64_t(p)) >> (64 - bits));
}

// The halving tree over the J = 2^bits values f(j), walked in
// bit-reversed order with a stack.  With J >= C the walk goes in chunks of
// C positions, each a whole subtree of height log2(C) added in registers,
// and only the chunk's sum goes through the stack; the loads of chunk
// c + 1 are issued before the adds of chunk c.
template <int C, typename F>
__device__ auto walk(const F& f, int64_t J, int bits)
    -> decltype(f.term(f.load(0))) {
    using V = decltype(f.term(f.load(0)));
    V stack[kMaxDepth];
    int depth = 0;
    if (J < C) {
        for (int64_t p = 0; p < J; ++p) {
            V v = f.term(f.load(bitrev(p, bits)));
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
        V v[C];
#pragma unroll
        for (int u = 0; u < C; ++u) v[u] = f.term(cur[u]);
#pragma unroll
        for (int width = C; width > 1; width >>= 1) {
#pragma unroll
            for (int k = 0; k < width / 2; ++k)
                v[k] = dd_add(v[2 * k], v[2 * k + 1]);
        }
        V s = v[0];
        for (int64_t q = c; q & 1; q >>= 1) s = dd_add(stack[--depth], s);
        stack[depth++] = s;
    }
    return stack[0];
}

// The halving tree over the block's B = blockDim.x <= MAXB values v (one
// a thread), then fin(sum) in thread 0.  Levels down to 32 in shared
// memory, the last five by shuffles in warp 0.
template <int MAXB, typename V, typename Fin>
__device__ void block_finish(V v, const Fin& fin) {
    using L = Lanes<V>;
    using T = typename L::limb;
    constexpr int K = L::K;
    __shared__ T sh[K][MAXB], sl[K][MAXB];
    const int B = blockDim.x;
    const int t = threadIdx.x;
    int half = B >> 1;
    if (half >= 32) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            sh[k][t] = L::at(v, k).hi;
            sl[k][t] = L::at(v, k).lo;
        }
        __syncthreads();
        for (; half >= 32; half >>= 1) {
            if (t < half) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const DD<T> r = dd_add(DD<T>{sh[k][t], sl[k][t]},
                                           DD<T>{sh[k][t + half],
                                                 sl[k][t + half]});
                    sh[k][t] = r.hi;
                    sl[k][t] = r.lo;
                }
            }
            __syncthreads();
        }
        if (t >= 32) return;
#pragma unroll
        for (int k = 0; k < K; ++k) L::at(v, k) = DD<T>{sh[k][t], sl[k][t]};
    }
    const unsigned mask = B >= 32 ? 0xffffffffu : (1u << B) - 1u;
    for (; half > 0; half >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const T oh = __shfl_down_sync(mask, L::at(v, k).hi, half);
            const T ol = __shfl_down_sync(mask, L::at(v, k).lo, half);
            if (t < half) L::at(v, k) = dd_add(L::at(v, k), DD<T>{oh, ol});
        }
    }
    if (t == 0) fin(v);
}

struct Grid {
    int64_t n, J;
    int bits, G, R, gbits, rbits;
};

// The grid form of the tree: f's pass-1 walk in every thread (f holds the
// thread's t = b*B + s and the stride G*B), its partials and the groups'
// in `part` (2 K (G + R) B values), then fin(sum) in thread 0 of block 0.
// Launched cooperatively with G blocks of kRedThreads.
template <int C, typename T, typename F, typename Fin>
__device__ void grid_tree(const F& f, const Grid& p, T* part,
                          const Fin& fin) {
    using V = decltype(f.term(f.load(0)));
    constexpr int B = kRedThreads;
    const int s = threadIdx.x;
    const int b = blockIdx.x;
    const int64_t TT = int64_t(p.G) * B;
    const int64_t RB = int64_t(p.R) * B;
    T* qpart = part + 2 * Lanes<V>::K * TT;
    put_part(part, TT, int64_t(b) * B + s, walk<C>(f, p.J, p.bits));
    cooperative_groups::this_grid().sync();
    if (b < p.R) {
        put_part(qpart, RB, int64_t(b) * B + s,
                 walk<8>(Parts<V>{part, TT, int64_t(b) * B + s, RB},
                         p.G / p.R, p.gbits));
    }
    cooperative_groups::this_grid().sync();
    if (b != 0) return;
    block_finish<B>(walk<8>(Parts<V>{qpart, RB, s, B}, p.R, p.rbits), fin);
}

// The schedule's checks shared by the C entries: m the padded power of
// two >= n; blocks 0 (one block, m / kFinal terms a thread) or a power of
// two from 4 to kMaxGrid with blocks * kRedThreads <= m, in groups (a
// power of two dividing blocks)
inline bool tree_plan_ok(int64_t n, int64_t m, int64_t blocks,
                         int64_t groups) {
    return !(m < 1 || (m & (m - 1)) || m < n || n < 0 || blocks < 0 ||
             (blocks & (blocks - 1)) || blocks > kMaxGrid ||
             int64_t(blocks) * kRedThreads > m ||
             (blocks > 0 && (blocks < 4 || groups < 1 ||
                             (groups & (groups - 1)) || blocks % groups)) ||
             (blocks == 0 && m / kFinal >= (int64_t(1) << kMaxDepth)));
}

// a launcher's own error code, else the launch's (read, so it clears)
inline int launched(int rc) {
    const int last = (int)cudaGetLastError();
    return rc ? rc : last;
}

inline Grid tree_grid(int64_t n, int64_t m, int blocks, int groups) {
    const int64_t TT = int64_t(blocks) * kRedThreads;
    return Grid{n, m / TT, lis_ilog2(m / TT), blocks, groups,
                lis_ilog2(blocks / groups), lis_ilog2(groups)};
}

}  // namespace
