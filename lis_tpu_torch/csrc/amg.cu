// Kernels J and L · lattice_prolong / lattice_restrict — SA-AMG's
// coarse-grid transfers on a lattice.
//
// lis_tpu has no Pallas kernel here: XLA fuses the streamed prolongator of
// lis_tpu/precon/saamg.py (LatticeTent :298-327, ImplicitP :330-352): a
// broadcast and crop, a DIA product and elementwise passes for the
// prolongation, a DIA product of the transpose, a pad and a box sum for
// the restriction.  PyTorch would run about nine launches and three
// fine-level temporaries for each.  On a lattice of dims (f0, f1, f2)
// (slowest to fastest; 1-D and 2-D lattices have leading 1s), the
// aggregates are boxes of 3 points per dimension, cropped at the far
// edges, (c0, c1, c2) = ceil(f / 3) of them; wc[c] = 1/sqrt(|box c|).
// With A the level's square DIA (val[k, i] = A[i, i + off_k]), dinv =
// 1/diag(A) and w = 2/3:
//
//   J:  out[i] = x[i] + (z[i] - (w*dinv[i]) * sum_k val[k,i] * z[i+off_k]),
//       z[j] = ec[box(j)] * wc[box(j)]
//   L:  rc[c] = (sum over box c, lexicographic, of
//               r[j] - w * sum_k val[k, j-off_k] * (dinv[j-off_k] * r[j-off_k]))
//               * wc[c]
//
// Terms whose index falls outside [0, n) are dropped, as kernels E and F
// drop them.  Every product and sum is rounded on its own (no fused
// multiply-add) in the order of the plain PyTorch version
// (lis_tpu_torch/ops/amg.py), so on real data both kernels equal it bit for
// bit.
//
// Bound on the H100: bytes.  J reads the diagonals, dinv and x and writes
// out once, (nnd + 3) n elements; L reads the diagonals, dinv and r,
// (nnd + 2) n elements, and writes the coarse vector.  The coarse vectors
// and the shifted reads come from L1 and L2.
//
// J: one thread per fine row, consecutive threads on consecutive rows, so
// every diagonal is one coalesced stream, as in kernel E.  z is formed on
// the fly from the neighbour's box, so no fine temporary is stored.  A
// neighbour's lattice point comes from the row's own point and the
// offset's digits (d0, d1, d2), 0 <= d2 < f2, 0 <= d1 < f1, with one carry
// per dimension: no division per term.
// L: a block takes a tile of kTile coarse points along the fastest
// dimension at one (c0, c1).  Its threads form z for the up to 9 * 3 kTile
// fine rows of those boxes (kernel F's term order, coalesced along the
// fastest dimension) into shared memory; then one thread per coarse point
// sums its box and scales it.
//
// Types: float or double diagonals, dinv and wc, with vectors of the same
// type or of the complex type of the same width.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNnd = 512;
constexpr int kTile = 32;                 // L: coarse points a block
constexpr int kTileRows = 9 * 3 * kTile;  // L: fine rows a block

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
__device__ __forceinline__ Cx<T> mul_(Cx<T> a, T b) {
    return Cx<T>{mul_(a.re, b), mul_(a.im, b)};
}
template <typename T>
__device__ __forceinline__ Cx<T> mul_(T b, Cx<T> a) {
    return Cx<T>{mul_(b, a.re), mul_(b, a.im)};
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

struct Lattice {
    int64_t n;
    int f0, f1, f2;   // fine dims
    int c0, c1, c2;   // coarse dims
};

// The row's box: coarse index of the lattice point (p0, p1, p2).
__device__ __forceinline__ int64_t box_of(const Lattice& g, int p0, int p1,
                                          int p2) {
    return (int64_t(p0 / 3) * g.c1 + p1 / 3) * g.c2 + p2 / 3;
}

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
prolong_kernel(const T* __restrict__ val, const int64_t* __restrict__ off,
               const T* __restrict__ dinv, const T* __restrict__ wc,
               const U* __restrict__ ec, const U* __restrict__ x,
               U* __restrict__ out, Lattice g, int nnd, T omega) {
    __shared__ int64_t offs[kMaxNnd];
    __shared__ int dig[kMaxNnd][3];
    for (int k = threadIdx.x; k < nnd; k += kThreads) {
        // floor division: 0 <= d2 < f2 and 0 <= d1 < f1 for any sign
        const int64_t o = off[k];
        int64_t q = o / g.f2, d2 = o - q * g.f2;
        if (d2 < 0) { d2 += g.f2; --q; }
        int64_t d0 = q / g.f1, d1 = q - d0 * g.f1;
        if (d1 < 0) { d1 += g.f1; --d0; }
        offs[k] = o;
        dig[k][0] = int(d0);
        dig[k][1] = int(d1);
        dig[k][2] = int(d2);
    }
    __syncthreads();
    const int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x;
    if (i >= g.n) return;
    const uint32_t q = uint32_t(i) / uint32_t(g.f2);
    const int p2 = int(uint32_t(i) - q * uint32_t(g.f2));
    const int p0 = int(q / uint32_t(g.f1));
    const int p1 = int(q - uint32_t(p0) * uint32_t(g.f1));
    int64_t b = box_of(g, p0, p1, p2);
    const U zi = mul_(ec[b], wc[b]);
    U acc = zero_of(U{});
#pragma unroll 4
    for (int k = 0; k < nnd; ++k) {
        const int64_t j = i + offs[k];
        if (j < 0 || j >= g.n) continue;
        int s2 = p2 + dig[k][2], s1 = p1 + dig[k][1], s0 = p0 + dig[k][0];
        if (s2 >= g.f2) { s2 -= g.f2; ++s1; }
        if (s1 >= g.f1) { s1 -= g.f1; ++s0; }
        b = box_of(g, s0, s1, s2);
        acc = add_(acc, mul_(val[int64_t(k) * g.n + i], mul_(ec[b], wc[b])));
    }
    out[i] = add_(x[i], sub_(zi, mul_(mul_(omega, dinv[i]), acc)));
}

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
restrict_kernel(const T* __restrict__ val, const int64_t* __restrict__ off,
                const T* __restrict__ dinv, const T* __restrict__ wc,
                const U* __restrict__ r, U* __restrict__ rc, Lattice g,
                int ntile, int nnd, T omega) {
    __shared__ int64_t offs[kMaxNnd];
    __shared__ U zs[kTileRows];
    for (int k = threadIdx.x; k < nnd; k += kThreads) offs[k] = off[k];
    __syncthreads();
    const int tile = int(blockIdx.x % unsigned(ntile));
    const int64_t rest = blockIdx.x / unsigned(ntile);
    const int q1 = int(rest % g.c1), q0 = int(rest / g.c1);
    const int first2 = 3 * kTile * tile;           // first fine point, dim 2
    for (int t = threadIdx.x; t < kTileRows; t += kThreads) {
        // fine point (3 q0 + a, 3 q1 + b, first2 + e) of the tile's boxes,
        // with consecutive t on consecutive e
        const int ab = t / (3 * kTile), e = t - ab * (3 * kTile);
        const int p0 = 3 * q0 + ab / 3, p1 = 3 * q1 + ab % 3,
                  p2 = first2 + e;
        U z = zero_of(U{});
        if (p0 < g.f0 && p1 < g.f1 && p2 < g.f2) {
            const int64_t j = (int64_t(p0) * g.f1 + p1) * g.f2 + p2;
            U acc = zero_of(U{});
#pragma unroll 4
            for (int k = 0; k < nnd; ++k) {
                // row rr of diagonal k lands in column j
                const int64_t rr = j - offs[k];
                if (rr < 0 || rr >= g.n) continue;
                acc = add_(acc, mul_(val[int64_t(k) * g.n + rr],
                                     mul_(dinv[rr], r[rr])));
            }
            z = sub_(r[j], mul_(omega, acc));
        }
        zs[t] = z;
    }
    __syncthreads();
    const int q2 = kTile * tile + int(threadIdx.x);
    if (threadIdx.x >= kTile || q2 >= g.c2) return;
    U s = zs[3 * threadIdx.x];                      // a = b = e = 0
    for (int a = 0; a < 3 && 3 * q0 + a < g.f0; ++a)
        for (int b = 0; b < 3 && 3 * q1 + b < g.f1; ++b)
            for (int e = 0; e < 3 && 3 * q2 + e < g.f2; ++e)
                if (a | b | e)
                    s = add_(s, zs[(3 * a + b) * (3 * kTile) +
                                   3 * threadIdx.x + e]);
    const int64_t c = (int64_t(q0) * g.c1 + q1) * g.c2 + q2;
    rc[c] = mul_(s, wc[c]);
}

template <typename T, typename U>
void prolong(const void* val, const void* off, const void* dinv,
             const void* wc, const void* ec, const void* x, void* out,
             const Lattice& g, int nnd, double omega, cudaStream_t st) {
    const int64_t blocks = (g.n + kThreads - 1) / kThreads;
    if (blocks == 0) return;
    prolong_kernel<T, U><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(val), static_cast<const int64_t*>(off),
        static_cast<const T*>(dinv), static_cast<const T*>(wc),
        static_cast<const U*>(ec), static_cast<const U*>(x),
        static_cast<U*>(out), g, nnd, T(omega));
}

template <typename T, typename U>
void restrict_(const void* val, const void* off, const void* dinv,
               const void* wc, const void* r, void* rc, const Lattice& g,
               int nnd, double omega, cudaStream_t st) {
    const int ntile = (g.c2 + kTile - 1) / kTile;
    const int64_t blocks = int64_t(g.c0) * g.c1 * ntile;
    if (blocks == 0) return;
    restrict_kernel<T, U><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(val), static_cast<const int64_t*>(off),
        static_cast<const T*>(dinv), static_cast<const T*>(wc),
        static_cast<const U*>(r), static_cast<U*>(rc), g, ntile, nnd,
        T(omega));
}

bool valid(const Lattice& g, int64_t nnd) {
    return nnd >= 0 && nnd <= kMaxNnd && g.f0 > 0 && g.f1 > 0 && g.f2 > 0 &&
           g.n == int64_t(g.f0) * g.f1 * g.f2 && g.n < (int64_t(1) << 31) &&
           g.c0 == (g.f0 + 2) / 3 && g.c1 == (g.f1 + 2) / 3 &&
           g.c2 == (g.f2 + 2) / 3;
}

}  // namespace

// vtype: 0 float, 1 double (val, dinv, wc); utype: the vectors' type,
// vtype or its complex type (2 complex64, 3 complex128).  val (nnd*n,),
// off (nnd,) int64, dinv (n,), wc (c0*c1*c2,), ec (c0*c1*c2,), x and
// out (n,).
LIS_EXPORT int lis_lattice_prolong(int vtype, int utype, const void* val,
                                   const void* off, const void* dinv,
                                   const void* wc, const void* ec,
                                   const void* x, void* out, int64_t n,
                                   int64_t nnd, int64_t f0, int64_t f1,
                                   int64_t f2, int64_t c1, int64_t c2,
                                   double omega, void* stream) {
    const Lattice g{n, int(f0), int(f1), int(f2), int((f0 + 2) / 3),
                    int(c1), int(c2)};
    if (!valid(g, nnd)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (vtype * 4 + utype) {
    case 0 * 4 + 0: prolong<float, float>(val, off, dinv, wc, ec, x, out, g, int(nnd), omega, st); break;
    case 1 * 4 + 1: prolong<double, double>(val, off, dinv, wc, ec, x, out, g, int(nnd), omega, st); break;
    case 0 * 4 + 2: prolong<float, Cx<float>>(val, off, dinv, wc, ec, x, out, g, int(nnd), omega, st); break;
    case 1 * 4 + 3: prolong<double, Cx<double>>(val, off, dinv, wc, ec, x, out, g, int(nnd), omega, st); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// As lis_lattice_prolong; r (n,), rc (c0*c1*c2,).
LIS_EXPORT int lis_lattice_restrict(int vtype, int utype, const void* val,
                                    const void* off, const void* dinv,
                                    const void* wc, const void* r, void* rc,
                                    int64_t n, int64_t nnd, int64_t f0,
                                    int64_t f1, int64_t f2, int64_t c0,
                                    int64_t c1, int64_t c2, double omega,
                                    void* stream) {
    const Lattice g{n, int(f0), int(f1), int(f2), int(c0), int(c1), int(c2)};
    if (!valid(g, nnd)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (vtype * 4 + utype) {
    case 0 * 4 + 0: restrict_<float, float>(val, off, dinv, wc, r, rc, g, int(nnd), omega, st); break;
    case 1 * 4 + 1: restrict_<double, double>(val, off, dinv, wc, r, rc, g, int(nnd), omega, st); break;
    case 0 * 4 + 2: restrict_<float, Cx<float>>(val, off, dinv, wc, r, rc, g, int(nnd), omega, st); break;
    case 1 * 4 + 3: restrict_<double, Cx<double>>(val, off, dinv, wc, r, rc, g, int(nnd), omega, st); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
