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
// Each template takes f64 limbs (-f quad) or f32 limbs (-f df).  The DD
// arithmetic, rounded operation by operation so that every kernel equals
// its plain PyTorch version bit for bit, and O's tree are in dd.cuh.
//
// Bound on the H100: bytes for all four.  About 30 operations an entry
// of M and 20-40 an element of O and P stay under the FP64 peak's time for
// the bytes they stream.
#include "dd.cuh"

namespace {

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
// The halving tree of dd.cuh over the terms of the mode, finished into
// out[0], out[1]: quick_two_sum, and for nrm2 the square root.  One
// cooperative launch a call and no counters to zero (a launch with
// arrival counters in the call's scratch, zeroed by a memset, and a
// two-launch form measured slower).
template <typename T>
struct OutFin {
    int mode;
    T* out;

    __device__ __forceinline__ void operator()(DD<T> v) const {
        DD<T> r = quick_two_sum(v.hi, v.lo);
        if (mode == R_NRM2) r = dd_sqrt(r);
        out[0] = r.hi;
        out[1] = r.lo;
    }
};

// One block of B <= kFinal threads: the walk over m terms (J = m / B
// each), then block_finish.
template <typename T>
__global__ void __launch_bounds__(kFinal)
reduce_block(int mode, const T* __restrict__ xh, const T* __restrict__ xl,
             const T* __restrict__ yh, const T* __restrict__ yl, int64_t n,
             int64_t J, int bits, T* __restrict__ out) {
    const Terms<T> f{mode, n, int64_t(blockDim.x), int64_t(threadIdx.x),
                     xh, xl, yh, yl};
    block_finish<kFinal>(walk<kChunk>(f, J, bits), OutFin<T>{mode, out});
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads, 2)
reduce_grid(int mode, const T* __restrict__ xh, const T* __restrict__ xl,
            const T* __restrict__ yh, const T* __restrict__ yl, Grid p,
            T* scratch) {
    const Terms<T> f{mode, p.n, int64_t(p.G) * kRedThreads,
                     int64_t(blockIdx.x) * kRedThreads + threadIdx.x,
                     xh, xl, yh, yl};
    grid_tree<kChunk>(f, p, scratch + 2, OutFin<T>{mode, scratch});
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
    Grid p = tree_grid(n, m, blocks, groups);
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
    if (dtype == 0) return launched(ell_launch<float>(idx, val, vlo, xh, xl, xpack, yh, yl, n, nx, (int)w, (int)rows, st));
    if (dtype == 1) return launched(ell_launch<double>(idx, val, vlo, xh, xl, xpack, yh, yl, n, nx, (int)w, (int)rows, st));
    return (int)cudaErrorInvalidValue;
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
    if (mode < 0 || mode > 3 || !tree_plan_ok(n, m, blocks, groups))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launched(reduce_launch<float>(mode, xh, xl, yh, yl, n, m, (int)blocks, (int)groups, scratch, st));
    if (dtype == 1) return launched(reduce_launch<double>(mode, xh, xl, yh, yl, n, m, (int)blocks, (int)groups, scratch, st));
    return (int)cudaErrorInvalidValue;
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
