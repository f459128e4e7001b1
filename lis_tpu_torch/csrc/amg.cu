// Kernels J and L · lattice_prolong / lattice_restrict — SA-AMG's
// coarse-grid transfers on a lattice, over the smoothed prolongator that
// the host assembles at set-up.
//
// lis_tpu has no Pallas kernel here: XLA fuses its implicit prolongator
// (lis_tpu/precon/saamg.py: LatticeTent :298-327, ImplicitP :330-352), a
// box broadcast, a DIA product of the level's A and a box sum, chosen
// because it rides the TPU's streaming DIA product.  On the H100 that
// form reads A's 27 diagonals for every fine row (216 B at f64), against
// about 53 B for the rows of P = (I - w D^-1 A) Pt itself, while a gather
// from a coarse vector that sits in L2 is cheap.  So here P (n x nc) and
// P^T (nc x n) are CSR arrays (int32 row pointers and columns, values of
// the level's real type), built on the host (lis_tpu_torch/ops/amg.py,
// LatticeTransfer):
//
//   J:  out[i] = x[i] + sum_t val[t] * ec[col[t]],  t in row i of P
//   L:  rc[c]  = sum_t val[t] * r[col[t]],          t in row c of P^T
//
// Bound on the H100: bytes.  J reads P's entries (12 B each at f64), its
// row pointers, ec and x once and writes out; L reads P^T's entries and
// row pointers and r once and writes rc.  The gathered vectors come from
// L1 and L2.
//
// J: one thread per fine row, consecutive threads on consecutive rows.  A
// lattice row of P holds at most 8 entries (4.5 on average), so a lane
// that walked its own row would spread each load of the warp over some
// 150 entries.  Instead the warp first stages the products of its 32
// rows' entries in shared memory, lane l taking entries l, l + 32, ...
// of the warp's contiguous span (coalesced), then each lane sums its own
// row from shared memory in column order.  The stage holds 8 entries a
// row, the most a lattice row of P has; LatticeTransfer.from_scipy
// refuses a P with longer rows.  No padding: a row's length comes from
// its row pointers, so an Inf or NaN in ec reaches only the rows that
// hold its column.
// L: a row of P^T holds about 120 entries (at most 125, the 5^3 support
// of a smoothed box), so a warp takes a coarse row: lane l sums entries
// l, l + 32, ... (coalesced, r gathered), then the lanes fold in halves
// (l + 16 onto l, then 8, 4, 2, 1).  Warps take coarse rows in
// lexicographic order, so the blocks in flight share the same few fine
// planes of r in L2 (at 192^3 r is 56.6 MB, more than the 50 MB L2).  No
// atomics: the result is the same every run.
//
// Every product and sum is rounded on its own (no fused multiply-add) in
// the order of the plain PyTorch versions (lis_tpu_torch/ops/amg.py), so
// on real and complex data both kernels equal them bit for bit.
//
// Types: float or double values, with vectors of the same type or of the
// complex type of the same width (multiplied part by part).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 32 * 8;            // J: products a warp stages
                                          // (ops/amg.py MAX_ROW = 8)

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
    T re, im;
};

__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ Cx<T> mul_(T b, Cx<T> a) {
    return Cx<T>{mul_(b, a.re), mul_(b, a.im)};
}
template <typename T>
__device__ __forceinline__ Cx<T> add_(Cx<T> a, Cx<T> b) {
    return Cx<T>{add_(a.re, b.re), add_(a.im, b.im)};
}

template <typename T> __device__ __forceinline__ T zero_of(T) { return T(0); }
template <typename T>
__device__ __forceinline__ Cx<T> zero_of(Cx<T>) { return Cx<T>{T(0), T(0)}; }

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int d) {
    return __shfl_down_sync(0xffffffffu, v, d);
}
template <typename T>
__device__ __forceinline__ Cx<T> shfl_down(Cx<T> v, int d) {
    return Cx<T>{__shfl_down_sync(0xffffffffu, v.re, d),
                 __shfl_down_sync(0xffffffffu, v.im, d)};
}

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
prolong_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const T* __restrict__ val, const U* __restrict__ ec,
               const U* __restrict__ x, U* __restrict__ out, int n) {
    __shared__ U stage[kWarps][kStage];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t r0 = int64_t(blockIdx.x) * kThreads + warp * 32;
    if (r0 >= n) return;                       // uniform across the warp
    const int first = int(r0);
    const int row = first + lane;
    const bool live = row < n;
    const int last = min(first + 32, n);
    const int b = ptr[first], e = ptr[last];
    const int rb = live ? ptr[row] : 0, re = live ? ptr[row + 1] : 0;
    U* s = stage[warp];                        // e - b <= kStage
    for (int t = b + lane; t < e; t += 32) s[t - b] = mul_(val[t], ec[col[t]]);
    __syncwarp();
    U acc = zero_of(U{});
    for (int t = rb; t < re; ++t) acc = add_(acc, s[t - b]);
    if (live) out[row] = add_(x[row], acc);
}

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
restrict_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                const T* __restrict__ val, const U* __restrict__ r,
                U* __restrict__ rc, int nc) {
    const int lane = threadIdx.x & 31;
    const int64_t c = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (c >= nc) return;                       // uniform across the warp
    const int b = ptr[c], e = ptr[c + 1];
    U acc = zero_of(U{});
    for (int t = b + lane; t < e; t += 32) acc = add_(acc, mul_(val[t], r[col[t]]));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc = add_(acc, shfl_down(acc, d));
    if (lane == 0) rc[c] = acc;
}

template <typename T, typename U>
void prolong(const void* ptr, const void* col, const void* val,
             const void* ec, const void* x, void* out, int n,
             cudaStream_t st) {
    const int64_t blocks = (int64_t(n) + kThreads - 1) / kThreads;
    if (blocks == 0) return;
    prolong_kernel<T, U><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(col),
        static_cast<const T*>(val), static_cast<const U*>(ec),
        static_cast<const U*>(x), static_cast<U*>(out), n);
}

template <typename T, typename U>
void restrict_(const void* ptr, const void* col, const void* val,
               const void* r, void* rc, int nc, cudaStream_t st) {
    const int64_t blocks = (int64_t(nc) + kWarps - 1) / kWarps;
    if (blocks == 0) return;
    restrict_kernel<T, U><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(col),
        static_cast<const T*>(val), static_cast<const U*>(r),
        static_cast<U*>(rc), nc);
}

bool valid(int64_t rows, int64_t cols, int64_t nnz) {
    const int64_t lim = int64_t(1) << 31;
    return rows >= 0 && cols >= 0 && nnz >= 0 && rows < lim && cols < lim &&
           nnz < lim;
}

}  // namespace

// vtype: 0 float, 1 double (val); utype: the vectors' type, vtype or its
// complex type (2 complex64, 3 complex128).  P as CSR: ptr (n + 1,) and
// col (nnz,) int32, val (nnz,), at most 8 entries a row (kStage / 32);
// ec (nc,), x and out (n,).
LIS_EXPORT int lis_lattice_prolong(int vtype, int utype, const void* ptr,
                                   const void* col, const void* val,
                                   const void* ec, const void* x, void* out,
                                   int64_t n, int64_t nc, int64_t nnz,
                                   void* stream) {
    if (!valid(n, nc, nnz)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = int(n);
    switch (vtype * 4 + utype) {
    case 0 * 4 + 0: prolong<float, float>(ptr, col, val, ec, x, out, rows, st); break;
    case 1 * 4 + 1: prolong<double, double>(ptr, col, val, ec, x, out, rows, st); break;
    case 0 * 4 + 2: prolong<float, Cx<float>>(ptr, col, val, ec, x, out, rows, st); break;
    case 1 * 4 + 3: prolong<double, Cx<double>>(ptr, col, val, ec, x, out, rows, st); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// As lis_lattice_prolong, over P^T: ptr (nc + 1,), col (nnz,), val (nnz,);
// r (n,), rc (nc,).
LIS_EXPORT int lis_lattice_restrict(int vtype, int utype, const void* ptr,
                                    const void* col, const void* val,
                                    const void* r, void* rc, int64_t nc,
                                    int64_t n, int64_t nnz, void* stream) {
    if (!valid(nc, n, nnz)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = int(nc);
    switch (vtype * 4 + utype) {
    case 0 * 4 + 0: restrict_<float, float>(ptr, col, val, r, rc, rows, st); break;
    case 1 * 4 + 1: restrict_<double, double>(ptr, col, val, r, rc, rows, st); break;
    case 0 * 4 + 2: restrict_<float, Cx<float>>(ptr, col, val, r, rc, rows, st); break;
    case 1 * 4 + 3: restrict_<double, Cx<double>>(ptr, col, val, r, rc, rows, st); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
