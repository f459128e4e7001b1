// Kernel K · trisolve_levels — a level-scheduled sparse triangular solve,
// every level in one launch.
//
// Replaces the lax.scan over levels of lis_tpu/ops/trisolve.py::trisolve
// (:92-107), which XLA runs as one loop on the device; in PyTorch each
// level would be three or more launches (gather, row sum, scatter), and a
// 27-point stencil in natural order has about 7N levels (442 at 64^3).
// For the plan of lis_tpu/ops/trisolve.py::make_plan (:46), with rows
// (nlev, R) int32, cols (nlev, R, Z) int32 and vals (nlev, R, Z), padded
// with n (rows, cols) and 0 (vals):
//
//   for each level l, for each row i = rows[l, k] < n:
//       x[i] = (b[i] - sum_j vals[l,k,j] * x[cols[l,k,j]]) * dinv[i]
//
// A level depends only on earlier levels.  Design: one persistent grid of
// just enough 256-thread blocks for the widest level (at most what fits on
// the card at once), launched cooperatively so that every block is
// resident, with a grid-wide barrier between levels: one arrival counter in
// global memory, counting up over the launch (zeroed by the entry point),
// on which thread 0 of each block spins.  x is written and read at L2
// (st.cg / ld.cg) so that no block reads a stale line from its own L1.
// One thread per row; padded rows and entries are skipped (they sit at the
// tail of their level and row).  A row's columns and values load 16 at a
// time, then the 16 gathers from x, so that a level costs a few dependent
// loads and not two per entry.  A thread's first row of the next
// level and its first 16 columns and values do not depend on x: they are
// loaded before the barrier, so that their latency hides behind it and a
// level's critical path is the gather from x, the store and the barrier.
//
// Bound on the H100: the plan's bytes once (rows, cols, vals, plus b,
// dinv and x), but in practice the latency of nlev dependent steps, each a
// load of the plan, a gather from x, a store and a barrier: a few
// microseconds per level, whatever the level's width.
//
// Types: vals/dinv and b/x of one type (float, double, complex64,
// complex128), or a real plan with complex vectors of the same width.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;      // a row's entries loaded at once

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

// loads and stores of x at L2, never from a block's own L1
__device__ __forceinline__ float ld_x(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ld_x(const double* p) { return __ldcg(p); }
template <typename T>
__device__ __forceinline__ Cx<T> ld_x(const Cx<T>* p) {
    const T* q = reinterpret_cast<const T*>(p);
    return Cx<T>{__ldcg(q), __ldcg(q + 1)};
}
__device__ __forceinline__ void st_x(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void st_x(double* p, double v) { __stcg(p, v); }
template <typename T>
__device__ __forceinline__ void st_x(Cx<T>* p, Cx<T> v) {
    T* q = reinterpret_cast<T*>(p);
    __stcg(q, v.re);
    __stcg(q + 1, v.im);
}

// every block arrives once per barrier; barrier g (1, 2, ...) is passed
// when the counter reaches g * gridDim.x
__device__ __forceinline__ void grid_sync(unsigned int* arrivals,
                                          unsigned int goal) {
    __syncthreads();
    if (gridDim.x > 1) {
        if (threadIdx.x == 0) {
            __threadfence();
            atomicAdd(arrivals, 1u);
            volatile unsigned int* a = arrivals;
            while (*a < goal) {
            }
            __threadfence();
        }
        __syncthreads();
    }
}

// x[row] = (b[row] - sum_j v[j] * x[c[j]]) * dinv[row], the row's first
// kChunk columns and values given (c0, v0), the rest loaded here
template <typename V, typename U>
__device__ __forceinline__ void solve_row(
    int32_t row, const int32_t (&c0)[kChunk], const V (&v0)[kChunk],
    const int32_t* __restrict__ c, const V* __restrict__ v,
    const V* __restrict__ dinv, const U* __restrict__ b, U* x, int64_t n,
    int64_t max_nnz) {
    const U bi = b[row];
    const V di = dinv[row];
    U acc = zero_of(U{});
    U xj[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
        xj[u] = c0[u] < n ? ld_x(x + c0[u]) : zero_of(U{});
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
        if (c0[u] < n) acc = add_(acc, mul_(xj[u], v0[u]));
    if (c0[kChunk - 1] < n) {
        // rows longer than one chunk: the rest, a chunk at a time
        for (int64_t j0 = kChunk; j0 < max_nnz; j0 += kChunk) {
            int32_t cj[kChunk];
            V vj[kChunk];
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const bool in = j0 + u < max_nnz;
                cj[u] = in ? __ldg(c + j0 + u) : int32_t(n);
                vj[u] = in ? v[j0 + u] : zero_of(V{});
            }
#pragma unroll
            for (int u = 0; u < kChunk; ++u)
                xj[u] = cj[u] < n ? ld_x(x + cj[u]) : zero_of(U{});
#pragma unroll
            for (int u = 0; u < kChunk; ++u)
                if (cj[u] < n) acc = add_(acc, mul_(xj[u], vj[u]));
            if (cj[kChunk - 1] >= n) break;   // the row's padding began
        }
    }
    st_x(x + row, mul_(sub_(bi, acc), di));
}

// a slot's row and first chunk of columns and values: none depends on x
template <typename V>
__device__ __forceinline__ int32_t fetch_slot(
    int64_t slot, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ cols, const V* __restrict__ vals,
    int64_t max_nnz, int64_t n, int32_t (&c0)[kChunk], V (&v0)[kChunk]) {
    const int32_t* c = cols + slot * max_nnz;
    const V* v = vals + slot * max_nnz;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
        const bool in = u < max_nnz;
        c0[u] = in ? __ldg(c + u) : int32_t(n);
        v0[u] = in ? v[u] : zero_of(V{});
    }
    return __ldg(rows + slot);
}

template <typename V, typename U>
__global__ void __launch_bounds__(kThreads)
trisolve_kernel(const int32_t* __restrict__ rows,
                const int32_t* __restrict__ cols, const V* __restrict__ vals,
                const V* __restrict__ dinv, const U* __restrict__ b, U* x,
                int64_t n, int64_t nlev, int64_t max_rows, int64_t max_nnz,
                unsigned int* arrivals) {
    const int64_t stride = int64_t(gridDim.x) * kThreads;
    const int64_t k0 = blockIdx.x * int64_t(kThreads) + threadIdx.x;
    // the thread's first slot of the next level is loaded before the
    // barrier that ends this one, so its loads overlap the barrier
    int32_t prow = int32_t(n);
    int32_t pc[kChunk];
    V pv[kChunk];
    if (k0 < max_rows)
        prow = fetch_slot(k0, rows, cols, vals, max_nnz, n, pc, pv);
    for (int64_t l = 0; l < nlev; ++l) {
        if (prow < n) {
            solve_row(prow, pc, pv, cols + (l * max_rows + k0) * max_nnz,
                      vals + (l * max_rows + k0) * max_nnz, dinv, b, x, n,
                      max_nnz);
            // further slots of a level wider than the grid, loaded here
            for (int64_t k = k0 + stride; k < max_rows; k += stride) {
                int32_t cj[kChunk];
                V vj[kChunk];
                const int64_t slot = l * max_rows + k;
                const int32_t row = fetch_slot(slot, rows, cols, vals,
                                               max_nnz, n, cj, vj);
                if (row >= n) break;        // the level's padding
                solve_row(row, cj, vj, cols + slot * max_nnz,
                          vals + slot * max_nnz, dinv, b, x, n, max_nnz);
            }
        }
        if (l + 1 < nlev) {
            prow = int32_t(n);
            if (k0 < max_rows)
                prow = fetch_slot((l + 1) * max_rows + k0, rows, cols, vals,
                                  max_nnz, n, pc, pv);
            grid_sync(arrivals, (unsigned int)(l + 1) * gridDim.x);
        }
    }
}

template <typename V, typename U>
int launch(const void* rows, const void* cols, const void* vals,
           const void* dinv, const void* b, void* x, int64_t n, int64_t nlev,
           int64_t max_rows, int64_t max_nnz, void* arrivals,
           cudaStream_t st) {
    if (n == 0 || nlev == 0) return (int)cudaSuccess;
    auto kern = trisolve_kernel<V, U>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    const int64_t resident = int64_t(sms) * per_sm;
    if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    int64_t blocks = (max_rows + kThreads - 1) / kThreads;
    if (blocks > resident) blocks = resident;
    if (blocks < 1) blocks = 1;
    e = cudaMemsetAsync(arrivals, 0, sizeof(unsigned int), st);
    if (e != cudaSuccess) return (int)e;
    const int32_t* r = static_cast<const int32_t*>(rows);
    const int32_t* c = static_cast<const int32_t*>(cols);
    const V* v = static_cast<const V*>(vals);
    const V* d = static_cast<const V*>(dinv);
    const U* bb = static_cast<const U*>(b);
    U* xx = static_cast<U*>(x);
    unsigned int* a = static_cast<unsigned int*>(arrivals);
    void* args[] = {&r, &c, &v, &d, &bb, &xx, &n, &nlev, &max_rows, &max_nnz,
                    &a};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)blocks),
                                    dim3(kThreads), args, 0, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// vtype (vals, dinv) / utype (b, x): 0 float, 1 double, 2 complex64,
// 3 complex128.  rows (nlev*max_rows,) int32, cols and vals
// (nlev*max_rows*max_nnz,), dinv, b and x (n,); arrivals: one uint32 of
// device memory that the launch uses as its barrier counter.
LIS_EXPORT int lis_trisolve_levels(int vtype, int utype, const void* rows,
                                   const void* cols, const void* vals,
                                   const void* dinv, const void* b, void* x,
                                   int64_t n, int64_t nlev, int64_t max_rows,
                                   int64_t max_nnz, void* arrivals,
                                   void* stream) {
    if (n < 0 || nlev < 0 || max_rows < 0 || max_nnz < 0 || n > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (vtype * 4 + utype) {
    case 0 * 4 + 0: return launch<float, float>(rows, cols, vals, dinv, b, x, n, nlev, max_rows, max_nnz, arrivals, st);
    case 1 * 4 + 1: return launch<double, double>(rows, cols, vals, dinv, b, x, n, nlev, max_rows, max_nnz, arrivals, st);
    case 2 * 4 + 2: return launch<Cx<float>, Cx<float>>(rows, cols, vals, dinv, b, x, n, nlev, max_rows, max_nnz, arrivals, st);
    case 3 * 4 + 3: return launch<Cx<double>, Cx<double>>(rows, cols, vals, dinv, b, x, n, nlev, max_rows, max_nnz, arrivals, st);
    case 0 * 4 + 2: return launch<float, Cx<float>>(rows, cols, vals, dinv, b, x, n, nlev, max_rows, max_nnz, arrivals, st);
    case 1 * 4 + 3: return launch<double, Cx<double>>(rows, cols, vals, dinv, b, x, n, nlev, max_rows, max_nnz, arrivals, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
