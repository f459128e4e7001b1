// Kernels G · the fused CG step — the vector work of one CG iteration in
// four passes, every loop scalar read from and written to device memory.
//
// lis_tpu has no Pallas kernel here: its whole Krylov loop is one XLA
// while-loop whose vector updates and reductions XLA fuses
// (lis_tpu/solvers/cg.py:33-51).  In PyTorch the same step is about 35
// small launches, which on a DIA operator is the whole iteration.  The
// step keeps the reference's order (psolve, dot, xpay, matvec, dot, axpys,
// norm):
//
//   G1 krylov_dot    part[b] = sum over block b of u_i (v_i w_i)   (w optional)
//   G2 cg_direction  rho = sum part_rho; beta = rho / rho_old;
//                    p <- z + beta p      with z given, or dinv r, or r
//   (q = A p: the operator's own matvec)
//   G1 krylov_dot    part_pq[b] = sum p_i q_i
//   G3 cg_update     pq = sum part_pq; alpha = rho / pq;
//                    x <- x + alpha p; r <- r - alpha q;
//                    part_nrm[b] = sum r_i^2 (or |r_i|), and with a diagonal
//                    preconditioner folded in part_rho[b] = sum r_i (dinv_i r_i)
//                    for the next step; pq == 0 leaves x and r as they were
//   G4 cg_finish     nrm = sqrt(sum part_nrm) bnrm_inv (or the 1-norm);
//                    rh[it] = nrm; it += 1; flag, rho_old and live updated
//
// Bound on the H100: bytes (12 vector streams per step with Jacobi).
// Reductions are deterministic: a block sums its elements in a fixed
// order and writes one partial; the kernel that needs the total sums the
// partials again in a fixed order, in every block alike, so no
// floating-point atomic and no second-stage launch is needed, and a total
// is only ever read by a later launch than the one that wrote its
// partials.  Elementwise updates round as two IEEE operations (no fused
// multiply-add), so they equal the plain torch version bit for bit given
// the same scalars.
//
// Every kernel returns at once when live == 0: a step launched after the
// loop has ended (convergence, breakdown, maxiter) changes nothing, which
// is what lets the host read the loop condition less often than every
// step.
//
// Scalar blocks (layout shared with lis_tpu_torch/core/vector.py):
//   sc (T):      0 rho, 1 rho_old, 2 pq, 3 nrm, 4 tol, 5 bnrm_inv
//   ic (int64):  0 it, 1 flag, 2 live, 3 maxiter, 4 the "running" flag
//                value, 5 the "breakdown" flag value
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum { S_RHO = 0, S_RHO_OLD = 1, S_PQ = 2, S_NRM = 3, S_TOL = 4, S_BNRM_INV = 5 };
enum { I_IT = 0, I_FLAG = 1, I_LIVE = 2, I_MAXITER = 3, I_RUNNING = 4, I_BREAKDOWN = 5 };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Sum of v over the block, in a fixed order; valid in thread 0.  sh holds
// kWarps + 1 values.
template <typename T>
__device__ T block_sum(T v, T* sh) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    __syncthreads();                    // sh may still be read from before
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    T s = T(0);
    if (threadIdx.x == 0)
        for (int w = 0; w < kWarps; ++w) s += sh[w];
    return s;
}

// Sum of nb partials, the same bits in every thread of every block.
template <typename T>
__device__ T total(const T* __restrict__ part, int nb, T* sh) {
    T v = T(0);
    for (int i = threadIdx.x; i < nb; i += kThreads) v += part[i];
    v = block_sum(v, sh);
    if (threadIdx.x == 0) sh[kWarps] = v;
    __syncthreads();
    return sh[kWarps];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ u, const T* __restrict__ v,
           const T* __restrict__ w, int64_t n, T* __restrict__ part,
           const int64_t* __restrict__ ic) {
    if (!ic[I_LIVE]) return;
    __shared__ T sh[kWarps + 1];
    T s = T(0);
    const int64_t stride = int64_t(gridDim.x) * kThreads;
    for (int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x; i < n;
         i += stride)
        s += u[i] * (w ? mul_rn(v[i], w[i]) : v[i]);
    s = block_sum(s, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
direction_kernel(T* __restrict__ p, const T* __restrict__ r,
                 const T* __restrict__ z, const T* __restrict__ dinv,
                 int64_t n, const T* __restrict__ part_rho, int nb,
                 T* __restrict__ sc, const int64_t* __restrict__ ic) {
    if (!ic[I_LIVE]) return;
    __shared__ T sh[kWarps + 1];
    const T rho = total(part_rho, nb, sh);
    const T beta = rho / sc[S_RHO_OLD];
    if (blockIdx.x == 0 && threadIdx.x == 0) sc[S_RHO] = rho;
    const int64_t stride = int64_t(gridDim.x) * kThreads;
    for (int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x; i < n;
         i += stride) {
        const T zi = z ? z[i] : (dinv ? mul_rn(dinv[i], r[i]) : r[i]);
        p[i] = add_rn(zi, mul_rn(beta, p[i]));
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
              const T* __restrict__ q, const T* __restrict__ dinv, int64_t n,
              const T* __restrict__ part_pq, T* __restrict__ part_nrm,
              T* __restrict__ part_rho, int nb, T* __restrict__ sc,
              const int64_t* __restrict__ ic, int nrm1) {
    if (!ic[I_LIVE]) return;
    __shared__ T sh[kWarps + 1];
    const T pq = total(part_pq, nb, sh);
    const bool broke = pq == T(0);
    const T alpha = sc[S_RHO] / (broke ? T(1) : pq);
    if (blockIdx.x == 0 && threadIdx.x == 0) sc[S_PQ] = pq;
    T sn = T(0), sr = T(0);
    const int64_t stride = int64_t(gridDim.x) * kThreads;
    for (int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x; i < n;
         i += stride) {
        const T ri = add_rn(r[i], -mul_rn(alpha, q[i]));
        if (!broke) {
            x[i] = add_rn(x[i], mul_rn(alpha, p[i]));
            r[i] = ri;
        }
        sn += nrm1 ? fabs(ri) : ri * ri;
        if (part_rho) sr += ri * (dinv ? mul_rn(dinv[i], ri) : ri);
    }
    sn = block_sum(sn, sh);
    if (threadIdx.x == 0) part_nrm[blockIdx.x] = sn;
    if (part_rho) {
        sr = block_sum(sr, sh);
        if (threadIdx.x == 0) part_rho[blockIdx.x] = sr;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const T* __restrict__ part_nrm, int nb, T* __restrict__ sc,
              int64_t* __restrict__ ic, T* __restrict__ rh, int nrm1) {
    // every thread reads live before the barriers in total(); thread 0
    // writes it only after them
    if (!ic[I_LIVE]) return;
    __shared__ T sh[kWarps + 1];
    const T s = total(part_nrm, nb, sh);
    if (threadIdx.x != 0) return;
    const bool broke = sc[S_PQ] == T(0);
    const T nrm_new = nrm1 ? s : sqrt(s) * sc[S_BNRM_INV];
    const int64_t it = ic[I_IT];
    rh[it] = nrm_new;
    const T nrm = broke ? sc[S_NRM] : nrm_new;
    const int64_t flag = broke ? ic[I_BREAKDOWN] : ic[I_FLAG];
    sc[S_NRM] = nrm;
    sc[S_RHO_OLD] = sc[S_RHO];
    ic[I_IT] = it + 1;
    ic[I_FLAG] = flag;
    ic[I_LIVE] = (it + 1 <= ic[I_MAXITER]) && (nrm > sc[S_TOL])
                 && (flag == ic[I_RUNNING]);
}

template <typename T>
void dot_launch(const void* u, const void* v, const void* w, int64_t n,
                void* part, int nb, const void* ic, cudaStream_t st) {
    dot_kernel<T><<<nb, kThreads, 0, st>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), n, static_cast<T*>(part),
        static_cast<const int64_t*>(ic));
}

template <typename T>
void direction_launch(void* p, const void* r, const void* z, const void* dinv,
                      int64_t n, const void* part_rho, int nb, void* sc,
                      const void* ic, cudaStream_t st) {
    direction_kernel<T><<<nb, kThreads, 0, st>>>(
        static_cast<T*>(p), static_cast<const T*>(r),
        static_cast<const T*>(z), static_cast<const T*>(dinv), n,
        static_cast<const T*>(part_rho), nb, static_cast<T*>(sc),
        static_cast<const int64_t*>(ic));
}

template <typename T>
void update_launch(void* x, void* r, const void* p, const void* q,
                   const void* dinv, int64_t n, const void* part_pq,
                   void* part_nrm, void* part_rho, int nb, void* sc,
                   const void* ic, int nrm1, cudaStream_t st) {
    update_kernel<T><<<nb, kThreads, 0, st>>>(
        static_cast<T*>(x), static_cast<T*>(r), static_cast<const T*>(p),
        static_cast<const T*>(q), static_cast<const T*>(dinv), n,
        static_cast<const T*>(part_pq), static_cast<T*>(part_nrm),
        static_cast<T*>(part_rho), nb, static_cast<T*>(sc),
        static_cast<const int64_t*>(ic), nrm1);
}

template <typename T>
void finish_launch(const void* part_nrm, int nb, void* sc, void* ic, void* rh,
                   int nrm1, cudaStream_t st) {
    finish_kernel<T><<<1, kThreads, 0, st>>>(
        static_cast<const T*>(part_nrm), nb, static_cast<T*>(sc),
        static_cast<int64_t*>(ic), static_cast<T*>(rh), nrm1);
}

}  // namespace

// nb is the number of blocks = the number of partials written (1..1024).
// u, v, w (n,), w may be null; part (nb,).
LIS_EXPORT int lis_krylov_dot(int dtype, const void* u, const void* v,
                              const void* w, int64_t n, void* part, int nb,
                              const void* ic, void* stream) {
    LIS_DISPATCH(dtype, dot_launch, u, v, w, n, part, nb, ic,
                 static_cast<cudaStream_t>(stream));
}

// z and dinv may be null (z wins; neither: z = r).
LIS_EXPORT int lis_cg_direction(int dtype, void* p, const void* r,
                                const void* z, const void* dinv, int64_t n,
                                const void* part_rho, int nb, void* sc,
                                const void* ic, void* stream) {
    LIS_DISPATCH(dtype, direction_launch, p, r, z, dinv, n, part_rho, nb, sc,
                 ic, static_cast<cudaStream_t>(stream));
}

// part_rho null: no rho partials for the next step; dinv may be null.
LIS_EXPORT int lis_cg_update(int dtype, void* x, void* r, const void* p,
                             const void* q, const void* dinv, int64_t n,
                             const void* part_pq, void* part_nrm,
                             void* part_rho, int nb, void* sc, const void* ic,
                             int nrm1, void* stream) {
    LIS_DISPATCH(dtype, update_launch, x, r, p, q, dinv, n, part_pq, part_nrm,
                 part_rho, nb, sc, ic, nrm1, static_cast<cudaStream_t>(stream));
}

LIS_EXPORT int lis_cg_finish(int dtype, const void* part_nrm, int nb, void* sc,
                             void* ic, void* rh, int nrm1, void* stream) {
    LIS_DISPATCH(dtype, finish_launch, part_nrm, nb, sc, ic, rh, nrm1,
                 static_cast<cudaStream_t>(stream));
}
