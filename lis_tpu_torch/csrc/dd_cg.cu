// Kernels S · the fused double-double CG step of cg_quad: the vector work
// of one iteration around the matvec in three passes, every loop scalar
// read from and written to device memory.
//
// They replace no Pallas kernel: lis_tpu's cg_quad step
// (lis_tpu/solvers/quad.py:65) is jnp code that XLA fuses into its
// while-loop.  The port's general step (solvers/quad.py, cg_quad_plain)
// runs it as kernels O and P and torch operations, some 38 launches an
// iteration.  This step keeps that step's operations and their order, with
// the same DD arithmetic (dd.cuh), so x, the history, the count and the
// status are its own bit for bit:
//
//   S1 ddcg_dir  p <- z + beta p in place, z = (dinv r.hi, dinv r.lo)
//                (Jacobi folded in) or r (no preconditioner); beta =
//                rho / rho_old as S3 left it
//   (q = A p: kernel M, or the operator's own DD matvec)
//   S2 ddcg_pq   p.q by O's tree; in the last thread pq == 0 (broke),
//                alpha = rho / (broke ? 1 : pq)
//   S3 ddcg_xr   r' = r + (-alpha) q and, unless broke, x <- x + alpha p,
//                r <- r' in place; the terms of ||r'|| (nrm2, or nrm1 under
//                -conv_cond nrm1_b) and of the next rho = r'.(dinv r') go
//                into two of O's trees, each term folded by the thread
//                that updated its element (the tree's position t walks the
//                elements t + k G B); the last thread finishes the norm,
//                writes rh[it], freezes nrm and rho_old on a breakdown,
//                sets the flag, it + 1, the next beta and live
//
// S2 and S3 are cooperative launches of kernel O's grid, with at most the
// blocks the card holds at once (lis_ddcg_resident; S3 fits one block an
// SM): 128 on the 132 SMs of an H100 SXM, 64 on an H100 PCIe's 114.  The
// sums do not depend on the grid: any power-of-two grid walks the same
// halving tree.
//
// Every kernel returns at once when live == 0, so a step launched after
// the loop has ended changes nothing.  The breakdown is frozen on the
// card: S3 skips the stores of x and r, which leaves what today's
// torch.where left.
//
// Bound on the H100: bytes.  A step streams 24 limb passes outside the
// matvec (S1 7: r, dinv, p read, p written; S2 4; S3 13: x, r, p, q, dinv
// read, x, r written), 1.36 GB at 192^3 in f64 limbs, 0.406 ms at
// 3.35 TB/s.  S2 is O's dot with another finish.  S3 does about 140
// rounded FP64 operations an element, under a third of the time its bytes
// take, and walks O's chunks with the next chunk's loads in flight.
//
// Scalar blocks (layout shared with lis_tpu_torch/core/ddcg.py):
//   dsc (T, (hi, lo) pairs): 0 rho, 2 rho_old, 4 alpha, 6 beta, 8 pq
//   fsc (double):            0 nrm, 1 tol, 2 bnrm_inv
//   ic (int64):              0 it, 1 flag, 2 live, 3 maxiter, 4 the
//                            "running" flag value, 5 the "breakdown" flag
//                            value, 6 broke
#include "dd.cuh"

namespace {

enum { D_RHO = 0, D_RHO_OLD = 2, D_ALPHA = 4, D_BETA = 6, D_PQ = 8 };
enum { F_NRM = 0, F_TOL = 1, F_BNRM_INV = 2 };
enum { I_IT = 0, I_FLAG = 1, I_LIVE = 2, I_MAXITER = 3, I_RUNNING = 4,
       I_BREAKDOWN = 5, I_BROKE = 6 };

constexpr int kDirThreads = 256;

template <typename T>
__device__ __forceinline__ DD<T> pair(const T* dsc, int k) {
    return {dsc[k], dsc[k + 1]};
}

template <typename T>
__device__ __forceinline__ void put_pair(T* dsc, int k, DD<T> v) {
    dsc[k] = v.hi;
    dsc[k + 1] = v.lo;
}

// ---- S1: the direction -----------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kDirThreads)
ddcg_dir(T* __restrict__ ph, T* __restrict__ pl, const T* __restrict__ rh,
         const T* __restrict__ rl, const T* __restrict__ dinv, int64_t n,
         const T* __restrict__ dsc, const int64_t* __restrict__ ic) {
    if (!ic[I_LIVE]) return;
    const int64_t i = blockIdx.x * int64_t(kDirThreads) + threadIdx.x;
    if (i >= n) return;
    DD<T> z{rh[i], rl[i]};
    if (dinv) {
        const T d = dinv[i];
        z = DD<T>{mul_(d, z.hi), mul_(d, z.lo)};
    }
    const DD<T> p = dd_add(z, dd_mul(pair(dsc, D_BETA), DD<T>{ph[i], pl[i]}));
    ph[i] = p.hi;
    pl[i] = p.lo;
}

// ---- S2: p.q and alpha -----------------------------------------------------
template <typename T>
struct PqFin {
    T* dsc;
    int64_t* ic;

    __device__ __forceinline__ void operator()(DD<T> v) const {
        const DD<T> pq = quick_two_sum(v.hi, v.lo);
        const bool broke = pq.hi == T(0) && pq.lo == T(0);
        put_pair(dsc, D_PQ, pq);
        const DD<T> den = broke ? DD<T>{T(1), T(0)} : DD<T>(pq);
        put_pair(dsc, D_ALPHA, dd_div(pair(dsc, D_RHO), den));
        ic[I_BROKE] = broke;
    }
};

template <typename T>
__global__ void __launch_bounds__(kFinal)
ddcg_pq_block(const T* __restrict__ ph, const T* __restrict__ pl,
              const T* __restrict__ qh, const T* __restrict__ ql, int64_t n,
              int64_t J, int bits, T* dsc, int64_t* ic) {
    if (!ic[I_LIVE]) return;
    const Terms<T> f{R_DOT, n, int64_t(blockDim.x), int64_t(threadIdx.x),
                     ph, pl, qh, ql};
    block_finish<kFinal>(walk<kChunk>(f, J, bits), PqFin<T>{dsc, ic});
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads, 2)
ddcg_pq_grid(const T* __restrict__ ph, const T* __restrict__ pl,
             const T* __restrict__ qh, const T* __restrict__ ql, Grid p,
             T* part, T* dsc, int64_t* ic) {
    if (!ic[I_LIVE]) return;
    const Terms<T> f{R_DOT, p.n, int64_t(p.G) * kRedThreads,
                     int64_t(blockIdx.x) * kRedThreads + threadIdx.x,
                     ph, pl, qh, ql};
    grid_tree<kChunk>(f, p, part, PqFin<T>{dsc, ic});
}

// ---- S3: the update, the norm and the next rho ----------------------------
template <typename T>
struct XrArgs {
    T *xh, *xl, *rh, *rl;
    const T *ph, *pl, *qh, *ql, *dinv;
    int64_t n;
    T* dsc;
    double* fsc;
    int64_t* ic;
    double* hist;
    int nrm1;
};

// element j*stride + t: load() reads its limbs, term() updates x and r
// and returns the element's two terms (zeros past n, like the plain
// version's padding)
template <typename T>
struct XrStep {
    struct Raw {
        int64_t i;
        T xh, xl, rh, rl, ph, pl, qh, ql, d;
    };
    XrArgs<T> a;
    int64_t stride, t;
    DD<T> alpha, nalpha;
    bool broke;

    __device__ __forceinline__ Raw load(int64_t j) const {
        Raw w{j * stride + t, T(0), T(0), T(0), T(0), T(0), T(0), T(0),
              T(0), T(0)};
        if (w.i < a.n) {
            w.xh = a.xh[w.i];
            w.xl = a.xl[w.i];
            w.rh = a.rh[w.i];
            w.rl = a.rl[w.i];
            w.ph = a.ph[w.i];
            w.pl = a.pl[w.i];
            w.qh = a.qh[w.i];
            w.ql = a.ql[w.i];
            if (a.dinv) w.d = a.dinv[w.i];
        }
        return w;
    }

    __device__ __forceinline__ DD2<T> term(const Raw& w) const {
        if (w.i >= a.n) return {{T(0), T(0)}, {T(0), T(0)}};
        const DD<T> r = dd_add(DD<T>{w.rh, w.rl},
                               dd_mul(nalpha, DD<T>{w.qh, w.ql}));
        if (!broke) {
            const DD<T> x = dd_add(DD<T>{w.xh, w.xl},
                                   dd_mul(alpha, DD<T>{w.ph, w.pl}));
            a.xh[w.i] = x.hi;
            a.xl[w.i] = x.lo;
            a.rh[w.i] = r.hi;
            a.rl[w.i] = r.lo;
        }
        DD<T> tn;
        if (a.nrm1) {
            // torch.sign: 0 for 0 and for NaN
            const T sg = r.hi > T(0) ? T(1) : (r.hi < T(0) ? T(-1) : T(0));
            tn = DD<T>{fabs(r.hi), mul_(sg, r.lo)};
        } else {
            tn = dd_mul(r, r);
        }
        const DD<T> z = a.dinv ? DD<T>{mul_(w.d, r.hi), mul_(w.d, r.lo)}
                               : DD<T>(r);
        return {tn, dd_mul(r, z)};
    }
};

template <typename T>
__device__ __forceinline__ XrStep<T> xr_step(const XrArgs<T>& a,
                                             int64_t stride, int64_t t) {
    const DD<T> alpha = pair(a.dsc, D_ALPHA);
    return XrStep<T>{a, stride, t, alpha, dd_neg(alpha), a.ic[I_BROKE] != 0};
}

// the loop's bookkeeping, in the plain step's order: nrm from the new r
// (whether or not it was kept), rh[it] = nrm; on a breakdown the flag, and
// nrm and rho_old stay; the next rho and beta; it + 1; live
template <typename T>
struct XrFin {
    XrArgs<T> a;

    __device__ __forceinline__ void operator()(DD2<T> v) const {
        DD<T> s = quick_two_sum(v.a.hi, v.a.lo);
        if (!a.nrm1) s = dd_sqrt(s);
        double nrm = __dadd_rn(double(s.hi), double(s.lo));
        if (!a.nrm1) nrm = __dmul_rn(nrm, a.fsc[F_BNRM_INV]);
        const DD<T> rho = quick_two_sum(v.b.hi, v.b.lo);
        const int64_t it = a.ic[I_IT];
        a.hist[it] = nrm;
        int64_t flag = a.ic[I_FLAG];
        if (a.ic[I_BROKE]) {
            flag = a.ic[I_BREAKDOWN];
        } else {
            a.fsc[F_NRM] = nrm;
            put_pair(a.dsc, D_RHO_OLD, pair(a.dsc, D_RHO));
        }
        put_pair(a.dsc, D_RHO, rho);
        put_pair(a.dsc, D_BETA, dd_div(rho, pair(a.dsc, D_RHO_OLD)));
        a.ic[I_IT] = it + 1;
        a.ic[I_FLAG] = flag;
        a.ic[I_LIVE] = (it + 1 <= a.ic[I_MAXITER]) &&
                       (a.fsc[F_NRM] > a.fsc[F_TOL]) &&
                       (flag == a.ic[I_RUNNING]);
    }
};

// every thread reads live and broke before the barriers; thread 0 of
// block 0 writes them only after the last one
template <typename T>
__global__ void __launch_bounds__(kFinal)
ddcg_xr_block(XrArgs<T> a, int64_t J, int bits) {
    if (!a.ic[I_LIVE]) return;
    const XrStep<T> f = xr_step(a, blockDim.x, threadIdx.x);
    block_finish<kFinal>(walk<kChunk>(f, J, bits), XrFin<T>{a});
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads, 1)
ddcg_xr_grid(XrArgs<T> a, Grid p, T* part) {
    if (!a.ic[I_LIVE]) return;
    const XrStep<T> f = xr_step(a, int64_t(p.G) * kRedThreads,
                                int64_t(blockIdx.x) * kRedThreads +
                                    threadIdx.x);
    grid_tree<kChunk>(f, p, part, XrFin<T>{a});
}

template <typename T>
void dir_launch(void* ph, void* pl, const void* rh, const void* rl,
                const void* dinv, int64_t n, const void* dsc, const void* ic,
                cudaStream_t st) {
    const int64_t blocks = (n + kDirThreads - 1) / kDirThreads;
    if (blocks == 0) return;
    ddcg_dir<T><<<(unsigned)blocks, kDirThreads, 0, st>>>(
        static_cast<T*>(ph), static_cast<T*>(pl), static_cast<const T*>(rh),
        static_cast<const T*>(rl), static_cast<const T*>(dinv), n,
        static_cast<const T*>(dsc), static_cast<const int64_t*>(ic));
}

template <typename T>
int pq_launch(const void* ph, const void* pl, const void* qh, const void* ql,
              int64_t n, int64_t m, int blocks, int groups, void* part,
              void* dsc, void* ic, cudaStream_t st) {
    const T* h = static_cast<const T*>(ph);
    const T* l = static_cast<const T*>(pl);
    const T* y1 = static_cast<const T*>(qh);
    const T* y2 = static_cast<const T*>(ql);
    T* pt = static_cast<T*>(part);
    T* d = static_cast<T*>(dsc);
    int64_t* c = static_cast<int64_t*>(ic);
    if (blocks == 0) {
        const int B = int(m < kFinal ? m : kFinal);
        const int64_t J = m / B;
        ddcg_pq_block<T><<<1, B, 0, st>>>(h, l, y1, y2, n, J, lis_ilog2(J),
                                          d, c);
        return 0;
    }
    Grid p = tree_grid(n, m, blocks, groups);
    void* args[] = {&h, &l, &y1, &y2, &p, &pt, &d, &c};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)ddcg_pq_grid<T>, dim3(blocks), dim3(kRedThreads), args,
        0, st);
}

template <typename T>
int xr_launch(void* xh, void* xl, void* rh, void* rl, const void* ph,
              const void* pl, const void* qh, const void* ql,
              const void* dinv, int64_t n, int64_t m, int blocks, int groups,
              void* part, void* dsc, void* fsc, void* ic, void* hist,
              int nrm1, cudaStream_t st) {
    XrArgs<T> a{static_cast<T*>(xh), static_cast<T*>(xl),
                static_cast<T*>(rh), static_cast<T*>(rl),
                static_cast<const T*>(ph), static_cast<const T*>(pl),
                static_cast<const T*>(qh), static_cast<const T*>(ql),
                static_cast<const T*>(dinv), n, static_cast<T*>(dsc),
                static_cast<double*>(fsc), static_cast<int64_t*>(ic),
                static_cast<double*>(hist), nrm1};
    if (blocks == 0) {
        const int B = int(m < kFinal ? m : kFinal);
        const int64_t J = m / B;
        ddcg_xr_block<T><<<1, B, 0, st>>>(a, J, lis_ilog2(J));
        return 0;
    }
    Grid p = tree_grid(n, m, blocks, groups);
    T* pt = static_cast<T*>(part);
    void* args[] = {&a, &p, &pt};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)ddcg_xr_grid<T>, dim3(blocks), dim3(kRedThreads), args,
        0, st);
}

// the blocks of S2's and S3's grid kernels the card holds at once: its SMs
// times the fewer of the two kernels' blocks an SM (S3 fits one, S2 two),
// so that a cooperative launch of that many never fails
template <typename T>
int resident_of(int64_t* out) {
    int dev = 0, sms = 0, pq = 0, xr = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &pq, ddcg_pq_grid<T>, kRedThreads, 0);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &xr, ddcg_xr_grid<T>, kRedThreads, 0);
    if (e != cudaSuccess) return (int)e;
    *out = int64_t(sms) * (pq < xr ? pq : xr);
    return (int)cudaSuccess;
}

}  // namespace

// out: one int64 in host memory, the most blocks lis_ddcg_pq and
// lis_ddcg_update may be given on the current device (resident_of).
LIS_EXPORT int lis_ddcg_resident(int dtype, void* out) {
    int64_t* o = static_cast<int64_t*>(out);
    if (dtype == 0) return resident_of<float>(o);
    if (dtype == 1) return resident_of<double>(o);
    return (int)cudaErrorInvalidValue;
}

// p and r limbs (n,), dinv (n,) or null (no preconditioner); dsc and ic
// the step's scalar blocks.
LIS_EXPORT int lis_ddcg_direction(int dtype, void* ph, void* pl,
                                  const void* rh, const void* rl,
                                  const void* dinv, int64_t n,
                                  const void* dsc, const void* ic,
                                  void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    LIS_DISPATCH(dtype, dir_launch, ph, pl, rh, rl, dinv, n, dsc, ic,
                 static_cast<cudaStream_t>(stream));
}

// p and q limbs (n,); the schedule as lis_dd_reduce's (dd.cuh
// tree_plan_ok), with blocks at most lis_ddcg_resident's count; part 2
// (blocks + groups) 256 values with blocks > 0.
LIS_EXPORT int lis_ddcg_pq(int dtype, const void* ph, const void* pl,
                           const void* qh, const void* ql, int64_t n,
                           int64_t m, int64_t blocks, int64_t groups,
                           void* part, void* dsc, void* ic, void* stream) {
    if (!tree_plan_ok(n, m, blocks, groups)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launched(pq_launch<float>(ph, pl, qh, ql, n, m, (int)blocks, (int)groups, part, dsc, ic, st));
    if (dtype == 1) return launched(pq_launch<double>(ph, pl, qh, ql, n, m, (int)blocks, (int)groups, part, dsc, ic, st));
    return (int)cudaErrorInvalidValue;
}

// x, r, p, q limbs (n,), dinv (n,) or null; the schedule as lis_ddcg_pq's,
// part 4 (blocks + groups) 256 values with blocks > 0 (two trees); fsc
// and hist (maxiter + 2,) double; nrm1 1 under -conv_cond nrm1_b.
LIS_EXPORT int lis_ddcg_update(int dtype, void* xh, void* xl, void* rh,
                               void* rl, const void* ph, const void* pl,
                               const void* qh, const void* ql,
                               const void* dinv, int64_t n, int64_t m,
                               int64_t blocks, int64_t groups, void* part,
                               void* dsc, void* fsc, void* ic, void* hist,
                               int nrm1, void* stream) {
    if (!tree_plan_ok(n, m, blocks, groups)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launched(xr_launch<float>(xh, xl, rh, rl, ph, pl, qh, ql, dinv, n, m, (int)blocks, (int)groups, part, dsc, fsc, ic, hist, nrm1, st));
    if (dtype == 1) return launched(xr_launch<double>(xh, xl, rh, rl, ph, pl, qh, ql, dinv, n, m, (int)blocks, (int)groups, part, dsc, fsc, ic, hist, nrm1, st));
    return (int)cudaErrorInvalidValue;
}
