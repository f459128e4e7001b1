// Kernel K · trisolve_levels — a level-scheduled sparse triangular solve,
// every level in one launch, each row waiting only for its own columns.
//
// Replaces the lax.scan over levels of lis_tpu/ops/trisolve.py::trisolve
// (:92-107), which XLA runs as one loop on the device; in PyTorch each
// level would be three or more launches (gather, row sum, scatter), and a
// 27-point stencil in natural order has about 7N levels (666 at 96^3).
// The plan is the sliced-ELL copy that lis_tpu_torch/ops/trisolve.py::
// make_plan builds beside lis_tpu's padded arrays: the rows of each level
// in units of 32 (a unit never spans two levels), level-major, with
//
//   srows[32u + t]            row of lane t of unit u (n: padding)
//   sbase[u] .. sbase[u+1]    unit u's entries; entry j of lane t at
//                             sbase[u] + 32 j + t (column n, value 0 past
//                             the row's end)
//   sdinv[32u + t]            the row's multiplier
//
// and for each row i:  x[i] = (b[i]*rs[i] - sum_j v_j * x[c_j]) * dinv[i]
// (rs absent meaning 1), b[i]*rs[i] one rounded product.
//
// Design.  No grid-wide barrier: every row has its own ready flags, zeroed
// per launch by the entry point.  Warps claim units from a global counter
// in the plan's level-major order.  A lane loads its row's columns and
// values (they do not depend on x), polls its columns until all are
// ready, sums, and publishes its row.  A row is published in a mailbox of
// 64-bit words, each holding a 32-bit piece of x[i] beside a 32-bit ready
// flag (two words for a double), written and read with single-copy-atomic
// relaxed 64-bit accesses at device scope: a word seen with its flag set
// holds its piece, so one poll both finds a column ready and brings its
// value, and the writer needs no fence between a value and its flag (a
// flag array apart from x costs each link a second round trip, the
// gather of x after an acquire, and a release fence).  Every flag of a
// chunk of columns is polled in one round trip; those not yet set are
// polled again together.  The mailboxes are in row order, which spreads
// the polled words over all of L2 (in the plan's slot order the polls of
// the wavefront would crowd a few L2 slices).  x[i] is
// also stored, plainly, for the caller.  The critical path is the
// dependency chain itself, one poll per level, not a barrier across the
// whole grid.  Deadlock-free with any grid size: every column a claimed
// row waits on lies in an earlier level, so in a unit claimed earlier by
// a warp that is already running.  The wrapper sets the warp count from
// the plan (ops/trisolve.py::_warps).  Readiness lives only in the flags,
// so NaN or Inf in b flows through as arithmetic.  A spin that lasts
// longer than kSpinLimitNs (%globaltimer) traps: a broken plan fails at
// the wrapper's next synchronize instead of hanging.  A row's entries
// load 16 at a time (kChunk), so a row of up to 16 entries (13 in a
// 27-point triangle) costs one round of loads; longer rows (ILU fill)
// take further chunks.  Every product and sum is rounded on its own
// (__dmul_rn / __dadd_rn), in the row's CSR order.
//
// Bound on the H100: the triangle's bytes once (row ids, columns, values,
// b, dinv, x), but in practice the latency of nlev dependent links, each a
// poll of the row's columns, the row's arithmetic and a store.
//
// Types: vals/dinv/rs and b/x of one type (float, double, complex64,
// complex128), or a real plan with complex vectors of the same width.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;                     // two warps a block
constexpr int kUnit = 32;                        // rows of a unit: one warp
constexpr int kChunk = 16;                       // a row's entries loaded at once
constexpr unsigned long long kSpinLimitNs = 5000000000ull;   // 5 s

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

// the mailboxes: 64-bit words of (ready flag << 32 | a 32-bit piece of a
// row's x), kPieces<U> words a row, read and written with relaxed 64-bit
// accesses at device scope (each single-copy atomic)
using Word = unsigned long long;
constexpr Word kReady = 1ull << 32;
template <typename U> constexpr int kPieces = int(sizeof(U) / 4);

__device__ __forceinline__ Word ld_word(const Word* p) {
    Word w;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
                 : "=l"(w) : "l"(p) : "memory");
    return w;
}
__device__ __forceinline__ void st_word(Word* p, Word w) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
                 :: "l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// x[c] from its mailbox if every piece is ready: true and out set
template <typename U>
__device__ __forceinline__ bool take(const Word* mb, int32_t c, U& out) {
    Word w[kPieces<U>];
#pragma unroll
    for (int p = 0; p < kPieces<U>; ++p)
        w[p] = ld_word(mb + int64_t(c) * kPieces<U> + p);
    uint32_t piece[kPieces<U>];
    bool ready = true;
#pragma unroll
    for (int p = 0; p < kPieces<U>; ++p) {
        ready = ready && (w[p] & kReady);
        piece[p] = uint32_t(w[p]);
    }
    memcpy(&out, piece, sizeof(U));
    return ready;
}

template <typename U>
__device__ __forceinline__ void publish(Word* mb, int32_t row, U v) {
    uint32_t piece[kPieces<U>];
    memcpy(piece, &v, sizeof(U));
#pragma unroll
    for (int p = 0; p < kPieces<U>; ++p)
        st_word(mb + int64_t(row) * kPieces<U> + p, kReady | piece[p]);
}

// x[row] = (bi - sum_j v[j] * x[c[j]]) * di over a row's entries at
// c[32 j], v[32 j] for j < width (padded with column n past the row's end),
// each x[c[j]] taken from its mailbox once ready.  A lane publishes its
// row inside the loop that polls its last chunk, so that it does not wait
// for the other lanes of its warp, whose rows it does not depend on.
template <typename V, typename U>
__device__ __forceinline__ void solve_row(
    int32_t row, U bi, V di, const int32_t* __restrict__ c,
    const V* __restrict__ v, int64_t width, U* x, Word* mb, int64_t n) {
    U acc = zero_of(U{});
    for (int64_t j0 = 0;; j0 += kChunk) {
        int32_t cj[kChunk];
        V vj[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
            const bool in = j0 + u < width;
            cj[u] = in ? __ldg(c + (j0 + u) * kUnit) : int32_t(n);
            vj[u] = in ? v[(j0 + u) * kUnit] : zero_of(V{});
        }
        // the row's padding begins in this chunk, or the unit's ends
        const bool last = cj[kChunk - 1] >= n || j0 + kChunk >= width;
        // every column of the chunk polled at once; then, while one is
        // not ready, those not yet taken polled again together
        U xj[kChunk];
        bool have[kChunk];
        bool all = true;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
            xj[u] = zero_of(U{});
            have[u] = cj[u] >= n || take(mb, cj[u], xj[u]);
            all = all && have[u];
        }
        unsigned long long t0 = 0;
        for (;;) {
            if (all) {
#pragma unroll
                for (int u = 0; u < kChunk; ++u)
                    if (cj[u] < n) acc = add_(acc, mul_(xj[u], vj[u]));
                if (last) {
                    const U xi = mul_(sub_(bi, acc), di);
                    x[row] = xi;
                    publish(mb, row, xi);
                }
                break;
            }
            if (t0 == 0)
                t0 = global_ns();
            else if (global_ns() - t0 > kSpinLimitNs)
                __trap();
            all = true;
#pragma unroll
            for (int u = 0; u < kChunk; ++u)
                if (!have[u]) {
                    have[u] = take(mb, cj[u], xj[u]);
                    all = all && have[u];
                }
        }
        if (last) return;
    }
}

template <typename V, typename U>
__global__ void __launch_bounds__(kThreads)
trisolve_kernel(const int32_t* __restrict__ srows,
                const int32_t* __restrict__ sbase,
                const int32_t* __restrict__ scols,
                const V* __restrict__ svals, const V* __restrict__ sdinv,
                const U* __restrict__ b, const V* __restrict__ rs, U* x,
                int64_t n, int64_t nunits, Word* mb,
                unsigned int* next_unit) {
    const int lane = threadIdx.x % kUnit;
    for (;;) {
        unsigned int u = 0;
        if (lane == 0) u = atomicAdd(next_unit, 1u);
        u = __shfl_sync(0xffffffffu, u, 0);
        if (u >= nunits) return;
        const int64_t slot = int64_t(u) * kUnit + lane;
        const int32_t row = __ldg(srows + slot);
        if (row < n) {
            const int64_t base = __ldg(sbase + u);
            const int64_t width = (__ldg(sbase + u + 1) - base) / kUnit;
            U bi = b[row];
            if (rs != nullptr) bi = mul_(bi, rs[row]);
            solve_row(row, bi, sdinv[slot], scols + base + lane,
                      svals + base + lane, width, x, mb, n);
        }
    }
}

template <typename V, typename U>
int launch(const void* srows, const void* sbase, const void* scols,
           const void* svals, const void* sdinv, const void* b,
           const void* rs, void* x, int64_t n, int64_t nunits,
           int64_t warps, void* mailbox, cudaStream_t st) {
    if (n == 0 || nunits == 0) return (int)cudaSuccess;
    auto kern = trisolve_kernel<V, U>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    // the caller's warp count, at most one per unit and what is resident
    // at once (a block that starts late only claims what is left)
    constexpr int64_t kWarps = kThreads / kUnit;
    if (warps > nunits) warps = nunits;
    if (warps < 1) warps = 1;
    int64_t blocks = (warps + kWarps - 1) / kWarps;
    const int64_t resident = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
    if (blocks > resident) blocks = resident;
    // the mailboxes and, after them, the claim counter
    const int64_t words = n * kPieces<U>;
    e = cudaMemsetAsync(mailbox, 0, sizeof(Word) * (words + 1), st);
    if (e != cudaSuccess) return (int)e;
    Word* mb = static_cast<Word*>(mailbox);
    trisolve_kernel<V, U><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(srows), static_cast<const int32_t*>(sbase),
        static_cast<const int32_t*>(scols), static_cast<const V*>(svals),
        static_cast<const V*>(sdinv), static_cast<const U*>(b),
        static_cast<const V*>(rs), static_cast<U*>(x), n, nunits, mb,
        reinterpret_cast<unsigned int*>(mb + words));
    return (int)cudaGetLastError();
}

}  // namespace

// vtype (svals, sdinv, rs) / utype (b, x): 0 float, 1 double, 2 complex64,
// 3 complex128.  srows and sdinv (nunits*32,), sbase (nunits+1,) int32,
// scols and svals (sbase[nunits],), b and x (n,), rs (n,) or null;
// mailbox: n * (sizeof(x's type) / 4) + 1 64-bit words of device memory
// that the launch zeroes and uses as the rows' mailboxes and, in its last
// word, the units' claim counter; warps: how many warps to run (capped at
// nunits and at what is resident).
LIS_EXPORT int lis_trisolve_levels(int vtype, int utype, const void* srows,
                                   const void* sbase, const void* scols,
                                   const void* svals, const void* sdinv,
                                   const void* b, const void* rs, void* x,
                                   int64_t n, int64_t nunits, int64_t warps,
                                   void* mailbox, void* stream) {
    if (n < 0 || nunits < 0 || n > INT32_MAX || nunits > UINT32_MAX / 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LIS_K(V, U) launch<V, U>(srows, sbase, scols, svals, sdinv, b, rs, x, n, nunits, warps, mailbox, st)
    switch (vtype * 4 + utype) {
    case 0 * 4 + 0: return LIS_K(float, float);
    case 1 * 4 + 1: return LIS_K(double, double);
    case 2 * 4 + 2: return LIS_K(Cx<float>, Cx<float>);
    case 3 * 4 + 3: return LIS_K(Cx<double>, Cx<double>);
    case 0 * 4 + 2: return LIS_K(float, Cx<float>);
    case 1 * 4 + 3: return LIS_K(double, Cx<double>);
    default: return (int)cudaErrorInvalidValue;
    }
#undef LIS_K
}
