// Kernel A · cst_front — the CST SpMV front: select x by lane id, times
// the entry value, written in the transposed bucket order.
//
// Replaces lis_tpu/matrix/cst.py::CSTMatrix._fused_front (pallas_call at
// :289).  With CB = n_pad/128 column chunks, RBc row blocks and a bucket
// cap beta (RBc*beta = 128*Kp slots per chunk):
//
//     t[r, c, j] = xp[128 c + lidx[c, r beta + j]] * val[c, r beta + j]
//
// Bound on the H100: bytes.  Per slot it reads 8 B of val (f64) and 1 B
// of lidx and writes 8 B of t; x is 1/Kp of that and is read from
// shared memory.  Design: one block per (chunk c, segment of SEG slots of
// the chunk's row).  The block stages the chunk's 128 x values and its
// lidx segment (16 B per thread load) in shared memory, then streams val
// and t: consecutive threads take consecutive slots, so val reads are
// coalesced and t writes are contiguous along j within each bucket.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 4096;          // slots per block (<= 128*Kp)

template <typename T>
__global__ void __launch_bounds__(kThreads)
cst_front_kernel(const T* __restrict__ xp, const uint8_t* __restrict__ lidx,
                 const T* __restrict__ val, T* __restrict__ out,
                 int64_t CB, int64_t row_len, int lbeta, int seg) {
    __shared__ T xs[128];
    __shared__ __align__(16) uint8_t ls[kSeg];
    const int64_t nseg = row_len / seg;
    const int64_t c = blockIdx.x / nseg;
    const int64_t e0 = (blockIdx.x % nseg) * seg;
    const int64_t base = c * row_len + e0;
    if (threadIdx.x < 128) xs[threadIdx.x] = xp[c * 128 + threadIdx.x];
    const uint4* src = reinterpret_cast<const uint4*>(lidx + base);
    uint4* dst = reinterpret_cast<uint4*>(ls);
    for (int i = threadIdx.x; i < seg / 16; i += kThreads) dst[i] = src[i];
    __syncthreads();
    const int64_t bmask = (int64_t(1) << lbeta) - 1;
    for (int e = threadIdx.x; e < seg; e += kThreads) {
        const int64_t g = e0 + e;                  // slot within the chunk
        const int64_t r = g >> lbeta;
        out[((r * CB + c) << lbeta) | (g & bmask)] = xs[ls[e]] * val[base + e];
    }
}

template <typename T>
void launch(const void* xp, const void* lidx, const void* val, void* out,
            int64_t CB, int64_t RBc, int64_t beta, int64_t row_len,
            cudaStream_t st) {
    const int seg = row_len < kSeg ? (int)row_len : kSeg;
    const int64_t blocks = CB * (row_len / seg);
    cst_front_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(xp), static_cast<const uint8_t*>(lidx),
        static_cast<const T*>(val), static_cast<T*>(out), CB, row_len,
        lis_ilog2(beta), seg);
}

}  // namespace

// xp (CB*128,), lidx/val (CB*row_len,) with row_len = RBc*beta, out
// (RBc*CB*beta,).  beta and row_len are powers of two, row_len >= 16.
LIS_EXPORT int lis_cst_front(int dtype, const void* xp, const void* lidx,
                             const void* val, void* out, int64_t CB,
                             int64_t RBc, int64_t beta, int64_t row_len,
                             void* stream) {
    LIS_DISPATCH(dtype, launch, xp, lidx, val, out, CB, RBc, beta, row_len,
                 static_cast<cudaStream_t>(stream));
}

LIS_EXPORT const char* lis_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
