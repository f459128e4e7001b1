// Kernel #1 · lane_shuffle — the row-local lane gather.
//
//     out[r, l] = x[r / rep, idx[r, l]]    x (R/rep, 128), idx (R, 128) uint8
//
// Replaces lis_tpu/ops/shuffle.py::_lane_shuffle32 (pallas_call at :380)
// and its dtype-generic caller _lane_shuffle (:393).  A gather is a pure
// move, so the kernel is templated on the element's size alone: 4 B
// (float), 8 B (double, complex64) and 16 B (complex128) ride as whole
// elements, with no real/imag or 32-bit planes.  rep > 1 folds the
// repeat of CSTMatrix._select (every 128-column chunk of x serves Kp
// consecutive rows) into the kernel, so the repeated rows are never
// written to device memory.
//
// Bound on the H100: bytes.  Per output slot it reads 1 B of idx and
// writes sizeof(T) (17 B at f64 with rep = 1, plus 8 B of x read); with
// rep > 1 x is read once per source row.  Design: one block per kRows
// output rows.  The block loads its source rows and its idx rows into
// shared memory with 16-byte vector loads, gathers out of shared memory,
// and stores coalesced: consecutive threads write consecutive lanes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;           // output rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_shuffle_kernel(const T* __restrict__ x, const uint8_t* __restrict__ idx,
                    T* __restrict__ out, int64_t R, int lrep) {
    __shared__ __align__(16) T xs[kRows][128];
    __shared__ __align__(16) uint8_t is[kRows][128];
    const int64_t r0 = (int64_t)blockIdx.x * kRows;
    const int nrow = (int)(R - r0 < kRows ? R - r0 : kRows);
    const int64_t s0 = r0 >> lrep;                  // first source row
    const int nsrc = (int)(((r0 + nrow - 1) >> lrep) - s0) + 1;
    constexpr int kVec = 128 * (int)sizeof(T) / 16; // 16-B vectors per row
    const uint4* xg = reinterpret_cast<const uint4*>(x + s0 * 128);
    uint4* xv = reinterpret_cast<uint4*>(&xs[0][0]);
    for (int e = threadIdx.x; e < nsrc * kVec; e += kThreads) xv[e] = xg[e];
    const uint4* ig = reinterpret_cast<const uint4*>(idx + r0 * 128);
    uint4* iv = reinterpret_cast<uint4*>(&is[0][0]);
    for (int e = threadIdx.x; e < nrow * 8; e += kThreads) iv[e] = ig[e];
    __syncthreads();
    for (int e = threadIdx.x; e < nrow * 128; e += kThreads) {
        const int j = e >> 7;
        const int l = e & 127;
        const int src = (int)(((r0 + j) >> lrep) - s0);
        out[(r0 + j) * 128 + l] = xs[src][is[j][l]];
    }
}

template <typename T>
void launch(const void* x, const void* idx, void* out, int64_t R, int lrep,
            cudaStream_t st) {
    const int64_t blocks = (R + kRows - 1) / kRows;
    lane_shuffle_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(idx),
        static_cast<T*>(out), R, lrep);
}

}  // namespace

// x (R/rep, 128), idx and out (R, 128); R >= 1, rep a power of two
// dividing R.  dtype codes: 0 float, 1 double, 2 complex64, 3 complex128
// (only the element size matters).
LIS_EXPORT int lis_lane_shuffle(int dtype, const void* x, const void* idx,
                                void* out, int64_t R, int64_t rep,
                                void* stream) {
    const int lrep = lis_ilog2(rep);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: launch<uint32_t>(x, idx, out, R, lrep, st); break;
        case 1:
        case 2: launch<unsigned long long>(x, idx, out, R, lrep, st); break;
        case 3: launch<uint4>(x, idx, out, R, lrep, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
