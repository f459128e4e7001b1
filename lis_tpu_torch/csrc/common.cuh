// Shared helpers of the lis_tpu_torch CUDA kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// lis_tpu_torch/ops/_cuda.py): device pointers and the stream arrive as
// void*, sizes as int64_t, and the function returns cudaGetLastError()
// right after its launch.  Values are float or double (dtype code 0 / 1;
// lane_shuffle also takes complex64 / complex128 as codes 2 / 3); index
// tables are uint8 lane ids.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LIS_EXPORT extern "C" __attribute__((visibility("default")))

// floor(log2(v)) for a power of two v > 0
static inline int lis_ilog2(int64_t v) {
    int l = 0;
    while ((int64_t(1) << l) < v) ++l;
    return l;
}

// Dispatch a templated launcher on the dtype code; returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an unknown code).
#define LIS_DISPATCH(dtype, FN, ...)                                      \
    do {                                                                  \
        if ((dtype) == 0) { FN<float>(__VA_ARGS__); }                     \
        else if ((dtype) == 1) { FN<double>(__VA_ARGS__); }               \
        else { return (int)cudaErrorInvalidValue; }                       \
        return (int)cudaGetLastError();                                   \
    } while (0)

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory (device code only).
//
// lis_cp_async4 is the per-thread 4-byte cp.async; copies are grouped by
// lis_cp_async_commit and a thread waits for all but its newest N groups
// with lis_cp_async_wait<N>.  lis_bulk_g2s is Hopper's bulk copy: one
// thread moves a contiguous span (16-byte aligned at both ends, a multiple
// of 16 bytes long) and the hardware reports the bytes to an mbarrier that
// lis_mbar_expect_tx armed; every thread that reads the data first calls
// lis_mbar_wait with the parity of that use of the barrier (0, 1, 0, ...).
// lis_fence_proxy_async orders a thread's own shared-memory accesses
// before later bulk copies into the same bytes.
// ---------------------------------------------------------------------------
#ifdef __CUDACC__
__device__ __forceinline__ uint32_t lis_smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void lis_cp_async4(void* smem_dst,
                                              const void* gmem_src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(lis_smem_addr(smem_dst)), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void lis_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void lis_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void lis_mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(lis_smem_addr(bar)), "r"(count) : "memory");
}

// makes freshly initialised mbarriers visible to the asynchronous proxy
__device__ __forceinline__ void lis_fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void lis_fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void lis_mbar_expect_tx(uint64_t* bar,
                                                   uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(lis_smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void lis_mbar_wait(uint64_t* bar,
                                              uint32_t parity) {
    const uint32_t addr = lis_smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void lis_bulk_g2s(void* smem_dst,
                                             const void* gmem_src,
                                             uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(lis_smem_addr(smem_dst)), "l"(gmem_src), "r"(bytes),
           "r"(lis_smem_addr(bar)) : "memory");
}
#endif  // __CUDACC__
