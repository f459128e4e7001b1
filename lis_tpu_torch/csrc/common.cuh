// Shared helpers of the lis_tpu_torch CUDA kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// lis_tpu_torch/ops/_cuda.py): device pointers and the stream arrive as
// void*, sizes as int64_t, and the function returns cudaGetLastError()
// right after its launch.  Values are float or double (dtype code 0 / 1);
// index tables are uint8 lane ids.
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
