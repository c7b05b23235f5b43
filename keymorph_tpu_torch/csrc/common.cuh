// Shared definitions for the port's CUDA kernels.
//
// Every entry point is a plain C function: it takes raw device pointers, the
// sizes, and the caller's cudaStream_t (PyTorch's current stream), launches
// its kernel, allocates nothing and does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KM_EXPORT extern "C" __attribute__((visibility("default")))

namespace km {

inline int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

}  // namespace km
