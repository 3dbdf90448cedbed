// Helpers shared by the port's CUDA kernels: fp32 <-> storage conversion and
// vector loads of V consecutive elements (16 bytes when V * sizeof(T) == 16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msr {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
// round to nearest even, as torch's fp32 -> bf16 cast
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

}  // namespace msr

// Every C entry point returns the launch's cudaGetLastError() as an int.
extern "C" const char* msr_error_string(int code);
