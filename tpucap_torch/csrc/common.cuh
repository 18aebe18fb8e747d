// Shared helpers of the port's CUDA kernels: dtype codes that match
// tpucap_torch/_build.py, f32 conversions, 2^x on the special-function
// unit, and the error-string export.
//
// Every kernel source includes this header once and is built on its own
// into a shared library with a plain C interface (route (b): nvcc, ctypes).
// Each C entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tpucap {

// Must match tpucap_torch/_build.py:DTYPE_CODES.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// 2^x on the special-function unit (relative error 2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace tpucap

extern "C" const char* tpucap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
