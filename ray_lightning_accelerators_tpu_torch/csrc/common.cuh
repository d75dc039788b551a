// Shared helpers for the port's hand-written Hopper kernels: dtype codes
// that match ops/_build.py, float conversions by intrinsic, and the error
// string entry every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (ops/_build.py DTYPE_CODES)
enum RlaDtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(bfloat16) and XLA's convert do
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Each library is one translation unit, so this definition appears once
// per shared object.
extern "C" const char* rla_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
