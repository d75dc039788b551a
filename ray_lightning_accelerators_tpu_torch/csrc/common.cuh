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

// Stage elements [0, n_valid) of a row-major tile of n_total elements into
// shared memory as f32, the rest of the tile as zeros, with NT threads.
// `vec` (both pointers 16-byte aligned) takes 16-byte loads; n_total and
// n_valid must then be multiples of 16 / sizeof(T), as whole rows of a
// head dim of 64 or 128 are.
template <typename T, int NT>
__device__ __forceinline__ void stage_f32(const T* __restrict__ src,
                                          float* __restrict__ dst,
                                          int n_total, int n_valid, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
    for (int e = tid; e < n_total / V; e += NT) {
      float f[V];
      if (e * V < n_valid) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + e * V);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int t = 0; t < V; ++t) f[t] = to_f32(x[t]);
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) f[t] = 0.f;
      }
      float4* d4 = reinterpret_cast<float4*>(dst + e * V);
#pragma unroll
      for (int t = 0; t < V / 4; ++t)
        d4[t] = make_float4(f[4 * t], f[4 * t + 1], f[4 * t + 2],
                            f[4 * t + 3]);
    }
  } else {
    for (int e = tid; e < n_total; e += NT)
      dst[e] = e < n_valid ? to_f32(src[e]) : 0.f;
  }
}

// Each library is one translation unit, so this definition appears once
// per shared object.
extern "C" const char* rla_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
