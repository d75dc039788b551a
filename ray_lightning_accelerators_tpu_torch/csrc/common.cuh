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

// a pointer the kernels may read with 16-byte copies
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The key tiles [x, y) of BK keys that the query rows [q0, q0 + n_q) need
// under the causal / window mask: none wholly above the last row and none
// wholly left of the first row's window, as the TPU kernels skip blocks.
// The window's left edge is kept whole when a row of the span sees no key
// at all (q >= k_len + window - 1): its scores are all -1e30, so its
// softmax is uniform over every key, as the plain version's is.
template <int BK>
__device__ __forceinline__ int2 key_tiles(int q0, int n_q, int k_len,
                                          bool masked, int window) {
  const int q_last = q0 + n_q - 1;
  int end = (k_len + BK - 1) / BK;
  if (masked) end = min(end, q_last / BK + 1);
  int begin = 0;
  if (window > 0 && q0 - window + 1 > 0 && q_last < k_len + window - 1)
    begin = (q0 - window + 1) / BK;
  return make_int2(begin, end);
}

// The query tiles [x, y) of BQ queries that the key rows [k0, k0 + n_k)
// need under the causal / window mask: none wholly before the first key,
// none wholly past the last key's window.  When some row sees no key at
// all (q_len >= k_len + window), its P is 1 over every key, as the plain
// version's is, so every key tile walks on to the last query tile.
template <int BQ>
__device__ __forceinline__ int2 query_tiles(int k0, int n_k, int q_len,
                                            int k_len, bool masked,
                                            int window) {
  const int n_qt = (q_len + BQ - 1) / BQ;
  const int begin = masked ? min(k0 / BQ, n_qt) : 0;
  int end = n_qt;
  if (window > 0 && q_len < k_len + window)
    end = min(n_qt, (k0 + n_k - 1 + window - 1) / BQ + 1);
  return make_int2(begin, end);
}

// Each library is one translation unit, so this definition appears once
// per shared object.
extern "C" const char* rla_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
