// RMSNorm (K1) and LayerNorm (K7) forward for Hopper (sm_90a).
//
// K1 replaces the TPU kernel `_rms_kernel` (the JAX package's
// ops/norms.py:50, launched by `_norm_call` :79): per row,
// y = x * rsqrt(mean(x^2) + eps) * scale with f32 math, stored in x's dtype.
//
// K7 replaces `_ln_kernel` (ops/norms.py:57, launched by `_norm_call` :79
// from `layer_norm` :125): per row, an f32 mean mu, then the two-pass
// variance mean((x - mu)^2) (not E[x^2] - mu^2, which loses digits when
// |mu| is large against the spread), y = (x - mu) * rsqrt(var + eps),
// then y * scale + bias in f32, stored in x's dtype.
//
// What bounds them on an H100: every element is read once and written
// once for a handful of flops, so at large row counts they are bound by
// device memory (3.35 TB/s); at the serve engine's decode sizes (16 rows
// of 768 bf16, ~50 KB of traffic) the fixed cost of a launch dominates.
//
// Design: one warp per row, four rows per 128-thread block, no shared
// memory and no block barrier.  Lanes read 16-byte vectors (8 bf16) when
// the row width and pointers allow it and reduce with xor shuffles so
// that every lane holds the row's sum.  K1's second pass re-reads the row
// (an L1 hit at these widths).  K7 keeps the row in registers between its
// three passes when the row fits kLnCacheVecs vectors a lane (bf16 and f16
// up to d = 2048, f32 up to 1024); any other width (a d that is not a
// multiple of the vector, or a wider row) takes a scalar path that reads
// the row from memory in each pass.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row

template <typename T, typename S>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ out, int rows, int d, float eps,
                    bool vec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // warp-uniform: no barrier below
  const T* xr = x + static_cast<int64_t>(row) * d;
  T* orow = out + static_cast<int64_t>(row) * d;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector

  float ss = 0.f;
  if (vec) {
    const int nv = d / V;
    for (int i = lane; i < nv; i += 32) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i * V);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (vec) {
    const int nv = d / V;
    for (int i = lane; i < nv; i += 32) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i * V);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < V; ++j)
        res[j] = from_f32<T>(to_f32(e[j]) * r * to_f32(scale[i * V + j]));
      *reinterpret_cast<uint4*>(orow + i * V) = packed;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
  }
}

template <typename T>
void launch_rms(const void* x, const void* scale, void* out, int rows, int d,
                float eps, bool scale_f32, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  if (scale_f32) {
    rms_norm_kernel<T, float><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), rows, d, eps, vec);
  } else {
    rms_norm_kernel<T, T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(out), rows, d, eps, vec);
  }
}

}  // namespace

// x, out: [rows, d] contiguous in `dtype`; scale: [d], f32 when scale_f32
// else `dtype`.  Returns cudaGetLastError() after the launch.
extern "C" int rla_rms_norm(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, int dtype,
                            int scale_f32, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch_rms<float>(x, scale, out, rows, d, eps, true, s);
      break;
    case kBF16:
      launch_rms<__nv_bfloat16>(x, scale, out, rows, d, eps, scale_f32 != 0,
                                s);
      break;
    case kF16:
      launch_rms<__half>(x, scale, out, rows, d, eps, scale_f32 != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------------
// K7: LayerNorm
// ----------------------------------------------------------------------
namespace {

constexpr int kLnCacheVecs = 8;  // 16-byte vectors a lane keeps in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename S>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layer_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                      const S* __restrict__ bias, T* __restrict__ out,
                      int rows, int d, float eps, bool cached) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // warp-uniform: no barrier below
  const T* xr = x + static_cast<int64_t>(row) * d;
  T* orow = out + static_cast<int64_t>(row) * d;
  const float inv_d = 1.f / static_cast<float>(d);

  if (cached) {
    // vector i = lane + 32 * j of the row lives in c[j] for j < kLnCacheVecs
    constexpr int V = 16 / sizeof(T);
    const int nv = d / V;
    float c[kLnCacheVecs][V];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kLnCacheVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < nv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + i * V);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          c[j][t] = to_f32(e[t]);
          s += c[j][t];
        }
      }
    }
    const float mu = warp_sum(s) * inv_d;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kLnCacheVecs; ++j) {
      if (lane + 32 * j < nv) {
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const float dv = c[j][t] - mu;
          ss = fmaf(dv, dv, ss);
        }
      }
    }
    const float r = rsqrtf(warp_sum(ss) * inv_d + eps);
#pragma unroll
    for (int j = 0; j < kLnCacheVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < nv) {
        uint4 packed;
        T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const int col = i * V + t;
          res[t] = from_f32<T>((c[j][t] - mu) * r * to_f32(scale[col]) +
                               to_f32(bias[col]));
        }
        *reinterpret_cast<uint4*>(orow + i * V) = packed;
      }
    }
  } else {
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s += to_f32(xr[i]);
    const float mu = warp_sum(s) * inv_d;
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float dv = to_f32(xr[i]) - mu;
      ss = fmaf(dv, dv, ss);
    }
    const float r = rsqrtf(warp_sum(ss) * inv_d + eps);
    for (int i = lane; i < d; i += 32)
      orow[i] = from_f32<T>((to_f32(xr[i]) - mu) * r * to_f32(scale[i]) +
                            to_f32(bias[i]));
  }
}

template <typename T>
void launch_ln(const void* x, const void* scale, const void* bias, void* out,
               int rows, int d, float eps, bool param_f32,
               cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool cached = d % V == 0 && d / V <= 32 * kLnCacheVecs &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  if (param_f32) {
    layer_norm_kernel<T, float><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(out), rows, d, eps,
        cached);
  } else {
    layer_norm_kernel<T, T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<const T*>(bias), static_cast<T*>(out), rows, d, eps,
        cached);
  }
}

}  // namespace

// x, out: [rows, d] contiguous in `dtype`; scale, bias: [d], both f32 when
// param_f32 else both `dtype`.  Returns cudaGetLastError() after the launch.
extern "C" int rla_layer_norm(const void* x, const void* scale,
                              const void* bias, void* out, int rows, int d,
                              float eps, int dtype, int param_f32,
                              void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch_ln<float>(x, scale, bias, out, rows, d, eps, true, s);
      break;
    case kBF16:
      launch_ln<__nv_bfloat16>(x, scale, bias, out, rows, d, eps,
                               param_f32 != 0, s);
      break;
    case kF16:
      launch_ln<__half>(x, scale, bias, out, rows, d, eps, param_f32 != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
