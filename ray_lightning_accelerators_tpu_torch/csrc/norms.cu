// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rms_kernel` (the JAX package's
// ops/norms.py:50, launched by `_norm_call` :79): per row,
// y = x * rsqrt(mean(x^2) + eps) * scale with f32 math, stored in x's dtype.
//
// What bounds it on an H100: every element is read once and written once
// for ~4 flops, so at large row counts it is bound by device memory
// (3.35 TB/s); at the serve engine's decode sizes (16 rows of 768 bf16,
// ~50 KB of traffic) the fixed cost of a launch dominates.
//
// Design: one warp per row, four rows per 128-thread block, no shared
// memory and no block barrier.  Lanes read 16-byte vectors (8 bf16) when
// the row width and pointers allow it, sum squares in f32, and reduce with
// xor shuffles so that every lane holds the row's sum.  The second pass
// re-reads the row (an L1 hit at these widths), scales, and stores 16-byte
// vectors.

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
