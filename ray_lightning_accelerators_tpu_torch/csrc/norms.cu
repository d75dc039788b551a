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
// What bounds them on an H100, by regime:
// - Decode and prefill sizes (16 to a few hundred rows; 16 x 768 bf16 is
//   ~50 KB of traffic): the launch and the latency of device memory.  A
//   warp that reads its row, reduces it, and only then reads the row
//   again or the parameters waits on two or three trips to memory.
//   Design: every global load of a row -- x and the parameters, all as
//   16-byte vectors -- is issued before the first reduction, and the row
//   stays in registers (NV vectors a lane, a compile-time count) through
//   every pass, so a call waits on one trip to memory after its launch.
// - Training sizes (16k rows): every element is read once and written
//   once for a handful of flops, so device memory bounds them (3.35 TB/s).
//   Design: a persistent grid, sized to the card by the occupancy API,
//   of one warp a row; each warp keeps its share of the parameters in
//   registers and walks rows at the grid's stride, loading the next row
//   into a second register buffer before it reduces the current one, so
//   every SM keeps bytes in flight.  x is read once, with an evict-first
//   load; stores keep the default policy (the next kernel reads `out`).
// The cached path needs d a multiple of the 16-byte vector, at most
// kMaxVecs vectors a lane (bf16 and f16 d <= 2048, f32 d <= 1024) and
// 16-byte aligned operands.  Any other call takes the general path:
// scalar loads, the row read from memory in each pass, the same grid.
// Both paths sum each lane's elements in the same order (vector lane +
// 32 j, then its elements) and round alike, so a misaligned view gives
// the bits of an aligned copy.

#include <algorithm>

#include "common.cuh"

namespace {

// warps (one a row) a block; 1 to 16 measured alike on an H100 (PERF.md)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVecs = 8;  // 16-byte vectors a lane keeps in registers
// the parameters stay in registers while they take at most this many
// 16-byte vectors a lane (else each row reads them again, from L1)
constexpr int kParamRegVecs = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lane `lane`'s share of a row in the cached path: vector j holds the
// elements (lane + 32 j) * V .. + V - 1, V = 16 / sizeof(T).
template <typename T, int NV>
__device__ __forceinline__ void load_row(uint4 (&v)[NV],
                                         const T* __restrict__ xr, int lane,
                                         int nv) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < nv ? __ldcs(reinterpret_cast<const uint4*>(xr + i * V))
                  : make_uint4(0, 0, 0, 0);
  }
}

// The parameter's elements beside x's vector i: P 16-byte vectors (P = 2
// for an f32 parameter beside 16-bit x).
template <typename T, typename S>
struct Param {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int P = V * sizeof(S) / 16;
  uint4 v[P];
  __device__ __forceinline__ void load(const S* __restrict__ p, int i) {
#pragma unroll
    for (int q = 0; q < P; ++q)
      v[q] = __ldg(reinterpret_cast<const uint4*>(p + i * V) + q);
  }
  __device__ __forceinline__ float operator[](int t) const {
    return to_f32(reinterpret_cast<const S*>(v)[t]);
  }
};

// A parameter's share of one lane across the NV vectors of a row: held
// in registers when HOLD, else read again (an L1 hit) at each use.
template <typename T, typename S, int NV, bool HOLD>
struct ParamRow {
  Param<T, S> v[HOLD ? NV : 1];
  const S* __restrict__ p;
  __device__ __forceinline__ ParamRow(const S* __restrict__ ptr, int lane,
                                      int nv)
      : p(ptr) {
    if (HOLD) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (lane + 32 * j < nv) v[j].load(p, lane + 32 * j);
    }
  }
  __device__ __forceinline__ Param<T, S> get(int j, int i) const {
    if (HOLD) return v[j];
    Param<T, S> r;
    r.load(p, i);
    return r;
  }
};

// A warp's rows on the persistent grid: first_row(), then every
// row_stride() rows.
__device__ __forceinline__ int first_row() {
  return blockIdx.x * kWarps + (threadIdx.x >> 5);
}
__device__ __forceinline__ int row_stride() { return gridDim.x * kWarps; }

// Walk the warp's rows through two register buffers (the cached path):
// the next row's loads are in flight while `finish` reduces and stores
// the current one.
template <typename T, int NV, typename Finish>
__device__ __forceinline__ void stream_rows(const T* __restrict__ x,
                                            int rows, int d, Finish finish) {
  const int lane = threadIdx.x & 31;
  const int nv = d / (16 / static_cast<int>(sizeof(T)));
  const int stride = row_stride();
  int row = first_row();
  if (row >= rows) return;  // warp-uniform: no barrier below
  uint4 a[NV], b[NV];
  load_row<T, NV>(a, x + static_cast<int64_t>(row) * d, lane, nv);
  for (;;) {
    const int next = row + stride;
    if (next < rows)
      load_row<T, NV>(b, x + static_cast<int64_t>(next) * d, lane, nv);
    finish(a, row);
    if (next >= rows) return;
    row = next + stride;
    if (row < rows)
      load_row<T, NV>(a, x + static_cast<int64_t>(row) * d, lane, nv);
    finish(b, next);
    if (row >= rows) return;
  }
}

// ----------------------------------------------------------------------
// K1: RMSNorm
// ----------------------------------------------------------------------
// the f32 operations of one output element, shared by both paths
__device__ __forceinline__ float rms_out(float v, float r, float s) {
  return v * r * s;
}
__device__ __forceinline__ float rms_factor(float ss, int d, float eps) {
  return rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
}

template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ out, int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kHold = NV * Param<T, S>::P <= kParamRegVecs;
  const int lane = threadIdx.x & 31;
  const int nv = d / V;
  const ParamRow<T, S, NV, kHold> sc(scale, lane, nv);
  stream_rows<T, NV>(x, rows, d, [&](const uint4 (&v)[NV], int row) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (lane + 32 * j < nv) {
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const float f = to_f32(e[t]);
          ss = fmaf(f, f, ss);
        }
      }
    }
    const float r = rms_factor(ss, d, eps);
    T* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < nv) {
        const T* e = reinterpret_cast<const T*>(&v[j]);
        const Param<T, S> s = sc.get(j, i);
        uint4 packed;
        T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int t = 0; t < V; ++t)
          res[t] = from_f32<T>(rms_out(to_f32(e[t]), r, s[t]));
        *reinterpret_cast<uint4*>(orow + i * V) = packed;
      }
    }
  });
}

// The general path: any width, alignment; element col of a row belongs to
// the lane and step the cached path would give it.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel_any(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ out, int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int nvc = (d + V - 1) / V;
  for (int row = first_row(); row < rows; row += row_stride()) {
    const T* xr = x + static_cast<int64_t>(row) * d;
    T* orow = out + static_cast<int64_t>(row) * d;
    float ss = 0.f;
    for (int i = lane; i < nvc; i += 32) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int col = i * V + t;
        if (col < d) {
          const float f = to_f32(xr[col]);
          ss = fmaf(f, f, ss);
        }
      }
    }
    const float r = rms_factor(ss, d, eps);
    for (int i = lane; i < nvc; i += 32) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int col = i * V + t;
        if (col < d)
          orow[col] =
              from_f32<T>(rms_out(to_f32(xr[col]), r, to_f32(scale[col])));
      }
    }
  }
}

// ----------------------------------------------------------------------
// K7: LayerNorm
// ----------------------------------------------------------------------
__device__ __forceinline__ float ln_mean(float s, float inv_d) {
  return __fmul_rn(warp_sum(s), inv_d);
}
__device__ __forceinline__ float ln_factor(float ss, float inv_d,
                                           float eps) {
  return rsqrtf(fmaf(warp_sum(ss), inv_d, eps));
}
__device__ __forceinline__ float ln_out(float v, float mu, float r, float s,
                                        float b) {
  return fmaf((v - mu) * r, s, b);
}

template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                      const S* __restrict__ bias, T* __restrict__ out,
                      int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kHold = 2 * NV * Param<T, S>::P <= kParamRegVecs;
  const int lane = threadIdx.x & 31;
  const int nv = d / V;
  const float inv_d = 1.f / static_cast<float>(d);
  const ParamRow<T, S, NV, kHold> sc(scale, lane, nv);
  const ParamRow<T, S, NV, kHold> bi(bias, lane, nv);
  stream_rows<T, NV>(x, rows, d, [&](const uint4 (&v)[NV], int row) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (lane + 32 * j < nv) {
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int t = 0; t < V; ++t) s += to_f32(e[t]);
      }
    }
    const float mu = ln_mean(s, inv_d);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (lane + 32 * j < nv) {
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const float dv = to_f32(e[t]) - mu;
          ss = fmaf(dv, dv, ss);
        }
      }
    }
    const float r = ln_factor(ss, inv_d, eps);
    T* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < nv) {
        const T* e = reinterpret_cast<const T*>(&v[j]);
        const Param<T, S> ps = sc.get(j, i), pb = bi.get(j, i);
        uint4 packed;
        T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int t = 0; t < V; ++t)
          res[t] = from_f32<T>(ln_out(to_f32(e[t]), mu, r, ps[t], pb[t]));
        *reinterpret_cast<uint4*>(orow + i * V) = packed;
      }
    }
  });
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel_any(const T* __restrict__ x,
                          const S* __restrict__ scale,
                          const S* __restrict__ bias, T* __restrict__ out,
                          int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int nvc = (d + V - 1) / V;
  const float inv_d = 1.f / static_cast<float>(d);
  for (int row = first_row(); row < rows; row += row_stride()) {
    const T* xr = x + static_cast<int64_t>(row) * d;
    T* orow = out + static_cast<int64_t>(row) * d;
    float s = 0.f;
    for (int i = lane; i < nvc; i += 32) {
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (i * V + t < d) s += to_f32(xr[i * V + t]);
    }
    const float mu = ln_mean(s, inv_d);
    float ss = 0.f;
    for (int i = lane; i < nvc; i += 32) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        if (i * V + t < d) {
          const float dv = to_f32(xr[i * V + t]) - mu;
          ss = fmaf(dv, dv, ss);
        }
      }
    }
    const float r = ln_factor(ss, inv_d, eps);
    for (int i = lane; i < nvc; i += 32) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int col = i * V + t;
        if (col < d)
          orow[col] = from_f32<T>(ln_out(to_f32(xr[col]), mu, r,
                                         to_f32(scale[col]),
                                         to_f32(bias[col])));
      }
    }
  }
}

// ----------------------------------------------------------------------
// launch
// ----------------------------------------------------------------------
// Blocks of the persistent grid for `rows`: one block a group of kWarps
// rows, at most what fills the card once (SMs x resident blocks, as the
// occupancy API gives them for this kernel; taken once a process, for the
// device current at the first call).
template <auto Kernel>
int grid_blocks(int rows) {
  static const int cap = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads,
                                                  0);
    return std::max(1, sms * per_sm);
  }();
  return std::min((rows + kWarps - 1) / kWarps, cap);
}

template <auto Kernel, typename... Args>
void launch(int rows, cudaStream_t s, Args... args) {
  Kernel<<<grid_blocks<Kernel>(rows), kThreads, 0, s>>>(args...);
}

// Vectors a lane the cached path holds for width d (1, 2, 3, 4, 6 or 8),
// or 0 for the general path.
template <typename T>
int cached_vectors(int d, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  if (!aligned || d % V != 0) return 0;
  const int per_lane = (d / V + 31) / 32;
  for (int nv : {1, 2, 3, 4, 6, kMaxVecs})
    if (per_lane <= nv) return nv;
  return 0;
}

template <typename T, typename S>
void rms_dispatch(const void* xp, const void* sp, void* op, int rows, int d,
                  float eps, cudaStream_t st) {
  const T* x = static_cast<const T*>(xp);
  const S* s = static_cast<const S*>(sp);
  T* o = static_cast<T*>(op);
  const bool al = aligned16(x) && aligned16(s) && aligned16(o);
  switch (cached_vectors<T>(d, al)) {
#define RLA_RMS(NV)                                                         \
  case NV:                                                                  \
    return launch<rms_norm_kernel<T, S, NV>>(rows, st, x, s, o, rows, d,   \
                                             eps);
    RLA_RMS(1) RLA_RMS(2) RLA_RMS(3) RLA_RMS(4) RLA_RMS(6) RLA_RMS(8)
#undef RLA_RMS
    default:
      return launch<rms_norm_kernel_any<T, S>>(rows, st, x, s, o, rows, d,
                                               eps);
  }
}

template <typename T, typename S>
void ln_dispatch(const void* xp, const void* sp, const void* bp, void* op,
                 int rows, int d, float eps, cudaStream_t st) {
  const T* x = static_cast<const T*>(xp);
  const S* s = static_cast<const S*>(sp);
  const S* b = static_cast<const S*>(bp);
  T* o = static_cast<T*>(op);
  const bool al =
      aligned16(x) && aligned16(s) && aligned16(b) && aligned16(o);
  switch (cached_vectors<T>(d, al)) {
#define RLA_LN(NV)                                                          \
  case NV:                                                                  \
    return launch<layer_norm_kernel<T, S, NV>>(rows, st, x, s, b, o, rows, \
                                               d, eps);
    RLA_LN(1) RLA_LN(2) RLA_LN(3) RLA_LN(4) RLA_LN(6) RLA_LN(8)
#undef RLA_LN
    default:
      return launch<layer_norm_kernel_any<T, S>>(rows, st, x, s, b, o, rows,
                                                 d, eps);
  }
}

// Call f(T{}, S{}) for x's type T (`dtype`) and the parameters' type S:
// f32 when param_f32 or x is f32, else T.  Returns cudaGetLastError().
template <typename F>
int by_dtype(int dtype, bool param_f32, F f) {
  switch (dtype) {
    case kF32:
      f(float{}, float{});
      break;
    case kBF16:
      if (param_f32)
        f(__nv_bfloat16{}, float{});
      else
        f(__nv_bfloat16{}, __nv_bfloat16{});
      break;
    case kF16:
      if (param_f32)
        f(__half{}, float{});
      else
        f(__half{}, __half{});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int rms_norm(const void* x, const void* scale, void* out, int rows, int d,
             float eps, int dtype, bool param_f32, cudaStream_t s) {
  return by_dtype(dtype, param_f32, [&](auto t, auto p) {
    rms_dispatch<decltype(t), decltype(p)>(x, scale, out, rows, d, eps, s);
  });
}

int layer_norm(const void* x, const void* scale, const void* bias,
               void* out, int rows, int d, float eps, int dtype,
               bool param_f32, cudaStream_t s) {
  return by_dtype(dtype, param_f32, [&](auto t, auto p) {
    ln_dispatch<decltype(t), decltype(p)>(x, scale, bias, out, rows, d, eps,
                                          s);
  });
}

}  // namespace

// x, out: [rows, d] contiguous in `dtype`; scale: [d], f32 when scale_f32
// else `dtype` (f32 x takes an f32 scale).  Returns cudaGetLastError()
// after the launch.
extern "C" int rla_rms_norm(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, int dtype,
                            int scale_f32, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return rms_norm(x, scale, out, rows, d, eps, dtype, scale_f32 != 0,
                  static_cast<cudaStream_t>(stream));
}

// x, out: [rows, d] contiguous in `dtype`; scale, bias: [d], both f32 when
// param_f32 else both `dtype`.  Returns cudaGetLastError() after the launch.
extern "C" int rla_layer_norm(const void* x, const void* scale,
                              const void* bias, void* out, int rows, int d,
                              float eps, int dtype, int param_f32,
                              void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return layer_norm(x, scale, bias, out, rows, d, eps, dtype,
                    param_f32 != 0, static_cast<cudaStream_t>(stream));
}

