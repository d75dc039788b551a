// int8 weight-only matrix products for Hopper (sm_90a).
//
// Two entry points, matching ops/quant.py:
//
// rla_int8_matmul: out[M,N] = x[M,K] @ (w[K,N] int8 * scale[N]).
//   Replaces the TPU kernel `_mm_kernel` (the JAX package's
//   ops/quant.py:55, launched by `int8_matmul` :150).
//   What bounds it: at decode (M = live slots) every weight byte is used
//   for only 2*M flops, so it is bound by streaming the int8 weight from
//   device memory (0.59 MB to 2.4 MB per projection of the GPT-2-small
//   class model); at N = 768 a plain one-tile-per-column-block grid gives
//   6 blocks for 132 SMs.
//   Design: a block owns 128 output columns (4 per lane, one 4-byte int8
//   load per weight row, coalesced along N) and 16 output rows; x rows
//   are staged in shared memory as f32 and broadcast to every lane.  The
//   contraction is split twice: the 4 warps of a block take interleaved
//   16-row slices of each 64-row k step and are summed through shared
//   memory, and the grid's z dimension splits K across blocks so that
//   narrow outputs still fill the card.  With a split, blocks write f32
//   partial sums and a second small kernel adds them in a fixed order
//   (deterministic) and applies the per-column scale; without one the
//   block applies the scale itself.  Accumulation is f32 throughout; the
//   int8 weight is widened in registers, never written back.
//
// rla_int8_matmul_nt: out[M,N] = x[M,K] @ w[N,K]^T, int8, no scale (the
//   tied-embedding unembedding; the caller folds the contraction-dim
//   scales into x).  Replaces `_mm_nt_kernel` (quant.py:78, launched by
//   `int8_matmul_nt` :182).
//   What bounds it: the weight read, 38.6 MB at N = 50304, K = 768 -- the
//   largest single read of a decode step -- so >= 11.5 us at 3.35 TB/s;
//   with 16 rows the f32 multiply-adds on the CUDA cores (16 per weight
//   byte) are of the same order.
//   Design: row n of w is contiguous along K, so each warp owns 4 output
//   columns and streams their rows with 16-byte loads (lane l reads bytes
//   16l..16l+15 of each 512-byte k step); the block's 16 rows of x are
//   staged in shared memory as f32, padded so that the lanes' 16-byte
//   reads hit distinct banks.  Each lane keeps 4 x 16 partial dot
//   products and the warp reduces them with xor shuffles at the end.

#include <algorithm>

#include "common.cuh"

namespace {

// ---- int8_matmul (w [K, N]) ---------------------------------------------
constexpr int kMmThreads = 128;  // 4 warps
constexpr int kMmCols = 128;     // output columns per block: 4 per lane
constexpr int kMmRows = 16;      // output rows per block
constexpr int kMmKStep = 64;     // k rows staged per round: 16 per warp
constexpr int kMmWarpK = kMmKStep / (kMmThreads / 32);

template <typename T>
__global__ void __launch_bounds__(kMmThreads)
    int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ partial, int M, int K, int N,
                   int k_per_split, bool vec) {
  __shared__ float xs[kMmRows][kMmKStep];
  __shared__ __align__(16) float red[kMmThreads / 32][kMmRows][kMmCols];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kMmCols;
  const int m0 = blockIdx.y * kMmRows;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int col = n0 + lane * 4;

  float acc[kMmRows][4];
#pragma unroll
  for (int m = 0; m < kMmRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kb = k_begin; kb < k_end; kb += kMmKStep) {
    for (int i = tid; i < kMmRows * kMmKStep; i += kMmThreads) {
      const int m = i / kMmKStep;
      const int kk = i % kMmKStep;
      const int gm = m0 + m;
      const int gk = kb + kk;
      xs[m][kk] = (gm < M && gk < k_end)
                      ? to_f32(x[static_cast<int64_t>(gm) * K + gk])
                      : 0.f;
    }
    __syncthreads();
    for (int kk = warp * kMmWarpK; kk < (warp + 1) * kMmWarpK; ++kk) {
      const int gk = kb + kk;
      if (gk >= k_end) break;  // warp-uniform
      const int8_t* wrow = w + static_cast<int64_t>(gk) * N;
      float wv[4];
      if (vec) {
        // N % 4 == 0: a lane's 4-column group is wholly inside or outside
        if (col < N) {
          const char4 c = *reinterpret_cast<const char4*>(wrow + col);
          wv[0] = c.x;
          wv[1] = c.y;
          wv[2] = c.z;
          wv[3] = c.w;
        } else {
          wv[0] = wv[1] = wv[2] = wv[3] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = col + j < N ? static_cast<float>(wrow[col + j]) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kMmRows; ++m) {
        const float xv = xs[m][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kMmRows; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = n0 + tid;  // thread t finishes column t of the tile
  if (n >= N) return;
  for (int m = 0; m < kMmRows; ++m) {
    const int gm = m0 + m;
    if (gm >= M) break;
    float s = red[0][m][tid];
#pragma unroll
    for (int wp = 1; wp < kMmThreads / 32; ++wp) s += red[wp][m][tid];
    if (partial != nullptr)
      partial[(static_cast<int64_t>(blockIdx.z) * M + gm) * N + n] = s;
    else
      out[static_cast<int64_t>(gm) * N + n] = from_f32<T>(s * scale[n]);
  }
}

// Sum the split-K partials in split order, apply the column scale, cast.
template <typename T>
__global__ void int8_mm_reduce_kernel(const float* __restrict__ partial,
                                      const float* __restrict__ scale,
                                      T* __restrict__ out, int M, int N,
                                      int splits) {
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * total + i];
    out[i] = from_f32<T>(s * scale[i % N]);
  }
}

template <typename T>
void launch_mm(const void* x, const void* w, const void* scale, void* out,
               void* partial, int M, int K, int N, int splits,
               int k_per_split, cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid((N + kMmCols - 1) / kMmCols, (M + kMmRows - 1) / kMmRows,
                  splits);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  int8_mm_kernel<T><<<grid, kMmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out), part, M, K, N,
      k_per_split, vec);
  if (part != nullptr) {
    const int64_t total = static_cast<int64_t>(M) * N;
    const int blocks =
        static_cast<int>(std::min<int64_t>((total + 255) / 256, 4096));
    int8_mm_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
        part, static_cast<const float*>(scale), static_cast<T*>(out), M, N,
        splits);
  }
}

// ---- int8_matmul_nt (w [N, K]) ------------------------------------------
constexpr int kNtThreads = 128;   // 4 warps
constexpr int kNtColsPerWarp = 4;
constexpr int kNtCols = kNtColsPerWarp * (kNtThreads / 32);  // 16 per block
constexpr int kNtRows = 16;       // output rows per block
constexpr int kNtKStep = 512;     // 32 lanes x 16 int8
// 4 floats of padding after every 16: lane l's 16-float slice starts at
// 20*l, so the 8 lanes of each 16-byte shared-memory phase hit 8 disjoint
// groups of 4 banks
constexpr int kNtPitch = kNtKStep + kNtKStep / 4;

__device__ __forceinline__ int nt_slot(int kk) { return kk + (kk >> 4) * 4; }

template <typename T>
__global__ void __launch_bounds__(kNtThreads)
    int8_mm_nt_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                      T* __restrict__ out, int M, int K, int N, bool vec) {
  __shared__ __align__(16) float xs[kNtRows][kNtPitch];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_base = blockIdx.x * kNtCols + warp * kNtColsPerWarp;
  const int m0 = blockIdx.y * kNtRows;

  float acc[kNtColsPerWarp][kNtRows];
#pragma unroll
  for (int c = 0; c < kNtColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < kNtRows; ++m) acc[c][m] = 0.f;

  for (int kb = 0; kb < K; kb += kNtKStep) {
    for (int i = tid; i < kNtRows * kNtKStep; i += kNtThreads) {
      const int m = i / kNtKStep;
      const int kk = i % kNtKStep;
      const int gm = m0 + m;
      const int gk = kb + kk;
      xs[m][nt_slot(kk)] = (gm < M && gk < K)
                               ? to_f32(x[static_cast<int64_t>(gm) * K + gk])
                               : 0.f;
    }
    __syncthreads();
    const int kk0 = lane * 16;
    const int gk0 = kb + kk0;
    float wf[kNtColsPerWarp][16];
#pragma unroll
    for (int c = 0; c < kNtColsPerWarp; ++c) {
      const int n = n_base + c;
      if (n < N && vec && gk0 + 16 <= K) {
        const int4 raw = *reinterpret_cast<const int4*>(
            w + static_cast<int64_t>(n) * K + gk0);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) wf[c][j] = static_cast<float>(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          wf[c][j] = (n < N && gk0 + j < K)
                         ? static_cast<float>(
                               w[static_cast<int64_t>(n) * K + gk0 + j])
                         : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < kNtRows; ++m) {
      const float4* xp = reinterpret_cast<const float4*>(&xs[m][nt_slot(kk0)]);
      float xv[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 t = xp[q];
        xv[4 * q] = t.x;
        xv[4 * q + 1] = t.y;
        xv[4 * q + 2] = t.z;
        xv[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int c = 0; c < kNtColsPerWarp; ++c)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[c][m] = fmaf(xv[j], wf[c][j], acc[c][m]);
    }
    __syncthreads();
  }

  // warp-reduce every (column, row) sum; lane l then stores the entries
  // whose flat index is l or l + 32
#pragma unroll
  for (int c = 0; c < kNtColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < kNtRows; ++m) {
      float v = acc[c][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[c][m] = v;
    }
#pragma unroll
  for (int c = 0; c < kNtColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < kNtRows; ++m) {
      if (((c * kNtRows + m) & 31) != lane) continue;
      const int n = n_base + c;
      const int gm = m0 + m;
      if (n < N && gm < M)
        out[static_cast<int64_t>(gm) * N + n] = from_f32<T>(acc[c][m]);
    }
}

template <typename T>
void launch_mm_nt(const void* x, const void* w, void* out, int M, int K,
                  int N, cudaStream_t stream) {
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + kNtCols - 1) / kNtCols, (M + kNtRows - 1) / kNtRows);
  int8_mm_nt_kernel<T><<<grid, kNtThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<T*>(out), M, K, N, vec);
}

}  // namespace

// x: [M, K] in `dtype`; w: [K, N] int8; scale: [N] f32; out: [M, N] in
// `dtype`; partial: [splits, M, N] f32 scratch when splits > 1 (else
// unused).  The z split s covers k in [s * k_per_split, (s+1) *
// k_per_split).  Returns cudaGetLastError() after the launches.
extern "C" int rla_int8_matmul(const void* x, const void* w,
                               const void* scale, void* out, void* partial,
                               int M, int K, int N, int splits,
                               int k_per_split, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || k_per_split <= 0 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch_mm<float>(x, w, scale, out, partial, M, K, N, splits,
                       k_per_split, s);
      break;
    case kBF16:
      launch_mm<__nv_bfloat16>(x, w, scale, out, partial, M, K, N, splits,
                               k_per_split, s);
      break;
    case kF16:
      launch_mm<__half>(x, w, scale, out, partial, M, K, N, splits,
                        k_per_split, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [M, K] in `dtype`; w: [N, K] int8; out: [M, N] in `dtype`.
extern "C" int rla_int8_matmul_nt(const void* x, const void* w, void* out,
                                  int M, int K, int N, int dtype,
                                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch_mm_nt<float>(x, w, out, M, K, N, s);
      break;
    case kBF16:
      launch_mm_nt<__nv_bfloat16>(x, w, out, M, K, N, s);
      break;
    case kF16:
      launch_mm_nt<__half>(x, w, out, M, K, N, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
