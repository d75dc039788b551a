// Flash-attention forward for Hopper (sm_90a), with the per-row
// log-sum-exp.
//
// Replaces the TPU kernel `_flash_kernel` (the JAX package's
// ops/attention.py:83, launched by `_flash_forward` :147 through its
// `pallas_call` at :158).  For q, k, v [bh, S, D] it computes
//   out = softmax(mask(q k^T * scale)) v  and  lse = m + log(l)
// with the TPU kernel's arithmetic: f32 products and sums of the
// operands, masked scores set to -1e30 (not -inf), causal masking counted
// top-left (query i sees keys j <= i, both from 0), a sliding window that
// also keeps i - j < window, an online softmax whose running max starts at
// -1e30 and running sum at 0, the probabilities rounded to v's dtype before
// the PV product, out = acc / l with l == 0 read as 1, and lse in f32.
// Keys past k_len (the ragged tail of the last tile) never enter the max,
// the sum or the product: they are excluded outright, not through -1e30.
//
// What bounds it on an H100: at the GPT-2-small class prefill ([192, 128,
// 64] bf16, causal) it reads q, k, v and writes out once, 12.6 MB, or
// 3.8 us at 3.35 TB/s, against 0.4 GFLOP (0.4 us on the bf16 tensor
// cores): memory-bound by its bytes.  This design does its products on
// the f32 CUDA cores (67 TFLOP/s), which puts its floor at about 6 us
// there; tensor cores (mma.sync / wgmma) are a later change.
//
// Design: one block of 128 threads per (bh, 64-row query tile); two
// threads per query row, each holding half of the row's q and of its f32
// output accumulator in registers (interleaved 4-float chunks, so the
// pair's 16-byte shared-memory reads fall on neighbouring banks).  The
// block walks the key tiles in order (64 keys at D = 64, 32 at D = 128,
// so both stage 32 KB), staging k and v in shared memory as f32 with
// 16-byte loads where the pointers allow; each thread computes its
// half-dots, the pair adds them with one shuffle, and both keep identical
// running max and sum.  The online softmax steps 16 keys at a time (a
// rolled loop over the staged tile), which keeps the scores in registers
// without unrolling the whole tile.  Causal and window masking skip whole
// key tiles that lie above the tile's last query or left of its first
// query's window, as the TPU kernel skips blocks.  No atomics: every
// output element is written once by one thread (deterministic).

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;             // query rows per block
constexpr int kThreads = 2 * kBlockQ;   // two threads per query row
constexpr float kMasked = -1e30f;       // the TPU kernel's _NEG_INF

constexpr int kSub = 16;                // keys per online-softmax step

template <int D>
struct FlashTile {
  static constexpr int kBlockK = D >= 128 ? 32 : 64;  // keys per tile
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int q_len, int k_len,
                     float scale, bool masked, int window, bool vec) {
  constexpr int BK = FlashTile<D>::kBlockK;
  constexpr int C = D / 8;  // 4-float chunks per thread (half of D / 4)
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int qpos = q0 + (tid >> 1);
  const bool row_ok = qpos < q_len;
  const int64_t qoff =
      (static_cast<int64_t>(bh) * q_len + (row_ok ? qpos : 0)) * D;
  const T* kb = k + static_cast<int64_t>(bh) * k_len * D;
  const T* vb = v + static_cast<int64_t>(bh) * k_len * D;

  // this thread's chunks: chunk 2i + half covers d = 4(2i + half) .. +3
  float qr[4 * C];
  float acc[4 * C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int d0 = 4 * (2 * i + half);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * i + e] = row_ok ? to_f32(q[qoff + d0 + e]) : 0.f;
      acc[4 * i + e] = 0.f;
    }
  }
  float m = kMasked, l = 0.f;

  // key tiles this query tile needs: none wholly above its last query
  // (causal) and none wholly left of its first query's window
  const int q_last = min(q0 + kBlockQ, q_len) - 1;
  int kt_end = (k_len + BK - 1) / BK;
  if (masked) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is fully consumed
    const int n_valid = min(BK, k_len - k0) * D;
    const int64_t g0 = static_cast<int64_t>(k0) * D;
    // keys past k_len stage as zeros (their p is 0, and 0 * v stays 0)
    stage_f32<T, kThreads>(kb + g0, ks, BK * D, n_valid, vec, tid);
    stage_f32<T, kThreads>(vb + g0, vs, BK * D, n_valid, vec, tid);
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += kSub) {
      if (k0 + j0 >= k_len) break;  // block-uniform: the rest is padding
      float s[kSub];
      float tmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float4 kk = kr[2 * i + half];
          part = fmaf(qr[4 * i + 0], kk.x, part);
          part = fmaf(qr[4 * i + 1], kk.y, part);
          part = fmaf(qr[4 * i + 2], kk.z, part);
          part = fmaf(qr[4 * i + 3], kk.w, part);
        }
        const float dot = part + __shfl_xor_sync(0xffffffffu, part, 1);
        const int key = k0 + j;
        float sc = dot * scale;
        if (key >= k_len) {
          sc = -INFINITY;  // out of range: excluded from max, sum and PV
        } else if (masked && (key > qpos || (window > 0 &&
                                             qpos - key >= window))) {
          sc = kMasked;
        }
        s[jj] = sc;
        tmax = fmaxf(tmax, sc);
      }
      // the step holds >= 1 in-range key, so tmax >= -1e30 is finite
      const float m_new = fmaxf(m, tmax);
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < 4 * C; ++i) acc[i] *= alpha;
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = expf(s[jj] - m_new);
        psum += p;
        // p in v's dtype before the PV product, as the TPU kernel casts it
        const float pr = to_f32(from_f32<T>(p));
        const float4* vr =
            reinterpret_cast<const float4*>(vs + (j0 + jj) * D);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float4 vv = vr[2 * i + half];
          acc[4 * i + 0] = fmaf(pr, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(pr, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pr, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pr, vv.w, acc[4 * i + 3]);
        }
      }
      l = alpha * l + psum;
      m = m_new;
    }
  }

  if (!row_ok) return;  // after the loop: every lane took every shuffle
  const float lf = l == 0.f ? 1.f : l;  // a row that saw no key -> 0
  T* orow = o + qoff;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int d0 = 4 * (2 * i + half);
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[d0 + e] = from_f32<T>(acc[4 * i + e] / lf);
  }
  if (half == 0) lse[static_cast<int64_t>(bh) * q_len + qpos] = m + logf(lf);
}

template <typename T, int D>
void launch_flash(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int q_len, int k_len, float scale,
                  bool masked, int window, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid(bh, (q_len + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      q_len, k_len, scale, masked, window, vec);
}

template <typename T>
int launch_for_dim(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int q_len, int k_len, int d,
                   float scale, bool masked, int window,
                   cudaStream_t stream) {
  switch (d) {
    case 64:
      launch_flash<T, 64>(q, k, v, o, lse, bh, q_len, k_len, scale, masked,
                          window, stream);
      return 0;
    case 128:
      launch_flash<T, 128>(q, k, v, o, lse, bh, q_len, k_len, scale, masked,
                           window, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [bh, q_len, d], k and v [bh, k_len, d], o [bh, q_len, d], all
// contiguous in `dtype`; lse [bh, q_len] f32.  causal != 0 masks keys past
// the query (top-left aligned); window > 0 also masks keys at or beyond
// `window` positions back (and implies the causal mask); window <= 0 is no
// window.  d is 64 or 128.  Returns cudaGetLastError() after the launch.
extern "C" int rla_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int bh, int q_len, int k_len, int d,
                                   float scale, int causal, int window,
                                   int dtype, void* stream) {
  if (bh <= 0 || q_len <= 0 || k_len <= 0 ||
      (q_len + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = causal != 0 || window > 0;
  int err;
  switch (dtype) {
    case kF32:
      err = launch_for_dim<float>(q, k, v, o, lse, bh, q_len, k_len, d, scale,
                                  masked, window, s);
      break;
    case kBF16:
      err = launch_for_dim<__nv_bfloat16>(q, k, v, o, lse, bh, q_len, k_len,
                                          d, scale, masked, window, s);
      break;
    case kF16:
      err = launch_for_dim<__half>(q, k, v, o, lse, bh, q_len, k_len, d,
                                   scale, masked, window, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
