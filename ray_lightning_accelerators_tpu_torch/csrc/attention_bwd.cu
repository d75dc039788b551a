// Flash-attention backward for Hopper (sm_90a): the split pair (dq; dk and
// dv) and the fused one-pass kernel.
//
// Replaces the TPU kernels of the JAX package's ops/attention.py:
//   K3a `_flash_bwd_dq_kernel`  (:226, pallas_call in `_flash_backward` :371)
//   K3b `_flash_bwd_dkv_kernel` (:256, pallas_call in `_flash_backward` :386)
//   K4  `_flash_bwd_fused_kernel` (:290, `_flash_backward_fused` :335)
// For q, dO [bh, Sq, D], k, v [bh, Sk, D], the forward's f32 lse [bh, Sq]
// and delta = rowsum(dO * O) [bh, Sq] (f32, computed outside, as there):
//   S  = mask(q k^T * scale)   masked scores set to -1e30, top-left causal,
//                              a window also keeps qpos - kpos < window
//   P  = exp(S - lse)          dP = dO v^T
//   dS = P * (dP - delta) * scale
//   dV = round(P) ^T dO        P rounded to dO's dtype first
//   dK = round(dS)^T q         dS rounded to q's dtype first
//   dQ = round(dS)   k         dS rounded to k's dtype first
// with f32 products and sums, written in the inputs' dtype -- the
// arithmetic of the TPU kernels' shared `_bwd_block` (:203-223).  Keys
// past Sk and queries past Sq (the ragged tails of the last tiles) are
// excluded outright: staged as zeros, their P and dS forced to 0.  Whole
// tiles outside the causal / window mask are skipped, as the TPU kernels'
// `needed` predicate (:236-239, :267-270) skips blocks, except where a
// row sees no key (a window, q >= k_len + window - 1): its P is 1 over
// every key, as the plain version's is, so K3a keeps the window's left
// edge whole for its query tile (`key_tiles`, common.cuh) and every K3b /
// K4 key block walks on to the last query tile (`query_tiles`).
//
// What bounds them on an H100: at the GPT training shape ([192, 1024, 64]
// bf16, causal) the backward reads q, k, v, dO once and writes dq, dk, dv
// once (176 MB counting lse and delta, 53 us at 3.35 TB/s) against five
// products over the 525k (query, key) pairs each (b, h) keeps, 64.5
// GFLOP, 65 us on the bf16 tensor cores (989 TFLOP/s): operations bound,
// barely.  On the f32 CUDA cores (67 TFLOP/s) the same products take at
// least 963 us (K4), 770 us (K3b, four products) and 577 us (K3a,
// three).
//
// Routes, by dtype: bf16 and f16 operands take the tensor-core bodies,
// `flash_bwd_dq_kernel_tc` for K3a and `flash_bwd_kv_kernel_tc` for K3b and
// K4; f32 operands take the scalar bodies `flash_bwd_dq_kernel_f32` and
// `flash_bwd_kv_kernel_f32` (TF32 would miss the f32 checks' 1e-5).  A
// CUDA tensor of a dtype launches its body or the wrapper raises; nothing
// retries another body.
//
// K3a on the tensor cores (`flash_bwd_dq_kernel_tc<T, D>`).
//   The transpose of K3b's design: one warpgroup per (bh, 64 queries),
//   queries the M dimension of every product, so dQ stays in f32
//   accumulators (D / 2 a thread) across the whole key walk and is written
//   once: deterministic, no atomics, no f32 buffer.  Query tiles launch
//   heaviest first (reverse blockIdx.y).
//   - staging: q and dO of the block once, lse and delta of the thread's
//     two rows in registers, then the key and value tiles of 64 keys that
//     the mask needs (`key_tiles`, common.cuh) through K2's two-stage
//     cp.async ring (`walk_key_tiles`, wgmma.cuh), in the swizzled layout
//     of `load_tile`, shared with K3b / K4.
//   - S = Q K^T and dP = dO V^T (`gmma_abt`): wgmma m64n64k16, K-major
//     operands, committed as two groups so that P's exp overlaps dP's
//     product.
//   - dQ += round(dS) K (`gmma_rs_mn`): wgmma with A from registers (dS
//     rounded to T by pack2, the TPU arithmetic's cast) and B = the key
//     tile MN-major.
//   Measured (-Xptxas -v, chip_smoke.py phase 1): 135 registers at D = 64
//   and 166 at D = 128, no spills; dynamic shared memory
//   RingSmem<D, 2>::kAlloc, 49 KB at D = 64 and 97 KB at D = 128.  On an
//   NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 2c, PERF.md):
//   219.17 us at the training shape, 177 TFLOP/s or 0.18 of the bound,
//   against 3358 us for the scalar body it replaces.
//
// K3b / K4 on the tensor cores (`flash_bwd_kv_kernel_tc<T, D, FUSED>`).
//   One block per (bh, 128 keys): two warpgroups, each owning 64 keys as
//   the M dimension of every product, so dK and dV stay in registers (f32
//   accumulators, D / 2 a thread each), are written once, and K3b is
//   deterministic.  The block walks the 64-query tiles the mask needs:
//   - staging: k and v of the block once, then q, dO, lse and delta of
//     each query tile into a two-stage ring by cp.async (16-byte copies,
//     zero-filled past q_len / k_len), the next tile's copy in flight
//     while this one's products run; 16-bit tiles as they are, in the
//     128-byte swizzled layout of wgmma.cuh, so wgmma reads them without
//     bank conflicts.  Operands not 16-byte aligned are staged by
//     element loads into the same layout.
//   - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands
//     K-major from shared memory; P = exp(mask(S^T) - lse) and dS = P
//     (dP - delta) scale in f32 in the accumulator registers, 0 past the
//     ragged tails.
//   - dV += round(P^T) dO and dK += round(dS^T) Q: wgmma with A from
//     registers (the accumulators converted to T in place: the rounding
//     points of the TPU arithmetic) and B = dO / Q read MN-major.
//   - K4 only: round(dS^T) goes to shared memory once; dQ[64 queries,
//     D / 2] = dS K over the block's 128 keys per warpgroup (wgmma, both
//     operands MN-major), added into the zeroed f32 [bh, Sq, D] buffer by
//     one atomicAdd per (query, dim) per key block; the wrapper casts it
//     to q's dtype.  The order of those adds is not fixed, so dq is not
//     bitwise reproducible; dk and dv are.
//   Products are bf16 x bf16 (or f16) exact into f32, so the results
//   differ from the plain version by summation order only.
//   Measured (nvcc 12.9, -Xptxas -v): 209 registers (K4) and 183 (K3b) at
//   D = 64, 254 and 255 at D = 128, no spills; dynamic shared memory
//   TcSmem<D, FUSED>::kAlloc: 82 / 66 KB at D = 64, 146 / 130 KB at D =
//   128; one block (8 warps) an SM.  At the training shape on an NVIDIA
//   H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 2c, PERF.md), K4
//   takes 554.26 us and K3b 361.85 us, 12% and 14% of the bound, against
//   5303 and 3888 us for the scalar body they replace.
//
// The scalar bodies.  Every block has 256 threads and every thread holds
// 16 floats of a row (interleaved 4-float chunks, so the threads of one
// row read neighbouring 16-byte words of a shared row: no bank
// conflicts); a row of D floats is shared by TPR = D / 16 neighbouring
// lanes, whose partial dot products meet by xor shuffles.  A tile is
// 256 / TPR rows: 64 at D = 64, 32 at D = 128.  The inner loops are
// rolled and step 4 rows at a time, as the forward's 16-key steps keep
// nvcc's time and the registers down.
//
// K3a `flash_bwd_dq_kernel_f32<D>`: one block per (bh, query tile); each
//   thread keeps its part of q, dO and the dq accumulator in registers and
//   walks the key tiles, k and v staged in shared memory.  Every dq
//   element is written once by one thread: deterministic.
// K3b / K4 `flash_bwd_kv_kernel_f32<D, FUSED>`: one block per (bh, key
//   tile); each thread keeps its part of k, v and the dk, dv accumulators
//   in registers (64 floats) and walks the query tiles, q and dO staged
//   in shared memory; K4 stages each query tile's rounded dS and adds dS
//   k over its keys into the f32 dq buffer by atomicAdd.

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;  // the TPU kernels' _NEG_INF
constexpr int kStep = 4;           // rows per step of the rolled loops

template <int D>
struct BwdTile {
  static constexpr int kTPR = D / 16;              // threads per row
  static constexpr int kRows = kThreads / kTPR;    // rows a block owns
};

// sum over the kTPR neighbouring lanes of one row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// this thread's 16 floats of a shared f32 row: chunks TPR * c + part
template <int TPR>
__device__ __forceinline__ float dot16(const float* __restrict__ row,
                                       const float* __restrict__ mine,
                                       int part) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 x = r4[TPR * c + part];
    acc = fmaf(mine[4 * c + 0], x.x, acc);
    acc = fmaf(mine[4 * c + 1], x.y, acc);
    acc = fmaf(mine[4 * c + 2], x.z, acc);
    acc = fmaf(mine[4 * c + 3], x.w, acc);
  }
  return acc;
}

template <int TPR>
__device__ __forceinline__ void axpy16(float a, const float* __restrict__ row,
                                       float* __restrict__ acc, int part) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 x = r4[TPR * c + part];
    acc[4 * c + 0] = fmaf(a, x.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(a, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, x.w, acc[4 * c + 3]);
  }
}

// global row -> this thread's 16 floats (zeros for an invalid row)
template <typename T, int TPR>
__device__ __forceinline__ void load16(const T* __restrict__ row, bool ok,
                                       float* __restrict__ mine, int part) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d0 = 4 * (TPR * c + part);
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[4 * c + e] = ok ? to_f32(row[d0 + e]) : 0.f;
  }
}

template <typename T, int TPR>
__device__ __forceinline__ void store16(T* __restrict__ row,
                                        const float* __restrict__ mine,
                                        int part) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d0 = 4 * (TPR * c + part);
#pragma unroll
    for (int e = 0; e < 4; ++e) row[d0 + e] = from_f32<T>(mine[4 * c + e]);
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float masked_score(float dot, float scale,
                                              int qpos, int kpos, bool masked,
                                              int window) {
  const float s = dot * scale;
  if (masked && (kpos > qpos || (window > 0 && qpos - kpos >= window)))
    return kMasked;
  return s;
}

// K3a, f32 operands ---------------------------------------------------- //
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel_f32(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int q_len, int k_len,
                            float scale, bool masked, int window, bool vec) {
  using T = float;
  constexpr int TPR = BwdTile<D>::kTPR;
  constexpr int BQ = BwdTile<D>::kRows;  // query rows per block
  constexpr int BK = BwdTile<D>::kRows;  // keys per staged tile
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int qpos = q0 + tid / TPR;
  const bool row_ok = qpos < q_len;
  const int64_t qrow = static_cast<int64_t>(bh) * q_len + (row_ok ? qpos : 0);
  float qr[16], dor[16], acc[16];
  load16<T, TPR>(q + qrow * D, row_ok, qr, part);
  load16<T, TPR>(dout + qrow * D, row_ok, dor, part);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const float lse_r = row_ok ? lse[qrow] : 0.f;
  const float dta_r = row_ok ? delta[qrow] : 0.f;

  const int2 kts = key_tiles<BK>(q0, min(BQ, q_len - q0), k_len, masked,
                                 window);
  const T* kb = k + static_cast<int64_t>(bh) * k_len * D;
  const T* vb = v + static_cast<int64_t>(bh) * k_len * D;

  for (int kt = kts.x; kt < kts.y; ++kt) {
    const int k0 = kt * BK;
    const int n_k = min(BK, k_len - k0);
    __syncthreads();  // the previous tile is fully consumed
    const int64_t g0 = static_cast<int64_t>(k0) * D;
    stage_f32<T, kThreads>(kb + g0, ks, BK * D, n_k * D, vec, tid);
    stage_f32<T, kThreads>(vb + g0, vs, BK * D, n_k * D, vec, tid);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < n_k; j0 += kStep) {  // block-uniform bound
      float s[kStep], dp[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        s[u] = dot16<TPR>(ks + (j0 + u) * D, qr, part);
        dp[u] = dot16<TPR>(vs + (j0 + u) * D, dor, part);
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        s[u] = row_sum<TPR>(s[u]);
        dp[u] = row_sum<TPR>(dp[u]);
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int kpos = k0 + j0 + u;
        const float sc = masked_score(s[u], scale, qpos, kpos, masked, window);
        const float p = j0 + u < n_k ? expf(sc - lse_r) : 0.f;
        const float ds = p * (dp[u] - dta_r) * scale;
        axpy16<TPR>(round_to<T>(ds), ks + (j0 + u) * D, acc, part);
      }
    }
  }
  if (row_ok) store16<T, TPR>(dq + qrow * D, acc, part);
}

// K3b (FUSED = false) and K4 (FUSED = true), f32 operands ------------ //
template <int D, bool FUSED>
struct KvTile {
  static constexpr int kBK = BwdTile<D>::kRows;  // keys per block
  // query rows per staged tile: K4 also stages k and the rounded dS
  static constexpr int kBQ = FUSED ? (D >= 128 ? 16 : 32)
                                   : (D >= 128 ? 32 : 64);
};

template <int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel_f32(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            float* __restrict__ dq_acc, int q_len,
                            int k_len, float scale, bool masked, int window,
                            bool vec) {
  using T = float;
  constexpr int TPR = BwdTile<D>::kTPR;
  constexpr int BK = KvTile<D, FUSED>::kBK;
  constexpr int BQ = KvTile<D, FUSED>::kBQ;
  __shared__ __align__(16) float qs[BQ * D];
  __shared__ __align__(16) float dos[BQ * D];
  __shared__ float lse_s[BQ];
  __shared__ float dta_s[BQ];
  // K4 only: the key tile (f32) and the query tile's rounded dS [BQ, BK]
  __shared__ __align__(16) float ks[FUSED ? BK * D : 1];
  __shared__ float dss[FUSED ? BQ * BK : 1];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int r = tid / TPR;
  const int kpos = k0 + r;
  const bool row_ok = kpos < k_len;
  const int64_t krow = static_cast<int64_t>(bh) * k_len + (row_ok ? kpos : 0);
  const int n_k = min(BK, k_len - k0);
  float kr[16], vr[16], dk_acc[16], dv_acc[16];
  load16<T, TPR>(k + krow * D, row_ok, kr, part);
  load16<T, TPR>(v + krow * D, row_ok, vr, part);
#pragma unroll
  for (int i = 0; i < 16; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if constexpr (FUSED)
    stage_f32<T, kThreads>(k + (static_cast<int64_t>(bh) * k_len + k0) * D,
                           ks, BK * D, n_k * D, vec, tid);

  const int2 qts = query_tiles<BQ>(k0, n_k, q_len, k_len, masked, window);
  const int64_t qbase = static_cast<int64_t>(bh) * q_len;

  for (int qt = qts.x; qt < qts.y; ++qt) {
    const int q0 = qt * BQ;
    const int n_q = min(BQ, q_len - q0);
    __syncthreads();  // the previous tile (and its dS) is fully consumed
    stage_f32<T, kThreads>(q + (qbase + q0) * D, qs, BQ * D, n_q * D, vec,
                           tid);
    stage_f32<T, kThreads>(dout + (qbase + q0) * D, dos, BQ * D, n_q * D,
                           vec, tid);
    for (int i = tid; i < BQ; i += kThreads) {
      lse_s[i] = i < n_q ? lse[qbase + q0 + i] : 0.f;
      dta_s[i] = i < n_q ? delta[qbase + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int i0 = 0; i0 < n_q; i0 += kStep) {  // block-uniform bound
      float s[kStep], dp[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        s[u] = dot16<TPR>(qs + (i0 + u) * D, kr, part);
        dp[u] = dot16<TPR>(dos + (i0 + u) * D, vr, part);
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        s[u] = row_sum<TPR>(s[u]);
        dp[u] = row_sum<TPR>(dp[u]);
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int i = i0 + u;
        const float sc = masked_score(s[u], scale, q0 + i, kpos, masked,
                                      window);
        const float p = (i < n_q && row_ok) ? expf(sc - lse_s[i]) : 0.f;
        const float ds = p * (dp[u] - dta_s[i]) * scale;
        const float dsr = round_to<T>(ds);
        axpy16<TPR>(round_to<T>(p), dos + i * D, dv_acc, part);
        axpy16<TPR>(dsr, qs + i * D, dk_acc, part);
        if constexpr (FUSED) {
          if (part == 0) dss[i * BK + r] = dsr;
        }
      }
    }
    if constexpr (FUSED) {
      __syncthreads();  // every key's dS of this query tile is staged
      // dq[q0 + i, d] += sum over this block's keys of dS[i, j] k[j, d]
      constexpr int RG = kThreads / D;  // query rows handled at once
      const int d = tid % D;
      for (int i = tid / D; i < n_q; i += RG) {
        float a = 0.f;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a = fmaf(dss[i * BK + j], ks[j * D + d], a);
        atomicAdd(dq_acc + (qbase + q0 + i) * D + d, a);
      }
    }
  }
  if (row_ok) {
    store16<T, TPR>(dk + krow * D, dk_acc, part);
    store16<T, TPR>(dv + krow * D, dv_acc, part);
  }
}

// K3b (FUSED = false) and K4 (FUSED = true), bf16 / f16 operands on the
// tensor cores ---------------------------------------------------------- //
constexpr int kTcBK = 128;  // keys a block: one warpgroup per 64
constexpr int kTcBQ = 64;   // queries a staged tile

// dynamic shared memory, byte offsets from a 1024-byte aligned base
template <int D, bool FUSED>
struct TcSmem {
  static constexpr int kTileK = kTcBK * D * 2;  // a [128, D] 16-bit tile
  static constexpr int kTileQ = kTcBQ * D * 2;  // a [64, D] one
  static constexpr int kK = 0;
  static constexpr int kV = kTileK;
  static constexpr int kQ = 2 * kTileK;           // two stages
  static constexpr int kDO = kQ + 2 * kTileQ;     // two stages
  static constexpr int kDS = kDO + 2 * kTileQ;    // K4: dS^T [128, 64]
  static constexpr int kLse = kDS + (FUSED ? kTcBK * kTcBQ * 2 : 0);
  static constexpr int kDelta = kLse + 2 * kTcBQ * 4;  // two stages each
  static constexpr int kBytes = kDelta + 2 * kTcBQ * 4;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kv_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ dq_acc, int q_len, int k_len,
                           float scale, bool masked, int window, bool vec) {
  using L = TcSmem<D, FUSED>;
  constexpr int BK = kTcBK, BQ = kTcBQ;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = align_smem(smem_raw);
  const uint32_t base = smem_u32(smem);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int wg = tid / 128;         // warpgroup: keys k0 + 64 wg ...
  const int warp = (tid / 32) % 4;  // warp in the warpgroup
  const int gid = (tid % 32) / 4, tig = tid % 4;
  // this thread's two key rows of every [64 keys, N] accumulator, from k0
  const int krow = wg * 64 + warp * 16 + gid;
  const int n_k = min(BK, k_len - k0);
  const int64_t kbase = static_cast<int64_t>(bh) * k_len + k0;
  const int64_t qbase = static_cast<int64_t>(bh) * q_len;
  const uint16_t* q16 = reinterpret_cast<const uint16_t*>(q);
  const uint16_t* do16 = reinterpret_cast<const uint16_t*>(dout);

  const int2 qts = query_tiles<BQ>(k0, n_k, q_len, k_len, masked, window);
  const int qt_begin = qts.x, qt_end = qts.y;

  // stage query tile qt (q, dO, lse, delta) into ring slot st
  auto load_q = [&](int qt, int st) {
    const int q0 = qt * BQ;
    const int n_q = min(BQ, q_len - q0);
    load_tile<BQ, D, kThreads>(smem + L::kQ + st * L::kTileQ,
                               q16 + (qbase + q0) * D, n_q, vec, tid);
    load_tile<BQ, D, kThreads>(smem + L::kDO + st * L::kTileQ,
                               do16 + (qbase + q0) * D, n_q, vec, tid);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const float* src =
          (tid < BQ ? lse : delta) + qbase + q0 + min(i, n_q - 1);
      cp_async4(base + (tid < BQ ? L::kLse : L::kDelta) + (st * BQ + i) * 4,
                src, i < n_q ? 4 : 0);
    }
  };

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (qt_begin < qt_end) {
    load_tile<BK, D, kThreads>(
        smem + L::kK, reinterpret_cast<const uint16_t*>(k) + kbase * D, n_k,
        vec, tid);
    load_tile<BK, D, kThreads>(
        smem + L::kV, reinterpret_cast<const uint16_t*>(v) + kbase * D, n_k,
        vec, tid);
    load_q(qt_begin, 0);
    cp_async_commit();
  }
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
  const float* dta_s = reinterpret_cast<const float*>(smem + L::kDelta);
  // this warpgroup's 64 rows of the key and value tiles (K-major A)
  const uint32_t k_wg = base + L::kK + wg * 64 * 128;
  const uint32_t v_wg = base + L::kV + wg * 64 * 128;

  for (int qt = qt_begin, st = 0; qt < qt_end; ++qt, st ^= 1) {
    const int q0 = qt * BQ;
    cp_async_wait<0>();  // this thread's copies of tile qt have landed
    fence_proxy_async();
    __syncthreads();     // everyone's have; slot st ^ 1 (and dS^T) is free
    if (qt + 1 < qt_end) {  // the next tile's copy overlaps this one's work
      load_q(qt + 1, st ^ 1);
      cp_async_commit();
    }
    const uint32_t q_s = base + L::kQ + st * L::kTileQ;
    const uint32_t do_s = base + L::kDO + st * L::kTileQ;

    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 64 keys and the
    // tile's 64 queries; K-major A and B, D / 16 steps of 16
    float s[32], dp[32];
    wg_fence();
    gmma_abt<T, D, BK, BQ>(s, k_wg, q_s);
    wg_commit();
    gmma_abt<T, D, BK, BQ>(dp, v_wg, do_s);
    wg_commit();
    wg_wait<1>();  // S^T is in; dP^T may still run
    fence_regs(s);
    // P = exp(mask(S * scale) - lse), 0 for keys past k_len and queries
    // past q_len
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = krow + (i & 2) * 4;
      const int col = 8 * (i / 4) + 2 * tig + (i & 1);
      const int kpos = k0 + row, qpos = q0 + col;
      const float sc = masked_score(s[i], scale, qpos, kpos, masked, window);
      s[i] = (kpos < k_len && qpos < q_len)
                 ? expf(sc - lse_s[st * BQ + col])
                 : 0.f;
    }
    wg_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta) scale; P and dS rounded to T as A fragments:
    // pair m holds accumulators 2m, 2m + 1, so k-step kk takes 4kk..4kk+3
    uint32_t pf[16], dsf[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int col = 8 * (m / 2) + 2 * tig;
      const float d0 = s[2 * m] * (dp[2 * m] - dta_s[st * BQ + col]) * scale;
      const float d1 =
          s[2 * m + 1] * (dp[2 * m + 1] - dta_s[st * BQ + col + 1]) * scale;
      pf[m] = pack2<T>(s[2 * m], s[2 * m + 1]);
      dsf[m] = pack2<T>(d0, d1);
    }

    // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major
    wg_fence();
    gmma_rs_mn<T, D, BQ>(dv_acc, pf, do_s);
    gmma_rs_mn<T, D, BQ>(dk_acc, dsf, q_s);
    wg_commit();

    if constexpr (FUSED) {
      // dS^T [128 keys, 64 queries] to shared memory, swizzled
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int row = krow + (m & 1) * 8;
        *reinterpret_cast<uint32_t*>(smem + L::kDS + row * 128 +
                                     (((m / 2) ^ (row & 7)) << 4) +
                                     4 * tig) = dsf[m];
      }
      fence_proxy_async();
      __syncthreads();  // both warpgroups' dS rows are in
      // dQ[64 queries, this warpgroup's D / 2 dims] = dS K over the 128
      // keys: A = dS^T read MN-major, B = the key tile read MN-major
      float dq[D / 4];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
      const uint32_t k_cols = D == 64 ? base + L::kK + wg * 64
                                      : base + L::kK + wg * (BK * 128);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Gmma<T, D / 2>::template ss<1, 1>(
            dq, gmma_desc(base + L::kDS + kk * 2048, BK * 128, 1024),
            gmma_desc(k_cols + kk * 2048, BK * 128, 1024), kk);
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      // one atomic add per (query, dim) per key tile
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const int row = warp * 16 + gid + (i & 2) * 4;
        const int col = wg * (D / 2) + 8 * (i / 4) + 2 * tig + (i & 1);
        if (q0 + row < q_len)
          atomicAdd(dq_acc + (qbase + q0 + row) * D + col, dq[i]);
      }
    }
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pf);
    fence_regs(dsf);
  }

  // dK and dV rounded to T once, two neighbouring columns a store
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = krow + (i & 2) * 4;
    const int col = 8 * (i / 4) + 2 * tig;
    if (row < n_k) {
      const int64_t at = (kbase + row) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack2<T>(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack2<T>(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// K3a, bf16 / f16 operands on the tensor cores ------------------------- //
template <typename T, int D>
__global__ void __launch_bounds__(kWarpgroup)
    flash_bwd_dq_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int q_len, int k_len,
                           float scale, bool masked, int window, bool vec) {
  using L = RingSmem<D, 2>;  // q, dO
  constexpr int BQ = kRingRows, BK = kRingRows;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = align_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + L::kTile;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int tid = threadIdx.x;
  const int warp = tid / 32, gid = (tid % 32) / 4, tig = tid % 4;
  // this thread's rows r0 and r0 + 8 of every [64 queries, N] accumulator
  const int r0 = warp * 16 + gid;
  const int n_q = min(BQ, q_len - q0);
  const int64_t qbase = static_cast<int64_t>(bh) * q_len + q0;
  const int64_t kvbase = static_cast<int64_t>(bh) * k_len * D;

  load_tile<BQ, D, kWarpgroup>(
      smem, reinterpret_cast<const uint16_t*>(q) + qbase * D, n_q, vec, tid);
  load_tile<BQ, D, kWarpgroup>(
      smem + L::kTile, reinterpret_cast<const uint16_t*>(dout) + qbase * D,
      n_q, vec, tid);

  // lse and delta of rows r0, r0 + 8 (0 past q_len)
  float lse_r[2], dta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse_r[h] = row < n_q ? lse[qbase + row] : 0.f;
    dta_r[h] = row < n_q ? delta[qbase + row] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  walk_key_tiles<D, 2>(
      smem, reinterpret_cast<const uint16_t*>(k) + kvbase,
      reinterpret_cast<const uint16_t*>(v) + kvbase, k_len,
      key_tiles<BK>(q0, n_q, k_len, masked, window), vec, tid,
      [&](int k0, uint32_t k_s, uint32_t v_s) {
        // S = Q K^T and dP = dO V^T over the tile's 64 queries and 64
        // keys, committed as two groups
        float s[32], dp[32];
        wg_fence();
        gmma_abt<T, D, BQ, BK>(s, q_s, k_s);
        wg_commit();
        gmma_abt<T, D, BQ, BK>(dp, do_s, v_s);
        wg_commit();
        wg_wait<1>();  // S is in; dP may still run
        fence_regs(s);
        // P = exp(mask(S * scale) - lse), 0 for keys past k_len and
        // queries past q_len
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = r0 + (i & 2) * 4;
          const int kpos = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
          const float sc =
              masked_score(s[i], scale, q0 + row, kpos, masked, window);
          s[i] = (kpos < k_len && row < n_q)
                     ? expf(sc - lse_r[(i >> 1) & 1])
                     : 0.f;
        }
        wg_wait<0>();
        fence_regs(dp);
        // dS = P (dP - delta) scale, rounded to T as A fragments: pair j
        // holds accumulators 2j, 2j + 1 (row half j % 2), so k-step kk
        // takes pairs 4kk .. 4kk + 3
        uint32_t dsf[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float d0 = s[2 * j] * (dp[2 * j] - dta_r[j & 1]) * scale;
          const float d1 =
              s[2 * j + 1] * (dp[2 * j + 1] - dta_r[j & 1]) * scale;
          dsf[j] = pack2<T>(d0, d1);
        }

        // dQ += round(dS) K: A from registers, B = the key tile MN-major
        wg_fence();
        gmma_rs_mn<T, D, BK>(dq_acc, dsf, k_s);
        wg_commit();
        wg_wait<0>();
        fence_regs(dq_acc);
        fence_regs(dsf);
      });

  // dQ rounded to T once
  const float one[2] = {1.f, 1.f};
  store_acc_rows<T, D>(dq + qbase * D, dq_acc, one, r0, tig, n_q);
}

// launch `Kernel<T, D>` for the runtime dtype code and head dim
template <template <typename, int> class Launch, typename... Args>
int dispatch(int dtype, int d, Args... args) {
  switch (dtype) {
    case kF32:
      return d == 64    ? Launch<float, 64>::run(args...)
             : d == 128 ? Launch<float, 128>::run(args...)
                        : static_cast<int>(cudaErrorInvalidValue);
    case kBF16:
      return d == 64    ? Launch<__nv_bfloat16, 64>::run(args...)
             : d == 128 ? Launch<__nv_bfloat16, 128>::run(args...)
                        : static_cast<int>(cudaErrorInvalidValue);
    case kF16:
      return d == 64    ? Launch<__half, 64>::run(args...)
             : d == 128 ? Launch<__half, 128>::run(args...)
                        : static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
struct LaunchDq {
  static int run(const void* q, const void* k, const void* v, const void* dO,
                 const void* lse, const void* delta, void* dq, int bh,
                 int q_len, int k_len, float scale, bool masked, int window,
                 cudaStream_t s) {
    // the route is the dtype: f32 takes the scalar body, bf16 / f16 the
    // tensor cores
    if constexpr (std::is_same<T, float>::value) {
      constexpr int BQ = BwdTile<D>::kRows;
      const bool vec = aligned16(k) && aligned16(v);
      const dim3 grid(bh, (q_len + BQ - 1) / BQ);
      if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
      flash_bwd_dq_kernel_f32<D><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dO),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), q_len, k_len, scale, masked, window, vec);
    } else {
      constexpr int kSmem = RingSmem<D, 2>::kAlloc;
      // above 48 KB a block's dynamic shared memory must be allowed
      // first: once per instantiation
      static const cudaError_t allowed = cudaFuncSetAttribute(
          flash_bwd_dq_kernel_tc<T, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (allowed != cudaSuccess) return static_cast<int>(allowed);
      const bool vec = aligned16(q) && aligned16(dO) && aligned16(k) &&
                       aligned16(v);
      const dim3 grid(bh, (q_len + kRingRows - 1) / kRingRows);
      if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
      flash_bwd_dq_kernel_tc<T, D><<<grid, kWarpgroup, kSmem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dO),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), q_len, k_len, scale, masked, window, vec);
    }
    return 0;
  }
};

template <bool FUSED>
struct LaunchKv {
  template <typename T, int D>
  struct At {
    static int run(const void* q, const void* k, const void* v,
                   const void* dO, const void* lse, const void* delta,
                   void* dq_acc, void* dk, void* dv, int bh, int q_len,
                   int k_len, float scale, bool masked, int window,
                   cudaStream_t s) {
      // the route is the dtype: f32 takes the scalar body, bf16 / f16
      // the tensor cores
      if constexpr (std::is_same<T, float>::value) {
        constexpr int BK = KvTile<D, FUSED>::kBK;
        const bool vec = aligned16(q) && aligned16(dO) && aligned16(k);
        const dim3 grid(bh, (k_len + BK - 1) / BK);
        if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
        flash_bwd_kv_kernel_f32<D, FUSED><<<grid, kThreads, 0, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dO),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<T*>(dk), static_cast<T*>(dv),
            static_cast<float*>(dq_acc), q_len, k_len, scale, masked, window,
            vec);
      } else {
        constexpr int kSmem = TcSmem<D, FUSED>::kAlloc;
        // above 48 KB a block's dynamic shared memory must be allowed
        // first: once per instantiation
        static const cudaError_t allowed = cudaFuncSetAttribute(
            flash_bwd_kv_kernel_tc<T, D, FUSED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
        if (allowed != cudaSuccess) return static_cast<int>(allowed);
        const bool vec = aligned16(q) && aligned16(dO) && aligned16(k) &&
                         aligned16(v);
        const dim3 grid(bh, (k_len + kTcBK - 1) / kTcBK);
        if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
        flash_bwd_kv_kernel_tc<T, D, FUSED><<<grid, kThreads, kSmem, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dO),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<T*>(dk), static_cast<T*>(dv),
            static_cast<float*>(dq_acc), q_len, k_len, scale, masked, window,
            vec);
      }
      return 0;
    }
  };
};

int finish(int err) {
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int bh, int q_len, int k_len) {
  return bh <= 0 || q_len <= 0 || k_len <= 0;
}

}  // namespace

// All operands contiguous: q, dO [bh, q_len, d] and k, v [bh, k_len, d] in
// `dtype` (the RlaDtype code), lse and delta [bh, q_len] f32; outputs in
// the inputs' dtype, of the inputs' shapes.  causal != 0 masks keys past
// the query (top-left aligned); window > 0 also masks keys `window` or
// more positions back (and implies the causal mask).  d is 64 or 128.
// Each returns cudaGetLastError() after its launch.

// K3a: dq.
extern "C" int rla_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int bh,
                                int q_len, int k_len, int d, float scale,
                                int causal, int window, int dtype,
                                void* stream) {
  if (bad_sizes(bh, q_len, k_len)) return static_cast<int>(cudaErrorInvalidValue);
  return finish(dispatch<LaunchDq>(
      dtype, d, q, k, v, dO, lse, delta, dq, bh, q_len, k_len, scale,
      causal != 0 || window > 0, window, static_cast<cudaStream_t>(stream)));
}

// K3b: dk and dv.
extern "C" int rla_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int q_len, int k_len, int d,
                                 float scale, int causal, int window,
                                 int dtype, void* stream) {
  if (bad_sizes(bh, q_len, k_len)) return static_cast<int>(cudaErrorInvalidValue);
  return finish(dispatch<LaunchKv<false>::At>(
      dtype, d, q, k, v, dO, lse, delta, static_cast<void*>(nullptr), dk, dv,
      bh, q_len, k_len, scale, causal != 0 || window > 0, window,
      static_cast<cudaStream_t>(stream)));
}

// K4: dk and dv, and dq added into dq_acc ([bh, q_len, d] f32, zeroed by
// the caller).
extern "C" int rla_flash_bwd_fused(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const void* lse, const void* delta,
                                   void* dq_acc, void* dk, void* dv, int bh,
                                   int q_len, int k_len, int d, float scale,
                                   int causal, int window, int dtype,
                                   void* stream) {
  if (bad_sizes(bh, q_len, k_len)) return static_cast<int>(cudaErrorInvalidValue);
  return finish(dispatch<LaunchKv<true>::At>(
      dtype, d, q, k, v, dO, lse, delta, dq_acc, dk, dv, bh, q_len, k_len,
      scale, causal != 0 || window > 0, window,
      static_cast<cudaStream_t>(stream)));
}
