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
// A row whose processed keys are all masked gets p = 1 for each of them
// and is wiped by alpha = 0 once a real key arrives; a row that sees no
// key at all (a window, q >= k_len + window - 1) walks every key tile and
// gets the mean of v, as the plain softmax over its -1e30 scores does.
//
// What bounds it on an H100: at the GPT training shape ([192, 1024, 64]
// bf16, causal) it reads q, k, v and writes out once, 100.7 MB, or 30 us
// at 3.35 TB/s, against two products over the 525k (query, key) pairs
// each (b, h) keeps, 25.8 GFLOP, 26 us on the bf16 tensor cores (989
// TFLOP/s): memory-bound by its bytes, barely.  At generate()'s prefill
// ([192, 128, 64]) it is 12.6 MB (3.8 us) against 0.4 GFLOP.  On the f32
// CUDA cores (67 TFLOP/s) the training shape's products take at least
// 385 us.
//
// Routes, by dtype: bf16 and f16 operands take the tensor-core body
// `flash_fwd_kernel_tc`; f32 operands take the scalar body
// `flash_fwd_kernel_f32` (TF32 would miss the f32 checks' 1e-4).  A CUDA
// tensor of a dtype launches its body or the wrapper raises; nothing
// retries another body.
//
// `flash_fwd_kernel_tc<T, D>`: one warpgroup (128 threads) per (bh,
//   64-query tile), the query tiles launched heaviest first (reverse
//   blockIdx.y) so the causal tail does not straggle.
//   - staging: the query tile once, then the key and value tiles of 64
//     keys the mask needs (`key_tiles`) through the two-stage cp.async
//     ring `walk_key_tiles` of wgmma.cuh, shared with K3a (16-byte
//     copies, zero-filled past q_len / k_len; the next tile's copy in
//     flight while this one's products run), 16-bit tiles as they are in
//     the 128-byte swizzled layout.  Operands not 16-byte aligned are
//     staged by element loads into the same layout.
//   - S = Q K^T (`gmma_abt`): wgmma m64n64k16, both operands K-major from
//     shared memory, into f32 accumulators; scale and mask in the
//     registers (the mask only on tiles that cross the diagonal, the
//     window edge or a ragged tail).
//   - the online softmax per tile: each thread holds 16 scores of two
//     rows, the row max is taken over the four lanes of a quad (two xor
//     shuffles), the accumulators are rescaled by alpha, and each thread
//     keeps a partial row sum, added over the quad once at the end.
//   - O += round(P) V (`gmma_rs_mn`): wgmma with A from registers (P
//     rounded to T by pack2, the TPU kernel's cast) and B = the value
//     tile read MN-major.
//   - output: out = acc / l rounded to T once, two columns a store, and
//     lse once a row.  No atomics: deterministic.
//   Products are bf16 x bf16 (or f16) exact into f32, so the result
//   differs from the plain version by summation order only.
//   Measured (-Xptxas -v, chip_smoke.py phase 1): 128 registers at D = 64
//   and 168 at D = 128, no spills; dynamic shared memory
//   RingSmem<D, 1>::kAlloc, 41 KB at D = 64 and 81 KB at D = 128.  On an
//   NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 2b, PERF.md):
//   138.39 us at the training shape, 186 TFLOP/s or 0.22 of the bound
//   (SDPA 86.62 us), against a mean of ~1207 us a call for the scalar body
//   it replaces (a profiled training step); 15.20 us at generate()'s
//   prefill (SDPA 16.45, the scalar body 48.23).
//
// `flash_fwd_kernel_f32<D>`: one block of 128 threads per (bh, 64-row
// query tile); two threads per query row, each holding half of the row's
// q and of its f32 output accumulator in registers (interleaved 4-float
// chunks, so the pair's 16-byte shared-memory reads fall on neighbouring
// banks).  The block walks the key tiles in order (64 keys at D = 64, 32
// at D = 128, so both stage 32 KB), staging k and v in shared memory with
// 16-byte loads where the pointers allow; each thread computes its
// half-dots, the pair adds them with one shuffle, and both keep identical
// running max and sum.  The online softmax steps 16 keys at a time (a
// rolled loop over the staged tile), which keeps the scores in registers
// without unrolling the whole tile.  No atomics: every output element is
// written once by one thread (deterministic).

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBlockQ = 64;             // query rows per block
static_assert(kBlockQ == kRingRows, "both bodies launch the same grid");
constexpr float kMasked = -1e30f;       // the TPU kernel's _NEG_INF

// f32 operands on the CUDA cores ---------------------------------------- //
constexpr int kThreads = 2 * kBlockQ;   // two threads per query row
constexpr int kSub = 16;                // keys per online-softmax step

template <int D>
struct FlashTile {
  static constexpr int kBlockK = D >= 128 ? 32 : 64;  // keys per tile
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel_f32(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int q_len, int k_len,
                         float scale, bool masked, int window, bool vec) {
  using T = float;
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

  const int2 kts =
      key_tiles<BK>(q0, min(kBlockQ, q_len - q0), k_len, masked, window);
  for (int kt = kts.x; kt < kts.y; ++kt) {
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
        // p in v's dtype before the PV product (the identity in f32)
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

// bf16 / f16 operands on the tensor cores ------------------------------- //
template <typename T, int D>
__global__ void __launch_bounds__(kWarpgroup)
    flash_fwd_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int q_len, int k_len,
                        float scale, bool masked, int window, bool vec) {
  constexpr int BQ = kRingRows, BK = kRingRows;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = align_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);  // the query tile, at offset 0

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

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  // running max of rows r0, r0 + 8, and this thread's part of their sums
  float m_r[2] = {kMasked, kMasked}, l_r[2] = {0.f, 0.f};

  walk_key_tiles<D, 1>(
      smem, reinterpret_cast<const uint16_t*>(k) + kvbase,
      reinterpret_cast<const uint16_t*>(v) + kvbase, k_len,
      key_tiles<BK>(q0, n_q, k_len, masked, window), vec, tid,
      [&](int k0, uint32_t k_s, uint32_t v_s) {
        // S = Q K^T over the tile's 64 queries and 64 keys
        float s[32];
        wg_fence();
        gmma_abt<T, D, BQ, BK>(s, q_s, k_s);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);

        // scale, mask (only where the tile crosses the diagonal, the
        // window edge or the ragged key tail) and the row max over the
        // quad
        const bool edge =
            k0 + BK > k_len ||
            (masked && (k0 + BK - 1 > q0 ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window)));
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float sc = s[i] * scale;
          if (edge) {
            const int qpos = q0 + r0 + (i & 2) * 4;
            const int kpos = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
            if (kpos >= k_len) {
              sc = -INFINITY;  // out of range: excluded from max, sum, PV
            } else if (masked && (kpos > qpos ||
                                  (window > 0 && qpos - kpos >= window))) {
              sc = kMasked;
            }
          }
          s[i] = sc;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc);
        }
        // the tile holds >= 1 in-range key, so the max >= -1e30 is finite
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m_r[h], mx[h]);
          alpha[h] = expf(m_r[h] - m_new);
          m_r[h] = m_new;
        }
        // p = exp(s - m), summed unrounded; rounded to T as A fragments:
        // pair j holds accumulators 2j, 2j + 1 (row half j % 2), so k-step
        // kk takes pairs 4kk .. 4kk + 3
        uint32_t pf[16];
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float p0 = expf(s[2 * j] - m_r[j & 1]);
          const float p1 = expf(s[2 * j + 1] - m_r[j & 1]);
          ps[j & 1] += p0 + p1;
          pf[j] = pack2<T>(p0, p1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l_r[h] = alpha[h] * l_r[h] + ps[h];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

        // O += round(P) V: A from registers, B = the value tile MN-major
        wg_fence();
        gmma_rs_mn<T, D, BK>(o_acc, pf, v_s);
        wg_commit();
        wg_wait<0>();
        fence_regs(o_acc);
        fence_regs(pf);
      });

  // the row sums over the quad; out = acc / l rounded to T once; lse once
  // a row
  float lf[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h] + __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lf[h] = l == 0.f ? 1.f : l;
  }
  store_acc_rows<T, D>(o + qbase * D, o_acc, lf, r0, tig, n_q);
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < n_q) lse[qbase + r0 + 8 * h] = m_r[h] + logf(lf[h]);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int q_len, int k_len, float scale,
                 bool masked, int window, cudaStream_t stream) {
  const dim3 grid(bh, (q_len + kBlockQ - 1) / kBlockQ);
  // the route is the dtype: f32 takes the scalar body, bf16 / f16 the
  // tensor cores
  if constexpr (std::is_same<T, float>::value) {
    const bool vec = aligned16(k) && aligned16(v);
    flash_fwd_kernel_f32<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), q_len, k_len, scale, masked, window, vec);
  } else {
    constexpr int kSmem = RingSmem<D, 1>::kAlloc;
    // above 48 KB a block's dynamic shared memory must be allowed first:
    // once per instantiation
    static const cudaError_t allowed = cudaFuncSetAttribute(
        flash_fwd_kernel_tc<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const bool vec = aligned16(q) && aligned16(k) && aligned16(v);
    flash_fwd_kernel_tc<T, D><<<grid, kWarpgroup, kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), q_len, k_len, scale, masked, window, vec);
  }
  return 0;
}

template <typename T>
int launch_for_dim(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int q_len, int k_len, int d,
                   float scale, bool masked, int window,
                   cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_flash<T, 64>(q, k, v, o, lse, bh, q_len, k_len, scale,
                                 masked, window, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, lse, bh, q_len, k_len, scale,
                                  masked, window, stream);
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
