// int8 weight-only matrix products for Hopper (sm_90a).
//
// Two entry points, matching ops/quant.py.  Both compute the TPU kernels'
// function exactly: w widened to x's dtype (exact: every int8 fits the
// 8-bit significand of bf16 and the 11 bits of f16), exact products, f32
// sums, and one cast to x's dtype at the end.  The route is x's dtype:
// bf16 and f16 run on the tensor cores (`*_tc` bodies, mma.sync m16n8k16
// with f32 accumulators), f32 on the CUDA cores (`*_f32` bodies: TF32
// tensor cores would round x to 10 bits).  There is no fallback.
//
// Both tensor-core bodies give a thread the 8 k of a 32-k chunk that its
// mma slots take as one contiguous run (see mma_chunk), so x is read 16
// bytes a row and a K6 weight row 8 bytes, and interleave the output
// columns (mma tile j column g is column 4g + j of a warp's 32), so a
// thread's accumulators are 8 neighbouring columns.
//
// rla_int8_matmul: out[M,N] = x[M,K] @ (w[K,N] int8 * scale[N]).
//   Replaces the TPU kernel `_mm_kernel` (the JAX package's
//   ops/quant.py:55, launched by `int8_matmul` :150).
//   What bounds it: at decode (M = live slots, 16) each weight byte takes
//   part in 2*M flops, so the bound is the int8 weight's stream from
//   device memory (0.59 MB to 2.4 MB a projection of the GPT-2-small
//   class model: 0.19-0.75 us at 3.35 TB/s), far below the ~5 us a
//   launch costs; what the design can cut is launches and dependent
//   trips: memory, then barriers.  At N = 768 a grid of column tiles
//   alone gives 12 blocks for 132 SMs.
//   Design (`int8_mm_kernel_tc<T, NM>`): a block of 4 warps owns 64 output
//   columns; a thread-block cluster of 1-8 blocks (ops/quant.py
//   `launch_plan`, the same for every M) splits K.  Each rank holds its
//   whole k range of the weight tile in shared memory: every 16-byte
//   cp.async is issued at the start, in four commit groups the warps
//   consume in order, so the weight crosses device memory once whatever
//   M is, and the block loops over the 16-row m tiles of x (up to 4 a
//   round in registers, x staged per round by 16-byte copies) against
//   it.  (This replaces the asked-for refilled ring: a rank's range is
//   6-24 KB at the serve shapes; a range wider than shared memory is
//   walked in segments.)  The B fragment wants pairs along k while w is
//   contiguous along N: a thread reads 4-byte column groups of 8 k rows
//   and transposes them in registers (`transpose4x4`).  The two warps of
//   a column half take alternate chunks; k half 1 hands its sums to k half
//   0, which pushes each row into the shared memory of the rank that
//   finishes it (distributed shared memory stores); after one cluster
//   barrier each rank sums its rows over the ranks in rank order (two
//   calls give the same bits), applies the column scale (loaded with the
//   first copies), casts once and stores.  One launch, no f32 scratch in
//   device memory.  (Pushing to the finishing ranks, rather than the
//   first rank pulling every partial, needs one cluster barrier instead
//   of two and spreads the sums over the ranks.)
//
// rla_int8_matmul_nt: out[M,N] = x[M,K] @ w[N,K]^T, int8, no scale (the
//   tied-embedding unembedding; the caller folds the contraction-dim
//   scales into x).  Replaces `_mm_nt_kernel` (quant.py:78, launched by
//   `int8_matmul_nt` :182).
//   What bounds it: the weight read, 38.6 MB at N = 50304, K = 768 -- the
//   largest single read of a decode step -- so >= 11.5 us at 3.35 TB/s;
//   widening 38.6 M int8 (2 instructions each) and the mma.sync products
//   take the SMs about as long, so they must overlap the stream.
//   Design (`int8_mm_nt_kernel_tc<T, NM, XRES>`): a persistent grid (SMs x
//   resident blocks, two an SM at M <= 16) of 8 warps walks 64-column
//   tiles of the whole K; the weight streams through a 4-stage cp.async
//   ring of 64 x 256-byte stages, the next tile's stages in flight while
//   this one's epilogue runs.  x is staged once a block (XRES; with every
//   stage when its rows do not fit beside the ring).  A warp takes one
//   column half and chunks kq, kq + 4 of each stage; the four chunk
//   groups of a tile are summed in chunk order through shared memory and
//   the output stored 16 bytes a thread.
//
// Registers (-Xptxas -v, nvcc 12.9; ops/_build.py build_logs()), bf16 /
// f16, no spills: K5 56 / 56 at NM = 1, 80 / 78 at 2, 128 / 121 at 4;
// K6 120-121 / 116-117 at 1, 126-127 at 2, 202-208 at 4; f32 bodies 96
// (K5) and 201 (K6).

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---- pieces shared by the tensor-core bodies ------------------------------
constexpr int kTcThreads = 128;  // 4 warps: 2 column halves x 2 k halves
constexpr int kTcCols = 64;      // output columns of a block tile, 32 a warp
constexpr int kChunk = 32;       // k of two m16n8k16 steps
constexpr int kPartPitch = 68;   // floats a row of a K5 block's partial
constexpr int kRedPitch = 36;    // floats a row of a K6 chunk group's sums
constexpr int kMaxSmem = 227 * 1024;

// bytes a shared row of `cols` 16-bit elements takes: >= 2 cols and 64
// more than a multiple of 128, so the 16-byte reads of rows g and g + 1
// fall in different banks
__host__ __device__ constexpr int x_pitch(int cols) {
  return (2 * cols + 63) / 128 * 128 + 64;
}

// d += a b, one m16n8k16 product, f32 accumulators, T operands
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b0,
                                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four int8 of w (byte 0 first) widened exactly to T: b0 holds bytes
// 0 and 1, b1 bytes 2 and 3, the lower byte in the lower half.  bf16: the
// halves 0x43mm (128 + m, m = byte & 127) minus 0x4300 or 0x4380 (128 or
// 256, by the byte's sign bit) give m - 128 s, the byte; f16: the halves
// 1024 + (byte + 128) minus 1152.  Both differences are exact.
template <typename T>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& b0,
                                       uint32_t& b1);
template <>
__device__ __forceinline__ void widen4<__nv_bfloat16>(uint32_t w,
                                                      uint32_t& b0,
                                                      uint32_t& b1) {
  const uint32_t mag = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(b0)
      : "r"(__byte_perm(mag, 0x43434343u, 0x4140)),
        "r"(__byte_perm(sgn, 0x43434343u, 0x4140)));
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(b1)
      : "r"(__byte_perm(mag, 0x43434343u, 0x4342)),
        "r"(__byte_perm(sgn, 0x43434343u, 0x4342)));
}
template <>
__device__ __forceinline__ void widen4<__half>(uint32_t w, uint32_t& b0,
                                               uint32_t& b1) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t lo = __byte_perm(u, 0x64646464u, 0x4140);
  const uint32_t hi = __byte_perm(u, 0x64646464u, 0x4342);
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(b0) : "r"(lo), "r"(0x64806480u));
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(b1) : "r"(hi), "r"(0x64806480u));
}

// rows a, b, c, d of 4 bytes each -> column j as word j, row a in byte 0
__device__ __forceinline__ void transpose4x4(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d,
                                             uint32_t (&col)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  col[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  col[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  col[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// The k order both bodies use inside a 32-k chunk: the thread with quad
// index t (lane % 4) owns k = 8t .. 8t + 7, k = 8t + 4s + {0, 1} in the
// b0 / a0 slots of step s and 8t + 4s + {2, 3} in b1 / a2.  The sum is
// the same whatever k sits in which slot, and this order lets a thread
// read its 8 k of x and of a K6 weight row as one contiguous run.
//
// acc[mt][j] += x rows (m tile mt) @ B(j) over one chunk: xs points at the
// chunk's first column in a shared tile of x rows with `pitch` bytes a
// row; b[s][j] are the B fragments of step s, n tile j.  Only the first
// `nmt` m tiles are live.
template <typename T, int NM>
__device__ __forceinline__ void mma_chunk(float (&acc)[NM][4][4],
                                          const char* xs, int pitch,
                                          int nmt,
                                          const uint32_t (&b)[2][4][2],
                                          int g, int t) {
#pragma unroll
  for (int mt = 0; mt < NM; ++mt) {
    if (mt >= nmt) break;  // warp-uniform
    const char* r = xs + (mt * 16 + g) * pitch + t * 16;
    const uint4 lo = *reinterpret_cast<const uint4*>(r);
    const uint4 hi = *reinterpret_cast<const uint4*>(r + 8 * pitch);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma16816<T>(acc[mt][j], lo.x, hi.x, lo.y, hi.y, b[0][j][0], b[0][j][1]);
      mma16816<T>(acc[mt][j], lo.z, hi.z, lo.w, hi.w, b[1][j][0], b[1][j][1]);
    }
  }
}

// rows [r0, r0 + rows) x columns [k0, k0 + cols) of x ([M, K] row-major)
// into the shared tile xs (`pitch` bytes a row), zeros past M and past
// k_end; 16-byte cp.async when vec (x 16-byte aligned, K % 8 == 0), else
// element loads.  cols is a multiple of 32.
template <typename T, int NT>
__device__ __forceinline__ void stage_x(char* xs, int pitch, const T* x,
                                        int r0, int rows, int k0, int cols,
                                        int M, int K, int k_end, bool vec,
                                        int tid) {
  const int per_row = cols / 8;  // 16-byte pieces a row
  for (int i = tid; i < rows * per_row; i += NT) {
    const int r = i / per_row, c = i % per_row;
    const int gm = r0 + r, gk = k0 + 8 * c;
    char* dst = xs + r * pitch + 16 * c;
    if (vec) {
      const bool ok = gm < M && gk < k_end;
      cp_async16(smem_u32(dst),
                 x + (ok ? static_cast<int64_t>(gm) * K + gk : 0),
                 ok ? 16 : 0);
    } else {
      __align__(16) uint16_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = gm < M && gk + e < k_end;
        const T val =
            ok ? x[static_cast<int64_t>(gm) * K + gk + e] : from_f32<T>(0.f);
        v[e] = *reinterpret_cast<const uint16_t*>(&val);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ---- cluster helpers (K5) --------------------------------------------------
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the shared::cluster address of the local shared address `addr` in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float a, float b,
                                            float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// NV (4 or 8) neighbouring outputs of one row: v * scale (when given),
// cast to T once; one NV * 2-byte store when vec (N % NV == 0, out
// aligned), else per element up to N.
template <typename T, int NV>
__device__ __forceinline__ void store_out(T* out, int64_t row_off, int n,
                                          int N, const float (&v)[NV],
                                          const float* scale, bool vec) {
  float s[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e)
    s[e] = scale != nullptr ? v[e] * scale[e] : v[e];
  if (vec) {
    uint32_t p[NV / 2];
#pragma unroll
    for (int e = 0; e < NV / 2; ++e) p[e] = pack2<T>(s[2 * e], s[2 * e + 1]);
    if constexpr (NV == 8)
      *reinterpret_cast<uint4*>(out + row_off + n) =
          make_uint4(p[0], p[1], p[2], p[3]);
    else
      *reinterpret_cast<uint2*>(out + row_off + n) = make_uint2(p[0], p[1]);
  } else {
#pragma unroll
    for (int e = 0; e < NV; ++e)
      if (n + e < N) out[row_off + n + e] = from_f32<T>(s[e]);
  }
}

// ---- int8_matmul (w [K, N]), tensor cores ---------------------------------
// a K5 block's dynamic shared memory: the weight tile of kseg k rows, x
// rows of one round (16 NM) over kseg columns, the partial tile of k half
// 1, the inbox of the rows this rank finishes (from every rank: at most
// 16 NM + 7 rows) and the tile's column scales
__host__ __device__ constexpr int k5_smem(int nm, int kseg) {
  return kseg * kTcCols + 16 * nm * x_pitch(kseg) +
         (2 * 16 * nm + 8) * kPartPitch * 4 + kTcCols * 4;
}

// byte offset of byte `col` (0..63) of k row r in the K5 weight tile: the
// 32-byte halves of rows with bit 3 set swap, so the four quads of a warp
// reading rows 8t + e fall on two bank groups instead of one
__device__ __forceinline__ int w5_off(int r, int col) {
  return r * kTcCols + (col ^ (((r >> 3) & 1) << 5));
}

template <typename T, int NM>
__global__ void __launch_bounds__(kTcThreads)
    int8_mm_kernel_tc(const T* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int M, int K, int N, int k_per_rank, int kseg, bool vx,
                      bool vw, bool vo) {
  extern __shared__ __align__(16) char smem[];
  char* ws = smem;
  char* xs = ws + kseg * kTcCols;
  const int xp = x_pitch(kseg);
  float* part = reinterpret_cast<float*>(xs + 16 * NM * xp);
  float* inbox = part + 16 * NM * kPartPitch;
  float* sc = inbox + (16 * NM + 8) * kPartPitch;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = warp & 1, khalf = warp >> 1;
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int n0 = blockIdx.y * kTcCols;
  const int k_begin = rank * k_per_rank;
  const int k_end = min(K, k_begin + k_per_rank);
  const int n_segs = (k_end - k_begin + kseg - 1) / kseg;
  if (tid < kTcCols) {  // the tile's scales, with the first copies
    const bool ok = n0 + tid < N;
    cp_async4(smem_u32(sc + tid), scale + (ok ? n0 + tid : 0), ok ? 4 : 0);
  }

  for (int r0 = 0; r0 < M; r0 += 16 * NM) {
    const int nmt = min(NM, (M - r0 + 15) / 16);
    float acc[NM][4][4];
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    for (int seg = 0; seg < n_segs; ++seg) {
      const int ks0 = k_begin + seg * kseg;
      const int klen = min(kseg, k_end - ks0);
      const int nch = (klen + kChunk - 1) / kChunk;
      const bool load_w = r0 == 0 || n_segs > 1;
      // four commit groups, a quarter of the chunks each
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c0 = q * nch / 4, c1 = (q + 1) * nch / 4;
        if (load_w) {
          const int rows = (c1 - c0) * kChunk;
          for (int i = tid; i < rows * 4; i += kTcThreads) {
            const int r = c0 * kChunk + i / 4, c16 = i % 4;
            const int gk = ks0 + r, gn = n0 + 16 * c16;
            char* dst = ws + w5_off(r, 16 * c16);
            if (vw) {
              const bool ok = gk < k_end && gn < N;
              cp_async16(smem_u32(dst),
                         w + (ok ? static_cast<int64_t>(gk) * N + gn : 0),
                         ok ? 16 : 0);
            } else {
              __align__(16) uint8_t v[16];
#pragma unroll
              for (int e = 0; e < 16; ++e)
                v[e] = gk < k_end && gn + e < N
                           ? static_cast<uint8_t>(
                                 w[static_cast<int64_t>(gk) * N + gn + e])
                           : 0;
              *reinterpret_cast<uint4*>(dst) =
                  *reinterpret_cast<const uint4*>(v);
            }
          }
        }
        stage_x<T, kTcThreads>(xs + c0 * kChunk * 2, xp, x, r0, 16 * NM,
                   ks0 + c0 * kChunk, (c1 - c0) * kChunk, M, K, k_end, vx,
                   tid);
        cp_async_commit();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q == 0) cp_async_wait<3>();
        if (q == 1) cp_async_wait<2>();
        if (q == 2) cp_async_wait<1>();
        if (q == 3) cp_async_wait<0>();
        __syncthreads();
        const int c0 = q * nch / 4, c1 = (q + 1) * nch / 4;
        for (int c = c0 + ((c0 & 1) != khalf); c < c1; c += 2) {
          // rows c*32 + 8t + e, columns 32 half + 4g .. + 3
          uint32_t rw[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            rw[e] = *reinterpret_cast<const uint32_t*>(
                ws + w5_off(c * kChunk + 8 * t + e, 32 * half + 4 * g));
          uint32_t b[2][4][2];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            uint32_t col[4];
            transpose4x4(rw[4 * s], rw[4 * s + 1], rw[4 * s + 2],
                         rw[4 * s + 3], col);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              widen4<T>(col[j], b[s][j][0], b[s][j][1]);
          }
          mma_chunk<T, NM>(acc, xs + c * kChunk * 2, xp, nmt, b, g, t);
        }
      }
      __syncthreads();  // the next segment's copies overwrite the tiles
    }

    // the block's partial tile: row g of m tile mt holds columns 32 half +
    // 8t + {j, 4 + j} in acc[mt][j][0 / 1]; k half 1 hands its sums to k
    // half 0, which adds them to its own (k half 0 first) and pushes each
    // row to the inbox of the rank that finishes it (row % ranks), slot
    // of this rank
    const int rows = min(16 * NM, M - r0);
    const int per_rank = (16 * NM + ranks - 1) / ranks;  // inbox rows
    if (khalf == 1) {
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float* p = part + (mt * 16 + g + 8 * hr) * kPartPitch + 32 * half +
                     8 * t;
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[mt][0][2 * hr], acc[mt][1][2 * hr],
                          acc[mt][2][2 * hr], acc[mt][3][2 * hr]);
          *reinterpret_cast<float4*>(p + 4) =
              make_float4(acc[mt][0][2 * hr + 1], acc[mt][1][2 * hr + 1],
                          acc[mt][2][2 * hr + 1], acc[mt][3][2 * hr + 1]);
        }
    }
    __syncthreads();
    if (khalf == 0) {
      const uint32_t inbox_u32 = smem_u32(inbox);
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = mt * 16 + g + 8 * hr;
          if (r >= rows) continue;
          const float* p = part + r * kPartPitch + 32 * half + 8 * t;
          const float4 a = *reinterpret_cast<const float4*>(p);
          const float4 b = *reinterpret_cast<const float4*>(p + 4);
          const uint32_t dst = map_rank(
              inbox_u32 + ((rank * per_rank + r / ranks) * kPartPitch +
                           32 * half + 8 * t) * 4,
              r % ranks);
          st_cluster4(dst, acc[mt][0][2 * hr] + a.x, acc[mt][1][2 * hr] + a.y,
                      acc[mt][2][2 * hr] + a.z, acc[mt][3][2 * hr] + a.w);
          st_cluster4(dst + 16, acc[mt][0][2 * hr + 1] + b.x,
                      acc[mt][1][2 * hr + 1] + b.y,
                      acc[mt][2][2 * hr + 1] + b.z,
                      acc[mt][3][2 * hr + 1] + b.w);
        }
    }
    cluster_sync();  // every rank's rows have landed in their inboxes
    // this rank's rows (rank, rank + ranks, ...): the ranks' partials
    // summed from rank 0 on, scaled, cast once, stored
    for (int i = tid; i < per_rank * (kTcCols / 4); i += kTcThreads) {
      const int lr = i / (kTcCols / 4), c4 = i % (kTcCols / 4);
      const int r = rank + ranks * lr;
      if (r >= rows || n0 + 4 * c4 >= N) continue;
      float4 a = *reinterpret_cast<const float4*>(inbox + lr * kPartPitch +
                                                  4 * c4);
      float v[4] = {a.x, a.y, a.z, a.w};
      for (int src = 1; src < ranks; ++src) {
        a = *reinterpret_cast<const float4*>(
            inbox + (src * per_rank + lr) * kPartPitch + 4 * c4);
        v[0] += a.x;
        v[1] += a.y;
        v[2] += a.z;
        v[3] += a.w;
      }
      store_out<T, 4>(out, static_cast<int64_t>(r0 + r) * N, n0 + 4 * c4, N,
                      v, sc + 4 * c4, vo);
    }
    // the next round pushes into inboxes that must have been read
    if (r0 + 16 * NM < M) cluster_sync();
  }
}

// ---- int8_matmul (w [K, N]), f32 on the CUDA cores -------------------------
// A block owns 128 output columns (4 per lane, one 4-byte int8 load per
// weight row) and 16 output rows; x rows are staged in shared memory and
// broadcast to every lane; the 4 warps take interleaved 16-row slices of
// each 64-row k step and are summed through shared memory.  The cluster's
// ranks split K as the tensor-core body's do and are summed through
// distributed shared memory in rank order.
constexpr int kMmThreads = 128;  // 4 warps
constexpr int kMmCols = 128;     // output columns per block: 4 per lane
constexpr int kMmRows = 16;      // output rows per block
constexpr int kMmKStep = 64;     // k rows staged per round: 16 per warp
constexpr int kMmWarpK = kMmKStep / (kMmThreads / 32);

__global__ void __launch_bounds__(kMmThreads)
    int8_mm_kernel_f32(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int M, int K, int N,
                       int k_per_rank, bool vec) {
  __shared__ float xs[kMmRows][kMmKStep];
  __shared__ __align__(16) float red[kMmThreads / 32][kMmRows][kMmCols];
  __shared__ float sums[kMmRows][kMmCols];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int n0 = blockIdx.y * kMmCols;
  const int m0 = blockIdx.z * kMmRows;
  const int k_begin = rank * k_per_rank;
  const int k_end = min(K, k_begin + k_per_rank);
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
      xs[m][kk] =
          (gm < M && gk < k_end) ? x[static_cast<int64_t>(gm) * K + gk] : 0.f;
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
  // thread t sums column t of the block's tile over the warps
  for (int m = 0; m < kMmRows; ++m) {
    float s = red[0][m][tid];
#pragma unroll
    for (int wp = 1; wp < kMmThreads / 32; ++wp) s += red[wp][m][tid];
    sums[m][tid] = s;
  }
  cluster_sync();
  const int n = n0 + tid;
  if (n < N) {
    const uint32_t base = smem_u32(&sums[0][tid]);
    for (int m = rank; m < kMmRows && m0 + m < M; m += ranks) {
      float s = 0.f;
      for (int src = 0; src < ranks; ++src)
        s += ld_cluster(map_rank(base + m * kMmCols * 4, src));
      out[static_cast<int64_t>(m0 + m) * N + n] = s * scale[n];
    }
  }
  cluster_sync();  // sums are read before the blocks exit
}

// Launch with a cluster of `ranks` blocks along grid x.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// m tiles a round: enough for M, at most 4 (64 accumulator registers a
// thread; at 8 a K5 block's rows and inbox leave one block an SM)
inline int m_tiles(int M) {
  const int need = (M + 15) / 16;
  int nm = 1;
  while (nm < need && nm < 4) nm *= 2;
  return nm;
}

template <typename T, int NM>
cudaError_t launch_mm_tc(const void* x, const void* w, const void* scale,
                         void* out, int M, int K, int N, int ranks,
                         int k_per_rank, cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      int8_mm_kernel_tc<T, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  int kseg = k_per_rank;  // a multiple of 32
  while (kseg > kChunk && k5_smem(NM, kseg) > kMaxSmem) kseg -= kChunk;
  const bool vx = K % 8 == 0 && aligned16(x);
  const bool vw = N % 16 == 0 && aligned16(w);
  const bool vo = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const dim3 grid(ranks, (N + kTcCols - 1) / kTcCols);
  return launch_cluster(int8_mm_kernel_tc<T, NM>, grid, k5_smem(NM, kseg),
                        stream, static_cast<const T*>(x),
                        static_cast<const int8_t*>(w),
                        static_cast<const float*>(scale), static_cast<T*>(out),
                        M, K, N, k_per_rank, kseg, vx, vw, vo);
}

template <typename T>
cudaError_t launch_mm(const void* x, const void* w, const void* scale,
                      void* out, int M, int K, int N, int ranks,
                      int k_per_rank, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
    const dim3 grid(ranks, (N + kMmCols - 1) / kMmCols,
                    (M + kMmRows - 1) / kMmRows);
    return launch_cluster(int8_mm_kernel_f32, grid, 0, s,
                          static_cast<const float*>(x),
                          static_cast<const int8_t*>(w),
                          static_cast<const float*>(scale),
                          static_cast<float*>(out), M, K, N, k_per_rank, vec);
  } else {
    switch (m_tiles(M)) {
      case 1:
        return launch_mm_tc<T, 1>(x, w, scale, out, M, K, N, ranks,
                                  k_per_rank, s);
      case 2:
        return launch_mm_tc<T, 2>(x, w, scale, out, M, K, N, ranks,
                                  k_per_rank, s);
      default:
        return launch_mm_tc<T, 4>(x, w, scale, out, M, K, N, ranks,
                                  k_per_rank, s);
    }
  }
}

// ---- int8_matmul_nt (w [N, K]), tensor cores ------------------------------
constexpr int kNtTcThreads = 256;  // 8 warps: 2 column halves x 4 chunks
constexpr int kNtStages = 4;       // ring stages, 3 in flight
constexpr int kNtKStep = 256;      // k bytes of a stage row
constexpr int kNtWarpChunks = kNtKStep / (4 * kChunk);  // chunks a warp
constexpr int kNtStage = kTcCols * kNtKStep;  // weight bytes of a stage
constexpr int kNtXPitch = x_pitch(kNtKStep);  // a stage's x row (!XRES)

__host__ __device__ constexpr int k6_smem(int nm, bool xres, int K) {
  return (xres ? 16 * nm * x_pitch((K + kNtKStep - 1) / kNtKStep * kNtKStep)
               : 0) +
         kNtStages * (kNtStage + (xres ? 0 : 16 * nm * kNtXPitch)) +
         3 * 2 * 16 * nm * kRedPitch * 4;
}

// byte offset of byte `col` of row r in a K6 stage: the 32-byte windows of
// a row rotate with bits 2-3 of r, so the rows 4g + j that the quads of a
// half warp read fall on four bank groups
__device__ __forceinline__ int w6_off(int r, int col) {
  return r * kNtKStep + (col ^ (((r >> 2) & 3) << 5));
}

// A (tile, k step) position of a block's walk: its tiles are blockIdx.x,
// blockIdx.x + gridDim.x, ...; counted up without a division
struct Walk {
  int tile, ks;
  __device__ __forceinline__ void next(int ksteps) {
    if (++ks == ksteps) {
      ks = 0;
      ++tile;
    }
  }
};

template <typename T, int NM, bool XRES>
__global__ void __launch_bounds__(kNtTcThreads)
    int8_mm_nt_kernel_tc(const T* __restrict__ x,
                         const int8_t* __restrict__ w, T* __restrict__ out,
                         int M, int K, int N, bool vx, bool vw, bool vo) {
  extern __shared__ __align__(16) char smem[];
  const int ksteps = (K + kNtKStep - 1) / kNtKStep;
  const int xp = XRES ? x_pitch(ksteps * kNtKStep) : kNtXPitch;
  char* xs = smem;
  char* ring = smem + (XRES ? 16 * NM * xp : 0);
  constexpr int kStageBytes = kNtStage + (XRES ? 0 : 16 * NM * kNtXPitch);
  float* red = reinterpret_cast<float*>(ring + kNtStages * kStageBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = warp & 1, kq = warp >> 1;  // chunks kq, kq + 4, ...
  const int n_tiles = (N + kTcCols - 1) / kTcCols;
  const int my_tiles =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int items = my_tiles * ksteps;
  // this thread's two 16-byte copies of a stage (row r, bytes 16 c), and
  // the stage bytes its warp's B fragments read, the same every stage
  constexpr int kCopies = kNtStage / 16 / kNtTcThreads;
  int cp_r[kCopies], cp_dst[kCopies];
#pragma unroll
  for (int c = 0; c < kCopies; ++c) {
    const int i = tid + c * kNtTcThreads;
    cp_r[c] = i / (kNtKStep / 16);
    cp_dst[c] = w6_off(cp_r[c], 16 * (i % (kNtKStep / 16)));
  }
  int b_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b_off[j] = w6_off(32 * half + 4 * g + j, kq * kChunk + 8 * t);

  for (int r0 = 0; r0 < M; r0 += 16 * NM) {
    const int nmt = min(NM, (M - r0 + 15) / 16);
    auto issue = [&](const Walk& at, int stage) {
      const int n0 = (blockIdx.x + at.tile * gridDim.x) * kTcCols;
      const int k0 = at.ks * kNtKStep;
      char* st = ring + stage * kStageBytes;
#pragma unroll
      for (int c = 0; c < kCopies; ++c) {
        const int gn = n0 + cp_r[c];
        const int gk =
            k0 + 16 * ((tid + c * kNtTcThreads) % (kNtKStep / 16));
        if (vw) {
          const bool ok = gn < N && gk < K;
          cp_async16(smem_u32(st + cp_dst[c]),
                     w + (ok ? static_cast<int64_t>(gn) * K + gk : 0),
                     ok ? 16 : 0);
        } else {
          __align__(16) uint8_t v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e)
            v[e] = gn < N && gk + e < K
                       ? static_cast<uint8_t>(
                             w[static_cast<int64_t>(gn) * K + gk + e])
                       : 0;
          *reinterpret_cast<uint4*>(st + cp_dst[c]) =
              *reinterpret_cast<const uint4*>(v);
        }
      }
      if (!XRES)
        stage_x<T, kNtTcThreads>(st + kNtStage, kNtXPitch, x, r0, 16 * NM, k0,
                                 kNtKStep, M, K, K, vx, tid);
    };

    if (XRES)  // x rows of this round, once; lands with the first stage
      stage_x<T, kNtTcThreads>(xs, xp, x, r0, 16 * NM, 0, ksteps * kNtKStep, M,
                               K, K, vx, tid);
    Walk ahead = {0, 0};  // the next item to copy
#pragma unroll
    for (int p = 0; p < kNtStages - 1; ++p) {
      if (p < items) {
        issue(ahead, p);
        ahead.next(ksteps);
      }
      cp_async_commit();
    }

    float acc[NM][4][4];
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    Walk at = {0, 0};  // the item in hand
    int stage = 0, ahead_stage = kNtStages - 1;
    for (int i = 0; i < items; ++i) {
      cp_async_wait<kNtStages - 2>();
      __syncthreads();  // item i landed; item i - 1's stage is free
      if (i + kNtStages - 1 < items) {
        issue(ahead, ahead_stage);
        ahead.next(ksteps);
      }
      cp_async_commit();
      ahead_stage = ahead_stage + 1 == kNtStages ? 0 : ahead_stage + 1;

      const char* st = ring + stage * kStageBytes;
      const char* xk = XRES ? xs + at.ks * kNtKStep * 2 : st + kNtStage;
#pragma unroll
      for (int cc = 0; cc < kNtWarpChunks; ++cc) {
        const int kc = kq + 4 * cc;
        if (at.ks * kNtKStep + kc * kChunk >= K) break;  // warp-uniform
        uint32_t b[2][4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              st + b_off[j] + cc * 4 * kChunk);
          widen4<T>(v.x, b[0][j][0], b[0][j][1]);
          widen4<T>(v.y, b[1][j][0], b[1][j][1]);
        }
        mma_chunk<T, NM>(acc, xk + kc * kChunk * 2, xp, nmt, b, g, t);
      }

      if (at.ks == ksteps - 1) {
        // the tile is done: the warps of chunks 1-3 hand their sums to
        // chunk 0's, which adds them to its own in chunk order and stores
        const int n = (blockIdx.x + at.tile * gridDim.x) * kTcCols +
                      32 * half + 8 * t;
        if (kq > 0) {
#pragma unroll
          for (int mt = 0; mt < NM; ++mt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float* p = red + ((((kq - 1) * 2 + half) * 16 * NM + mt * 16 +
                                 g + 8 * hr) * kRedPitch + 8 * t);
              *reinterpret_cast<float4*>(p) = make_float4(
                  acc[mt][0][2 * hr], acc[mt][1][2 * hr], acc[mt][2][2 * hr],
                  acc[mt][3][2 * hr]);
              *reinterpret_cast<float4*>(p + 4) = make_float4(
                  acc[mt][0][2 * hr + 1], acc[mt][1][2 * hr + 1],
                  acc[mt][2][2 * hr + 1], acc[mt][3][2 * hr + 1]);
            }
        }
        __syncthreads();
        if (kq == 0 && n < N) {
#pragma unroll
          for (int mt = 0; mt < NM; ++mt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = r0 + mt * 16 + g + 8 * hr;
              if (mt >= nmt || row >= M) continue;
              float v[8];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                v[j] = acc[mt][j][2 * hr];
                v[4 + j] = acc[mt][j][2 * hr + 1];
              }
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                const float* p =
                    red + (((q * 2 + half) * 16 * NM + mt * 16 + g + 8 * hr) *
                               kRedPitch + 8 * t);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] += p[e];
              }
              store_out<T, 8>(out, static_cast<int64_t>(row) * N, n, N, v,
                              nullptr, vo);
            }
        }
#pragma unroll
        for (int mt = 0; mt < NM; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
      }
      at.next(ksteps);
      stage = stage + 1 == kNtStages ? 0 : stage + 1;
    }
    cp_async_wait<0>();
    __syncthreads();  // the next round restages x and the ring
  }
}

// ---- int8_matmul_nt (w [N, K]), f32 on the CUDA cores ----------------------
// Each warp owns 4 output columns and streams their rows with 16-byte
// loads (lane l reads bytes 16l..16l+15 of each 512-byte k step); the
// block's 16 rows of x are staged in shared memory, padded so that the
// lanes' 16-byte reads hit distinct banks.  Each lane keeps 4 x 16 partial
// dot products and the warp reduces them with xor shuffles at the end.
constexpr int kNtThreads = 128;   // 4 warps
constexpr int kNtColsPerWarp = 4;
constexpr int kNtCols = kNtColsPerWarp * (kNtThreads / 32);  // 16 per block
constexpr int kNtRows = 16;       // output rows per block
constexpr int kNtF32KStep = 512;  // 32 lanes x 16 int8
// 4 floats of padding after every 16: lane l's 16-float slice starts at
// 20*l, so the 8 lanes of each 16-byte shared-memory phase hit 8 disjoint
// groups of 4 banks
constexpr int kNtPitch = kNtF32KStep + kNtF32KStep / 4;

__device__ __forceinline__ int nt_slot(int kk) { return kk + (kk >> 4) * 4; }

__global__ void __launch_bounds__(kNtThreads)
    int8_mm_nt_kernel_f32(const float* __restrict__ x,
                          const int8_t* __restrict__ w,
                          float* __restrict__ out, int M, int K, int N,
                          bool vec) {
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

  for (int kb = 0; kb < K; kb += kNtF32KStep) {
    for (int i = tid; i < kNtRows * kNtF32KStep; i += kNtThreads) {
      const int m = i / kNtF32KStep;
      const int kk = i % kNtF32KStep;
      const int gm = m0 + m;
      const int gk = kb + kk;
      xs[m][nt_slot(kk)] =
          (gm < M && gk < K) ? x[static_cast<int64_t>(gm) * K + gk] : 0.f;
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
        for (int j = 0; j < 16; ++j)
          acc[c][m] = fmaf(xv[j], wf[c][j], acc[c][m]);
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
      if (n < N && gm < M) out[static_cast<int64_t>(gm) * N + n] = acc[c][m];
    }
}

// SMs of the current device, read once a process
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return std::max(1, n);
  }();
  return sms;
}

template <typename T, int NM, bool XRES>
cudaError_t launch_mm_nt_tc(const void* x, const void* w, void* out, int M,
                            int K, int N, cudaStream_t stream) {
  auto* kernel = &int8_mm_nt_kernel_tc<T, NM, XRES>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  const int smem = k6_smem(NM, XRES, K);
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kNtTcThreads, smem);
  if (occ != cudaSuccess) return occ;
  const int n_tiles = (N + kTcCols - 1) / kTcCols;
  const int grid = std::min(n_tiles, sm_count() * std::max(1, per_sm));
  const bool vx = K % 8 == 0 && aligned16(x);
  const bool vw = K % 16 == 0 && aligned16(w);
  const bool vo = N % 8 == 0 && aligned16(out);
  kernel<<<grid, kNtTcThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<T*>(out), M, K, N, vx, vw, vo);
  return cudaGetLastError();
}

template <typename T, int NM>
cudaError_t launch_mm_nt_tc_nm(const void* x, const void* w, void* out,
                               int M, int K, int N, cudaStream_t s) {
  // x held once a block where its rows fit beside the ring, else staged
  // with every stage
  if (k6_smem(NM, true, K) <= kMaxSmem)
    return launch_mm_nt_tc<T, NM, true>(x, w, out, M, K, N, s);
  return launch_mm_nt_tc<T, NM, false>(x, w, out, M, K, N, s);
}

template <typename T>
cudaError_t launch_mm_nt(const void* x, const void* w, void* out, int M,
                         int K, int N, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    const bool vec = K % 16 == 0 && aligned16(w);
    const dim3 grid((N + kNtCols - 1) / kNtCols, (M + kNtRows - 1) / kNtRows);
    int8_mm_nt_kernel_f32<<<grid, kNtThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<float*>(out), M, K, N, vec);
    return cudaGetLastError();
  } else {
    // m tiles a round: as many as M needs, at most 4, while x's rows and
    // the ring fit in shared memory; one tile whatever K (x then rides in
    // the stages if it must)
    int nm = m_tiles(M);
    while (nm > 1 && k6_smem(nm, true, K) > kMaxSmem) nm /= 2;
    switch (nm) {
      case 1:
        return launch_mm_nt_tc_nm<T, 1>(x, w, out, M, K, N, s);
      case 2:
        return launch_mm_nt_tc_nm<T, 2>(x, w, out, M, K, N, s);
      default:
        return launch_mm_nt_tc_nm<T, 4>(x, w, out, M, K, N, s);
    }
  }
}

}  // namespace

// x: [M, K] in `dtype`; w: [K, N] int8; scale: [N] f32; out: [M, N] in
// `dtype`.  A cluster of `ranks` blocks (1-8) splits K: rank r covers k in
// [r * k_per_rank, (r + 1) * k_per_rank), k_per_rank a multiple of 32,
// no rank empty.  One launch; returns its error code.
extern "C" int rla_int8_matmul(const void* x, const void* w,
                               const void* scale, void* out, int M, int K,
                               int N, int ranks, int k_per_rank, int dtype,
                               void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || ranks < 1 || ranks > 8 ||
      k_per_rank <= 0 || k_per_rank % kChunk != 0 ||
      static_cast<int64_t>(ranks - 1) * k_per_rank >= K ||
      static_cast<int64_t>(ranks) * k_per_rank < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch_mm<float>(x, w, scale, out, M, K, N, ranks, k_per_rank, s);
      break;
    case kBF16:
      err = launch_mm<__nv_bfloat16>(x, w, scale, out, M, K, N, ranks,
                                     k_per_rank, s);
      break;
    case kF16:
      err = launch_mm<__half>(x, w, scale, out, M, K, N, ranks, k_per_rank,
                              s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// x: [M, K] in `dtype`; w: [N, K] int8; out: [M, N] in `dtype`.
extern "C" int rla_int8_matmul_nt(const void* x, const void* w, void* out,
                                  int M, int K, int N, int dtype,
                                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch_mm_nt<float>(x, w, out, M, K, N, s);
      break;
    case kBF16:
      err = launch_mm_nt<__nv_bfloat16>(x, w, out, M, K, N, s);
      break;
    case kF16:
      err = launch_mm_nt<__half>(x, w, out, M, K, N, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
