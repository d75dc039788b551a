// Hopper (sm_90a) building blocks for the port's tensor-core kernels:
// asynchronous global -> shared copies (cp.async), the 128-byte swizzled
// shared-memory tile layout, wgmma matrix descriptors, and the
// warpgroup products (wgmma.mma_async, f32 accumulators, bf16 / f16
// operands) at the shapes the kernels use.
//
// Tile layout.  A tile of R rows by D (64 or 128) 16-bit columns is kept
// as D / 64 column halves of R rows by 128 bytes; in row r the 16-byte
// chunk c sits at chunk c ^ (r % 8) (the 128-byte swizzle, with every
// half 1024-byte aligned), so eight rows read at the same column hit
// eight different bank groups.  The same bytes serve wgmma as a K-major
// operand (rows = M or N, 64 K-elements a half; stride between 8-row
// groups SBO = 1024, a 16-element K step adds 32 bytes to the start
// address) and as an MN-major one (rows = K, 64 M/N elements a half;
// SBO = 1024 between 8-row K groups, LBO = R * 128 between the halves, a
// 16-row K step adds 2048 bytes), with the transpose bit set.
//
// On top of those: the products the flash kernels share (`gmma_abt`,
// `gmma_rs_mn`), the two-stage key ring of K2 and K3a (`walk_key_tiles`)
// and their output store (`store_acc_rows`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of R rows
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma descriptor of a 128-byte swizzled operand at shared address addr
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, zero-filled past src_bytes (0 or 4)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, n) of a row-major [R, D] tile of 16-bit elements into the
// swizzled shared tile `tile`, rows [n, R) as zeros, by the NT threads of
// the block: cp.async when `vec` (operands 16-byte aligned), else element
// loads and stores
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(char* tile,
                                          const uint16_t* __restrict__ src,
                                          int n, bool vec, int tid) {
  constexpr int kC = D / 8;  // 16-byte chunks a row
  static_assert(R * kC % NT == 0, "whole passes of the block");
  const uint32_t dst = smem_u32(tile);
#pragma unroll
  for (int j = 0; j < R * kC / NT; ++j) {
    const int r = (tid + j * NT) / kC, c = (tid + j * NT) % kC;
    const bool ok = r < n;
    const uint16_t* g = src + static_cast<int64_t>(ok ? r : 0) * D + c * 8;
    if (vec) {
      cp_async16(dst + swz<R>(r, c), g, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = ok ? g[2 * e] | static_cast<uint32_t>(g[2 * e + 1]) << 16 : 0;
      *reinterpret_cast<uint4*>(tile + swz<R>(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) made visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep registers that an in-flight wgmma reads or writes where they are:
// the compiler may neither move nor reuse them across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// two floats rounded to T (nearest even) and packed, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Gmma<T, N>: one m64nNk16 warpgroup product into f32 accumulators, the
// 128 threads of the warpgroup together.  Accumulator d[4 j + e] of the
// thread with lane l in warp w of the warpgroup is row 16 w + l / 4 + 8 *
// (e / 2), column 8 j + 2 (l % 4) + e % 2; an A fragment from registers
// is four packed pairs in the same rows, columns 2 (l % 4) + {0, 8}.
// `acc` = 0 overwrites d, else adds to it; TA / TB = 1 reads the shared
// operand MN-major (transposed).
template <typename T, int N>
struct Gmma;

#define RLA_GMMA_SPECS(CTY, TY)                                            \
template <>                                                                \
struct Gmma<CTY, 32> {                                                     \
  template <int TA, int TB>                                                \
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,    \
                                            uint64_t b, int acc) {         \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "        \
        "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
        " %8, %9, %10, %11, %12, %13, %14, %15}, "                         \
        "%16, %17, p, 1, 1, %19, %20;\n}\n"                                \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])               \
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));                     \
  }                                                                        \
};                                                                         \
template <>                                                                \
struct Gmma<CTY, 64> {                                                     \
  template <int TA, int TB>                                                \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,    \
                                            uint64_t b, int acc) {         \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
        "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
        " %8, %9, %10, %11, %12, %13, %14, %15,"                           \
        " %16, %17, %18, %19, %20, %21, %22, %23,"                         \
        " %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
        "%32, %33, p, 1, 1, %35, %36;\n}\n"                                \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])               \
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));                     \
  }                                                                        \
  template <int TB>                                                        \
  static __device__ __forceinline__ void rs(float (&d)[32],                \
                                            const uint32_t* a, uint64_t b, \
                                            int acc) {                     \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
        "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
        " %8, %9, %10, %11, %12, %13, %14, %15,"                           \
        " %16, %17, %18, %19, %20, %21, %22, %23,"                         \
        " %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])               \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),    \
          "n"(TB));                                                        \
  }                                                                        \
};                                                                         \
template <>                                                                \
struct Gmma<CTY, 128> {                                                    \
  template <int TB>                                                        \
  static __device__ __forceinline__ void rs(float (&d)[64],                \
                                            const uint32_t* a, uint64_t b, \
                                            int acc) {                     \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "       \
        "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
        " %8, %9, %10, %11, %12, %13, %14, %15,"                           \
        " %16, %17, %18, %19, %20, %21, %22, %23,"                         \
        " %24, %25, %26, %27, %28, %29, %30, %31,"                         \
        " %32, %33, %34, %35, %36, %37, %38, %39,"                         \
        " %40, %41, %42, %43, %44, %45, %46, %47,"                         \
        " %48, %49, %50, %51, %52, %53, %54, %55,"                         \
        " %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),              \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),              \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),              \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),              \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),    \
          "n"(TB));                                                        \
  }                                                                        \
};

RLA_GMMA_SPECS(__nv_bfloat16, "bf16")
RLA_GMMA_SPECS(__half, "f16")
#undef RLA_GMMA_SPECS

// The start of a block's dynamic shared memory rounded up to 1024 bytes,
// the alignment of the 128-byte swizzle (allocations carry 1024 bytes of
// slack for it).
__device__ __forceinline__ char* align_smem(char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// s = A B^T over 64 rows of A and 64 rows of B, both K-major swizzled
// tiles of D columns in shared memory at a (a tile of RA rows) and b (RB
// rows): D / 16 steps of 16, s overwritten.  The caller fences before and
// commits after.
template <typename T, int D, int RA, int RB>
__device__ __forceinline__ void gmma_abt(float (&s)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Gmma<T, 64>::template ss<0, 0>(
        s, gmma_desc(a + (kk / 4) * (RA * 128) + (kk % 4) * 32, 16, 1024),
        gmma_desc(b + (kk / 4) * (RB * 128) + (kk % 4) * 32, 16, 1024), kk);
}

// acc[64, N] += A B with A = 64 rows by R columns in registers (packed
// pairs as Gmma's A fragments, four a 16-wide step) and B = a swizzled
// tile of R rows by N columns in shared memory at b, read MN-major: R / 16
// steps.  The caller fences before and commits after.
template <typename T, int N, int R>
__device__ __forceinline__ void gmma_rs_mn(float (&acc)[N / 2],
                                           const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    Gmma<T, N>::template rs<1>(acc, a + 4 * kk,
                               gmma_desc(b + kk * 2048, R * 128, 1024), 1);
}

// The key walk of one warpgroup over a (bh, 64-query) tile, as K2 and
// K3a make it: NQ [64, D] query-side tiles (q; q and dO) staged once at
// the start of shared memory, then the key and value tiles of 64 keys
// through a two-stage cp.async ring, the next tile's copy in flight while
// this one's products run.
constexpr int kWarpgroup = 128;  // threads
constexpr int kRingRows = 64;    // queries a block, keys a tile

// its dynamic shared memory, byte offsets from a 1024-byte aligned base
template <int D, int NQ>
struct RingSmem {
  static constexpr int kTile = kRingRows * D * 2;  // a [64, D] 16-bit tile
  static constexpr int kK = NQ * kTile;            // two stages
  static constexpr int kV = kK + 2 * kTile;        // two stages
  static constexpr int kAlloc = kV + 2 * kTile + 1024;  // slack to align
};

// The key tiles [kts.x, kts.y) of k16 and v16 ([k_len, D] row-major)
// through the ring at the aligned `smem`: body(k0, k_s, v_s) runs on each
// tile with the shared addresses of its key and value tiles.  The
// caller's copies of its query-side tiles commit with the first key
// tile's.
template <int D, int NQ, typename Body>
__device__ __forceinline__ void walk_key_tiles(char* smem,
                                               const uint16_t* k16,
                                               const uint16_t* v16, int k_len,
                                               int2 kts, bool vec, int tid,
                                               Body&& body) {
  using L = RingSmem<D, NQ>;
  constexpr int BK = kRingRows;
  const uint32_t base = smem_u32(smem);
  auto load = [&](int kt, int st) {
    const int64_t at = static_cast<int64_t>(kt) * BK * D;
    const int n_k = min(BK, k_len - kt * BK);
    load_tile<BK, D, kWarpgroup>(smem + L::kK + st * L::kTile, k16 + at, n_k,
                                 vec, tid);
    load_tile<BK, D, kWarpgroup>(smem + L::kV + st * L::kTile, v16 + at, n_k,
                                 vec, tid);
  };
  if (kts.x < kts.y) load(kts.x, 0);
  cp_async_commit();
  for (int kt = kts.x, st = 0; kt < kts.y; ++kt, st ^= 1) {
    cp_async_wait<0>();  // this thread's copies of tile kt have landed
    fence_proxy_async();
    __syncthreads();     // everyone's have; slot st ^ 1 is free
    if (kt + 1 < kts.y) {  // the next tile's copy overlaps this one's work
      load(kt + 1, st ^ 1);
      cp_async_commit();
    }
    body(kt * BK, base + L::kK + st * L::kTile, base + L::kV + st * L::kTile);
  }
}

// rows r0 and r0 + 8 of a [64, D] f32 accumulator (Gmma's layout, the
// thread's quad column tig) divided by div[0] / div[1], rounded to T once
// and stored two neighbouring columns at a time into the rows [0, n) of
// the row-major dst
template <typename T, int D>
__device__ __forceinline__ void store_acc_rows(T* dst,
                                               const float (&acc)[D / 2],
                                               const float (&div)[2], int r0,
                                               int tig, int n) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i >> 1) & 1;
    if (r0 + 8 * h < n)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8 * h) * D + 8 * (i / 4) +
                                   2 * tig) =
          pack2<T>(acc[i] / div[h], acc[i + 1] / div[h]);
  }
}
