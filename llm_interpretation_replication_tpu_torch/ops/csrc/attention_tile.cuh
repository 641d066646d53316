// One Hopper (sm_90a) attention tile core, shared by all three of the port's
// attention kernels: the causal grouped kernel (causal_grouped_attention.cu)
// and the head-major grouped and flash kernels (head_major_attention.cu,
// `grouped_attention_bf16` and `flash_attention_bf16`).  bf16 in and out.
//
// All compute, for the query rows of one (batch, K/V group),
//
//   out[row] = softmax_j(q[row] . k[j] / sqrt(D)) . v[j]
//   over the keys j < bound(row) = min(length[b], pos(row) + 1)   (causal)
//                                = length[b]                      (causal == 0)
//   and a row whose bound is 0 is written as exact zeros.
//
// They differ only in how a query row and a key row map to memory; a policy
// class (BsndRows, BnsdRows below) gives the element offset of each.  Rows
// of one group are numbered position-major: row r is position r / hpg of
// head r % hpg of the group, hpg = N / G query heads per K/V head.
//
// Design (one block = 128 query rows of one (batch, group): 8 warps, two
// warpgroups of 64 rows, 16 rows a warp):
// - Q is staged in shared memory with 16-byte `cp.async` copies (in the
//   projection layout a 128-row tile of Falcon's 71 MQA heads is one
//   contiguous 16 KB run; head-major, each row's D values are contiguous)
//   and stays there as Q.K's A operand; O goes back through the same
//   shared memory and leaves with 16-byte coalesced stores.
// - K/V stream through a ring of tiles in dynamic shared memory (3 tiles of
//   64 keys at D <= 64 and of 128 at D = 128; 2 tiles of 64 keys at D = 256,
//   where the 64 KB Q/O tile leaves room for no more), filled with 16-byte
//   `cp.async.cg` in commit/wait groups: the next tiles load while tile t
//   computes, one __syncthreads a tile.  Keys past the block's largest
//   bound, and the head-dim padding, are zero-filled by the copy itself
//   (src-size 0), never left stale: 0 x NaN would be NaN in P.V.
// - Every tile is row-major with the 128-byte XOR swizzle (16-byte chunk c
//   of row r at chunk c ^ (r % 8) of its 128-byte line; D = 128 is two
//   64-column halves), which the copies write without bank conflicts and
//   which is wgmma's 128-byte-swizzle layout: K-major for Q and K, MN-major
//   for V.  D = 256 is four 64-column quarters.
// - Both products are Hopper `wgmma`, one warpgroup per 64 rows: Q.K as
//   m64nKk16 with Q and K from shared memory; P.V as m64nDk16 with P from
//   registers (the score accumulator's layout is the A operand's) and V from
//   shared memory, transposed by the instruction, so V is never transposed
//   by scalar stores; at D = 256 the output is two m64n128 halves, so a
//   thread holds 128 fp32 accumulators.  m, l, the 1/sqrt(D) scale (on the
//   fp32 scores, in the FFMA of the exponent) and the output accumulator
//   are fp32.  l sums the
//   fp32 P; P enters P.V as a bf16 high part plus a bf16 residual (~16
//   significant bits, one more P.V wgmma), as the port's 1e-2 gate against
//   the float32 plain version needs.
// - The key loop of a block stops at the largest bound among its rows; a
//   warpgroup skips the tiles past its own rows' bound and a warp masks only
//   the tiles that cross its smallest bound (the finite NEG_INF = -1e9 of
//   the reference).
// - Blocks run heaviest first: the row-tile index is the slowest grid
//   dimension and counts down, so the longest causal key loops start first.
// - Any S >= 1, any N / G, any D <= 256 with D % 8 == 0 (padded with zeros to
//   64, 128 or 256 inside shared memory).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // 128 query rows
constexpr float kNegInf = -1e9f;  // finite, as in the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;  // devices whose launch attribute is cached

// q/out [B, S, N, D], k/v [B, S, G, D]: the projection layout.
struct BsndRows {
  int S, N, G, D, hpg;
  __device__ __forceinline__ size_t q_row(int b, int grp, int r) const {
    const int p = r / hpg;
    const int h = r - p * hpg;
    return (((size_t)b * S + p) * N + (size_t)grp * hpg + h) * D;
  }
  __device__ __forceinline__ size_t kv_row(int b, int grp, int j) const {
    return (((size_t)b * S + j) * G + grp) * D;
  }
};

// q/out [B, N, S, D], k/v [B, G, S, D]: head-major.
struct BnsdRows {
  int S, N, G, D, hpg;
  __device__ __forceinline__ size_t q_row(int b, int grp, int r) const {
    const int p = r / hpg;
    const int h = r - p * hpg;
    return (((size_t)b * N + (size_t)grp * hpg + h) * S + p) * D;
  }
  __device__ __forceinline__ size_t kv_row(int b, int grp, int j) const {
    return (((size_t)b * G + grp) * S + j) * D;
  }
};

// Element offset of 16-byte chunk `c` of row `r` in a swizzled R-row tile.
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * (R * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = p with its low 16 bits cleared (a bf16, truncated); lo = bf16(p - hi),
// where p - hi is exact in fp32 and below 2^-7 p: the pair carries p to ~16
// significant bits with one float-to-bf16 conversion per pair.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(p0) & 0xffff0000u;
  const uint32_t h1 = __float_as_uint(p1) & 0xffff0000u;
  hi = __byte_perm(h0, h1, 0x7632);  // low half = h0's bf16, high = h1's
  lo = pack_bf16(p0 - __uint_as_float(h0), p1 - __uint_as_float(h1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// cp.async writes are generic-proxy writes; wgmma reads through the async
// proxy, so each thread fences its landed copies before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `p` (1024-B
// aligned swizzle atoms of 8 rows x 128 B): lbo / sbo are the byte strides
// between atoms along the leading and the strided dimension.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// D[64x64] (+)= A[64x16] . B[16x64], both from shared memory (K-major,
// 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x128] (+)= A[64x16] . B[16x128], both from shared memory (K-major,
// 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x64] += A[64x16] . B[16x64]: A from registers (the mma.sync A layout,
// 16 rows a warp), B = V rows from shared memory (MN-major, 128-byte
// swizzle, transposed by the instruction).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D[64x128] += A[64x16] . B[16x128]: A from registers (the mma.sync A layout,
// 16 rows a warp), B = V rows from shared memory (MN-major, 128-byte
// swizzle, transposed by the instruction).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// Per padded head dim: keys per K/V tile, the ring's depth and the blocks
// per SM that __launch_bounds__ asks the register allocation to allow (at
// D=64 two blocks of 8 warps fit in 128 registers and hide each other's
// softmax; at D=128 one block of ~250 registers, where a 128-key tile halves
// the per-tile barriers and softmax bookkeeping; at D=256 the 128 output
// accumulators a thread leave room for a 64-key score tile only, and the
// 64 KB Q/O tile plus two 64 KB K/V stages fill 192 KB of shared memory).
template <int DP>
struct Tune;
template <>
struct Tune<64> {
  static constexpr int kKeys = 64, kStages = 3, kMinBlocks = 2;
};
template <>
struct Tune<128> {
  static constexpr int kKeys = 128, kStages = 3, kMinBlocks = 1;
};
template <>
struct Tune<256> {
  static constexpr int kKeys = 64, kStages = 2, kMinBlocks = 1;
};

// Output columns one P.V wgmma covers: the whole padded head dim up to 128,
// two m64n128 halves at 256.
template <int DP>
constexpr int kPvCols = DP < 128 ? DP : 128;

// Dynamic shared memory of one block: the Q/O tile and the K/V ring.
template <int DP>
constexpr int smem_bytes() {
  return (kBlockRows * DP + Tune<DP>::kStages * 2 * Tune<DP>::kKeys * DP) * 2;
}

// Issues S = Q . K^T for one warpgroup's 64 rows (qs_wg) and one K tile of
// KEYS rows: m64nKEYSk16 per 16 columns of the head dim, both operands in
// shared memory.
template <int DP, int KEYS>
__device__ __forceinline__ void issue_qk(float (&s)[KEYS / 8][4],
                                         const __nv_bfloat16* qs_wg,
                                         const __nv_bfloat16* ks) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(s,
             sw128_desc(qs_wg + (kk >> 2) * (kBlockRows * 64) + (kk & 3) * 16,
                        16, 1024),
             sw128_desc(ks + (kk >> 2) * (KEYS * 64) + (kk & 3) * 16, 16, 1024),
             kk > 0);
}

// Issues O += P_hi . V + P_lo . V: m64nNk16 per 16 keys and N = kPvCols
// output columns (acc[h] holds columns h * N ..), P from registers, V rows
// from shared memory, transposed by the instruction.
template <int DP, int KEYS>
__device__ __forceinline__ void issue_pv(
    float (&acc)[DP / kPvCols<DP>][kPvCols<DP> / 8][4],
    const uint32_t (&ph)[KEYS / 16][4], const uint32_t (&pl)[KEYS / 16][4],
    const __nv_bfloat16* vs) {
  constexpr int H = DP / kPvCols<DP>;
#pragma unroll
  for (int kc = 0; kc < KEYS / 16; ++kc) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      // a half starts kPvCols / 64 swizzled 64-column chunks further on
      const uint64_t dv = sw128_desc(
          vs + h * (kPvCols<DP> / 64) * (KEYS * 64) + kc * 16 * 64,
          KEYS * 128, 1024);
      wgmma_rs_t(acc[h], ph[kc], dv);
      wgmma_rs_t(acc[h], pl[kc], dv);
    }
  }
}

// One score tile of a thread's two rows (a: gid, b: gid + 8) through the
// online softmax: mask the keys at or past each row's bound (only on tiles
// that cross the warp's smallest bound), update the running max m (of the
// unscaled scores) and sum l, and return P = 2^(s * scale_log2 - m *
// scale_log2) -- the 1/sqrt(D) scale on the fp32 scores, in one FFMA -- as
// P.V's A fragments (bf16 high and low parts), plus the factors that
// rescale the output so far.
template <int KEYS>
__device__ __forceinline__ void softmax_tile(
    float (&s)[KEYS / 8][4], int t0, bool masked, int bnd_a, int bnd_b,
    int tig, float scale_log2, float& m_a, float& m_b, float& l_a, float& l_b,
    float& corr_a, float& corr_b, uint32_t (&ph)[KEYS / 16][4],
    uint32_t (&pl)[KEYS / 16][4]) {
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    if (masked) {
      const int col = t0 + j * 8 + 2 * tig;
      if (col >= bnd_a) s[j][0] = kNegInf;
      if (col + 1 >= bnd_a) s[j][1] = kNegInf;
      if (col >= bnd_b) s[j][2] = kNegInf;
      if (col + 1 >= bnd_b) s[j][3] = kNegInf;
    }
    mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
  }
  // Every row with bound > 0 sees key 0 in its first tile, so m is a real
  // score from then on and a fully masked later tile contributes 2^-huge = 0.
  const float mn_a = fmaxf(m_a, quad_max(mx_a));
  const float mn_b = fmaxf(m_b, quad_max(mx_b));
  corr_a = ex2((m_a - mn_a) * scale_log2);
  corr_b = ex2((m_b - mn_b) * scale_log2);
  m_a = mn_a;
  m_b = mn_b;
  l_a *= corr_a;
  l_b *= corr_b;
  const float ms_a = mn_a * scale_log2;
  const float ms_b = mn_b * scale_log2;
#pragma unroll
  for (int kc = 0; kc < KEYS / 16; ++kc) {
    float p[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h][0] = ex2(fmaf(s[2 * kc + h][0], scale_log2, -ms_a));
      p[h][1] = ex2(fmaf(s[2 * kc + h][1], scale_log2, -ms_a));
      p[h][2] = ex2(fmaf(s[2 * kc + h][2], scale_log2, -ms_b));
      p[h][3] = ex2(fmaf(s[2 * kc + h][3], scale_log2, -ms_b));
    }
    // l sums the fp32 P, before it is split (as both TPU kernels)
    l_a += p[0][0] + p[0][1] + p[1][0] + p[1][1];
    l_b += p[0][2] + p[0][3] + p[1][2] + p[1][3];
    // score fragment -> A fragment of P.V (the same per-warp layout)
    split_bf16(p[0][0], p[0][1], ph[kc][0], pl[kc][0]);
    split_bf16(p[0][2], p[0][3], ph[kc][1], pl[kc][1]);
    split_bf16(p[1][0], p[1][1], ph[kc][2], pl[kc][2]);
    split_bf16(p[1][2], p[1][3], ph[kc][3], pl[kc][3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N][4], float corr_a,
                                        float corr_b) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc[j][0] *= corr_a;
    acc[j][1] *= corr_a;
    acc[j][2] *= corr_b;
    acc[j][3] *= corr_b;
  }
}

template <int H, int N>
__device__ __forceinline__ void pin_acc(float (&acc)[H][N][4]) {
#pragma unroll
  for (int h = 0; h < H; ++h) pin(acc[h]);
}

template <int N>
__device__ __forceinline__ void pin_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// DP: head dim padded to 64, 128 or 256.
template <int DP, class Rows>
__global__ void __launch_bounds__(kThreads, Tune<DP>::kMinBlocks)
tile_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
            const Rows rows, int causal, float scale_log2) {
  constexpr int KEYS = Tune<DP>::kKeys;
  constexpr int STAGES = Tune<DP>::kStages;
  constexpr int AHEAD = STAGES - 1;  // K/V tiles loaded ahead of the one used
  constexpr int CH = DP / 8;          // 16-byte chunks of one row
  constexpr int NH = DP / kPvCols<DP>;  // output halves (1, or 2 at DP=256)
  constexpr int NJ = kPvCols<DP> / 8;   // 8-column fragments of one half
  constexpr int KV_TILE = KEYS * DP;  // elements of one K (or V) tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + kBlockRows * DP;  // [STAGES][K tile, V tile]

  const int b = blockIdx.x;
  const int grp = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // heaviest rows first
  const int hpg = rows.hpg;
  const int D = rows.D;
  const int total = rows.S * hpg;  // query rows of one group
  const int r0 = tile * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // row within the accumulator fragment
  const int tig = lane & 3;   // column pair within the accumulator fragment

  int len = lengths[b];
  len = len < 0 ? 0 : (len > rows.S ? rows.S : len);
  // valid keys of row r; nondecreasing in r
  auto bound_of = [&](int r) -> int {
    if (r >= total) return 0;
    return causal ? min(len, r / hpg + 1) : len;
  };

  const int kend = bound_of(min(r0 + kBlockRows, total) - 1);
  const int n_tiles = (kend + KEYS - 1) / KEYS;
  // A warp holds 16 rows; a warpgroup (4 warps) 64, and its products are
  // collective, so it skips a key tile only when none of its rows needs it.
  const int wr0 = r0 + warp * kRowsPerWarp;
  const int w_min = wr0 < total ? bound_of(wr0) : 0;
  const int bnd_a = bound_of(wr0 + gid);
  const int bnd_b = bound_of(wr0 + gid + 8);
  const int wg = warp >> 2;
  const int g_r0 = r0 + wg * 64;
  const int g_max = g_r0 < total ? bound_of(min(g_r0 + 63, total - 1)) : 0;
  const int n_wg = (g_max + KEYS - 1) / KEYS;
  const __nv_bfloat16* qs_wg = qs + wg * 64 * 64;

  auto stage = [&](int t) { return ring + (t % STAGES) * 2 * KV_TILE; };
  auto load_kv = [&](int t) {
    __nv_bfloat16* ks = stage(t);
    __nv_bfloat16* vs = ks + KV_TILE;
    const int t0 = t * KEYS;
#pragma unroll
    for (int it = 0; it < KEYS * CH / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int key = i / CH;
      const int c = i - key * CH;
      const bool ok = t0 + key < kend && c * 8 < D;
      const size_t off = ok ? rows.kv_row(b, grp, t0 + key) + c * 8 : 0;
      cp_async16(ks + swz<KEYS>(key, c), k + off, ok);
      cp_async16(vs + swz<KEYS>(key, c), v + off, ok);
    }
  };

  // Q tile: 16-byte copies, rows past the group and the D padding zeroed.
#pragma unroll
  for (int it = 0; it < kBlockRows * CH / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int row = i / CH;
    const int c = i - row * CH;
    const bool ok = r0 + row < total && c * 8 < D;
    const size_t off = ok ? rows.q_row(b, grp, r0 + row) + c * 8 : 0;
    cp_async16(qs + swz<kBlockRows>(row, c), q + off, ok);
  }
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < AHEAD; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();  // empty groups keep the count uniform
  }
  cp_async_wait<AHEAD>();  // the Q group
  fence_proxy_async();
  __syncthreads();

  float acc[NH][NJ][4];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<AHEAD - 1>();  // tile t has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();  // ... everyone's; and tile t-1's stage is free again
    if (t + AHEAD < n_tiles) load_kv(t + AHEAD);
    cp_async_commit();
    if (t >= n_wg) continue;  // warpgroup-uniform
    const int t0 = t * KEYS;
    float s[KEYS / 8][4];
    uint32_t ph[KEYS / 16][4], pl[KEYS / 16][4];
    float corr_a, corr_b;
    pin(s);
    pin_acc(acc);
    wgmma_fence();
    issue_qk<DP, KEYS>(s, qs_wg, stage(t));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    softmax_tile<KEYS>(s, t0, t0 + KEYS > w_min, bnd_a, bnd_b, tig,
                       scale_log2, m_a, m_b, l_a, l_b, corr_a, corr_b, ph, pl);
#pragma unroll
    for (int h = 0; h < NH; ++h) rescale(acc[h], corr_a, corr_b);
    pin_acc(acc);
    wgmma_fence();
    issue_pv<DP, KEYS>(acc, ph, pl, stage(t) + KV_TILE);
    wgmma_commit();
    wgmma_wait_all();
    pin_acc(acc);
    pin_regs(ph);  // P stays in its registers until the wgmma has read it
    pin_regs(pl);
  }
  cp_async_wait<0>();
  __syncthreads();  // every wgmma read of the Q tile is done

  // Epilogue: normalise, stage this warp's 16 rows in its own rows of the Q
  // tile, then 16-byte coalesced stores.
  if (wr0 >= total) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = bnd_a > 0 ? 1.f / fmaxf(l_a, 1e-30f) : 0.f;
  const float inv_b = bnd_b > 0 ? 1.f / fmaxf(l_b, 1e-30f) : 0.f;
  const int ra = warp * kRowsPerWarp + gid;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float(&a)[4] = acc[h][j];
      *reinterpret_cast<uint32_t*>(qs + swz<kBlockRows>(ra, h * NJ + j) +
                                   2 * tig) =
          pack_bf16(a[0] * inv_a, a[1] * inv_a);
      *reinterpret_cast<uint32_t*>(qs + swz<kBlockRows>(ra + 8, h * NJ + j) +
                                   2 * tig) =
          pack_bf16(a[2] * inv_b, a[3] * inv_b);
    }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < kRowsPerWarp * CH / 32; ++it) {
    const int i = lane + it * 32;
    const int row = i / CH;
    const int c = i - row * CH;
    const int r = wr0 + row;
    if (r < total && c * 8 < D)
      *reinterpret_cast<uint4*>(out + rows.q_row(b, grp, r) + c * 8) =
          *reinterpret_cast<const uint4*>(
              qs + swz<kBlockRows>(warp * kRowsPerWarp + row, c));
  }
}

template <int DP, class Rows>
int launch_dp(const __nv_bfloat16* q, const __nv_bfloat16* k,
              const __nv_bfloat16* v, const int* lengths, __nv_bfloat16* out,
              const Rows& rows, int B, int causal, cudaStream_t st) {
  constexpr int smem = smem_bytes<DP>();
  auto kernel = tile_kernel<DP, Rows>;
  // set once per instance and device, not on every launch
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const long long n_rows = (long long)rows.S * rows.hpg;
  const dim3 grid(B, rows.G, (unsigned)((n_rows + kBlockRows - 1) / kBlockRows));
  const float scale_log2 = kLog2e / sqrtf((float)rows.D);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, lengths, out, rows, causal,
                                       scale_log2);
  return (int)cudaGetLastError();
}

// Checks the shape, then launches on `stream`.  Returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernel does not take, else the
// launch's cudaGetLastError().
template <class Rows>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int N, int G, int D, int causal,
           void* stream) {
  if (B < 1 || S < 1 || G < 1 || N < G || N % G != 0 || D < 8 || D > 256 ||
      D % 8 != 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  if (((long long)S * (N / G) + kBlockRows - 1) / kBlockRows > 65535)
    return (int)cudaErrorInvalidValue;
  const Rows rows{S, N, G, D, N / G};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_dp<64>(qp, kp, vp, lp, op, rows, B, causal, st);
  if (D <= 128) return launch_dp<128>(qp, kp, vp, lp, op, rows, B, causal, st);
  return launch_dp<256>(qp, kp, vp, lp, op, rows, B, causal, st);
}

}  // namespace attn_tile

// Dynamic shared memory a launch at head dim `d` requests, in bytes.
extern "C" int attention_tile_smem_bytes(int d) {
  return d <= 64    ? attn_tile::smem_bytes<64>()
         : d <= 128 ? attn_tile::smem_bytes<128>()
                    : attn_tile::smem_bytes<256>();
}
