// Head-major, length-masked attention for Hopper (sm_90a), bf16 in and out.
//
// Two entry points, one per Pallas TPU kernel of
// llm_interpretation_replication_tpu/ops/attention.py that they replace:
//
//   grouped_attention_bf16  <- `_grouped_kernel` (behind `grouped_attention`)
//   flash_attention_bf16    <- `_flash_kernel`   (behind `flash_attention`)
//
// The flash entry runs attention_tile.cuh's main loop (asynchronous K/V
// ring, wgmma, 16-byte Q/O staging, heaviest blocks first) on head-major
// rows: a block is 128 positions of one head.  The grouped entry runs
// `head_major_kernel` below, the design described next.
//
// Both compute
//
//   q [B, N, S, D], k/v [B, G, S, D] with N % G == 0, lengths [B] int32
//     ->  out [B, N, S, D]
//   out[b, n, p] = softmax_j(q[b,n,p] . k[b,g(n),j] / sqrt(D)) . v[b,g(n),j]
//   over the keys j < bound(b, p) = min(length[b], p + 1)   (causal)
//                                 = length[b]                (causal == 0)
//   and a row whose bound is 0 is written as exact zeros.
//
// The grouped entry takes K/V unrepeated (G K/V heads, Falcon's G = 1); the
// flash entry takes K/V already repeated to N heads (G == N), as the
// reference's dispatcher hands them to `_flash_kernel`.  Rows past a row's
// length are not zero: they attend min(length, p + 1) keys, as on the TPU.
//
// Precision.  Q.K runs on bf16 operands with fp32 accumulation; a product of
// two bf16 values is exact in fp32, so this is the flash TPU kernel's fp32
// Q.K (it upcasts q, K and V) up to summation order, and the grouped TPU
// kernel's own bf16 Q.K.  The 1/sqrt(D) scale goes onto the fp32 scores
// (the flash TPU kernel scales q first; scaling q and rounding it back to
// bf16 would lose bits when sqrt(D) is not a power of two).  Softmax is
// fp32.  P enters P.V as a bf16 high part plus a bf16 residual, ~16
// significant bits: the flash TPU kernel's P.V is fp32; the grouped TPU
// kernel rounds P to bf16 first, but that rounding alone put the Falcon-7B
// causal shape past the port's 1e-2 bf16 gate against the float32 plain
// version on the card, so the grouped entry keeps the split too.
// The TPU's grouped kernel holds a whole [rows, S] fp32 score block in VMEM
// and softmaxes it in one pass; a Hopper block cannot hold that at S = 2048,
// so both entries use an online softmax over key tiles.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the Falcon-7B
// prefill shape (B=32, S=448, N=71, G=1, D=64) q and out are 130 MB each and
// K/V 71x less, ~78 us of bytes against ~58 us of causal tensor-core work, so
// the grouped entry is bound by bytes; the flash entry also reads K/V
// repeated to 71 heads (2 x 130 MB more), ~156 us, bound by bytes too.  The
// design keeps every byte of q/out to one read and one write, every score in
// registers, and stages each K/V tile once in shared memory for all the
// query rows that share it.
//
// Design of `head_major_kernel` (the grouped entry).
// - One block per (batch, K/V group, tile of 128 consecutive (position, head)
//   rows of that group, position-major).  For Falcon's 71 heads on one K/V
//   head a tile is ~1.8 positions x all heads, so the causal bounds of a
//   block's rows are nearly equal and the block skips the same key tiles
//   everywhere.  Each row of q/out is D contiguous values, read and written
//   once.
// - Eight warps, 16 rows each; Q.K and P.V on the tensor cores with
//   mma.sync m16n8k16 (bf16 operands, fp32 accumulators); the score fragment
//   is re-used in registers as the A operand of P.V; m, l and the output
//   accumulator are fp32.
// - The key loop of a block stops at the largest bound among its rows; a warp
//   skips the tiles past its own rows' bound and masks only the tiles that
//   cross its smallest bound.  No TPU tiling limit remains: any S >= 1, any
//   N/G, any D <= 128 with D % 8 == 0 (padded to 64 or 128 with zeros inside
//   shared memory and registers).
// - Plain C interface, loaded with ctypes; launches on the caller's stream and
//   returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // 128 (position, head) rows
constexpr int kBlockKeys = 64;
constexpr float kNegInf = -1e9f;  // finite, as in the reference
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(p); lo = bf16(p - hi): the pair carries p to ~16 bits.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  float r0 = p0 - __bfloat162float(h.x);
  float r1 = p1 - __bfloat162float(h.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(r0, r1);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D[16x8] += A[16x16] . B[16x8]; bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// DP: head dim padded to a multiple of 16 (64 or 128).
template <int DP>
__global__ void __launch_bounds__(kThreads)
head_major_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out, int S, int N, int G, int D,
                  int causal, float scale_log2) {
  constexpr int KS = DP + 8;          // smem row stride of K (elements)
  constexpr int VS = kBlockKeys + 8;  // smem row stride of V^T
  constexpr int KK = DP / 16;         // k16 steps over the head dim
  constexpr int DT = DP / 8;          // n8 tiles of the output
  constexpr int NT = kBlockKeys / 8;  // n8 tiles of one score tile
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockKeys * KS];
  __shared__ __align__(16) __nv_bfloat16 vt[DP * VS];

  const int hpg = N / G;
  const int total = S * hpg;  // (position, head) rows of one group
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // row within the mma fragment
  const int tig = lane & 3;   // column pair within the mma fragment

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  // valid keys of row r; nondecreasing in r (rows are position-major)
  auto bound_of = [&](int r) -> int {
    if (r >= total) return 0;
    return causal ? min(len, r / hpg + 1) : len;
  };
  auto row_offset = [&](int r) -> size_t {  // element offset in q / out
    const int p = r / hpg;
    const int h = r - p * hpg;
    return ((size_t)(b * N + grp * hpg + h) * S + p) * D;
  };

  const int kend = bound_of(min(r0 + kBlockRows, total) - 1);
  const int wr0 = r0 + warp * kRowsPerWarp;
  const bool warp_active = wr0 < total;
  const int w_max = warp_active ? bound_of(min(wr0 + 15, total - 1)) : 0;
  const int w_min = warp_active ? bound_of(wr0) : 0;
  const int row_a = wr0 + gid;
  const int row_b = row_a + 8;
  const int bnd_a = bound_of(row_a);
  const int bnd_b = bound_of(row_b);

  // Q fragments straight from device memory: each byte of q is read once.
  uint32_t qf[KK][4];
  {
    const bool va = row_a < total, vb = row_b < total;
    const __nv_bfloat16* qa = q + (va ? row_offset(row_a) : 0);
    const __nv_bfloat16* qb = q + (vb ? row_offset(row_b) : 0);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c0 = kk * 16 + 2 * tig;
      const int c1 = c0 + 8;
      qf[kk][0] = (va && c0 < D) ? ld32(qa + c0) : 0u;
      qf[kk][1] = (vb && c0 < D) ? ld32(qb + c0) : 0u;
      qf[kk][2] = (va && c1 < D) ? ld32(qa + c1) : 0u;
      qf[kk][3] = (vb && c1 < D) ? ld32(qb + c1) : 0u;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  // K/V rows of this (batch, group): S contiguous rows of D values
  const size_t kv_base = (size_t)(b * G + grp) * S * D;

  for (int t0 = 0; t0 < kend; t0 += kBlockKeys) {
    __syncthreads();  // the previous tile is no longer read
    constexpr int CH = DP / 8;  // 16-byte chunks of one key row
    for (int i = threadIdx.x; i < kBlockKeys * CH; i += kThreads) {
      const int key = i / CH;
      const int c = (i - key * CH) * 8;
      const int gk = t0 + key;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = make_uint4(0u, 0u, 0u, 0u);
      if (gk < kend && c < D) {  // keys past the bound are zeros, never NaN
        const size_t off = kv_base + (size_t)gk * D + c;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[key * KS + c]) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * VS + key] = ve[j];
    }
    __syncthreads();
    if (!warp_active || t0 >= w_max) continue;  // warp-uniform

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = &ks[(j * 8 + gid) * KS + 2 * tig];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        mma16816(s[j], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    // scale the fp32 scores into the exp2 domain, then mask (only the tiles
    // crossing a bound)
    const bool masked = t0 + kBlockKeys > w_min;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
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
    // score from then on and a fully masked later tile contributes exp2 = 0.
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = exp2f(m_a - mn_a);
    const float corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr_a;
      acc[j][1] *= corr_a;
      acc[j][2] *= corr_b;
      acc[j][3] *= corr_b;
    }
#pragma unroll
    for (int kc = 0; kc < kBlockKeys / 16; ++kc) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h][0] = exp2f(s[2 * kc + h][0] - m_a);
        p[h][1] = exp2f(s[2 * kc + h][1] - m_a);
        p[h][2] = exp2f(s[2 * kc + h][2] - m_b);
        p[h][3] = exp2f(s[2 * kc + h][3] - m_b);
      }
      // l sums the fp32 P, before it is split (as both TPU kernels)
      l_a += p[0][0] + p[0][1] + p[1][0] + p[1][1];
      l_b += p[0][2] + p[0][3] + p[1][2] + p[1][3];
      uint32_t ph[4], pl[4];  // score fragment -> A fragment of P.V
      split_bf16(p[0][0], p[0][1], ph[0], pl[0]);
      split_bf16(p[0][2], p[0][3], ph[1], pl[1]);
      split_bf16(p[1][0], p[1][1], ph[2], pl[2]);
      split_bf16(p[1][2], p[1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vr = &vt[(j * 8 + gid) * VS + kc * 16 + 2 * tig];
        const uint32_t b0 = ld32(vr);
        const uint32_t b1 = ld32(vr + 8);
        mma16816(acc[j], ph, b0, b1);
        mma16816(acc[j], pl, b0, b1);
      }
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = bnd_a > 0 ? 1.f / fmaxf(l_a, 1e-30f) : 0.f;
  const float inv_b = bnd_b > 0 ? 1.f / fmaxf(l_b, 1e-30f) : 0.f;
  if (row_a < total) {
    __nv_bfloat16* oa = out + row_offset(row_a);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c < D)
        *reinterpret_cast<uint32_t*>(oa + c) =
            pack_bf16(acc[j][0] * inv_a, acc[j][1] * inv_a);
    }
  }
  if (row_b < total) {
    __nv_bfloat16* ob = out + row_offset(row_b);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c < D)
        *reinterpret_cast<uint32_t*>(ob + c) =
            pack_bf16(acc[j][2] * inv_b, acc[j][3] * inv_b);
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int N, int G, int D, int causal,
           void* stream) {
  if (B < 1 || S < 1 || G < 1 || N < G || N % G != 0 || D < 8 || D > 128 ||
      D % 8 != 0 || B > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)S * (N / G);
  const dim3 grid((unsigned)((rows + kBlockRows - 1) / kBlockRows), G, B);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  const int* lp = static_cast<const int*>(lengths);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (D <= 64)
    head_major_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, lp, op, S, N, G, D, causal, scale_log2);
  else
    head_major_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, lp, op, S, N, G, D, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel
// does not take, else cudaGetLastError() right after the launch.

// q [B, N, S, D], unrepeated k/v [B, G, S, D].
extern "C" int grouped_attention_bf16(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int S, int N, int G,
                                      int D, int causal, void* stream) {
  return launch(q, k, v, lengths, out, B, S, N, G, D, causal, stream);
}

// q, k, v [B, N, S, D]: K/V repeated to the N query heads (G == N).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int S, int N, int G,
                                    int D, int causal, void* stream) {
  if (G != N) return (int)cudaErrorInvalidValue;
  return attn_tile::launch<attn_tile::BnsdRows>(q, k, v, lengths, out, B, S,
                                                N, G, D, causal, stream);
}
