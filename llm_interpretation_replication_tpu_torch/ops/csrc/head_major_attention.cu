// Head-major, length-masked attention for Hopper (sm_90a), bf16 in and out.
//
// Two entry points, one per Pallas TPU kernel of
// llm_interpretation_replication_tpu/ops/attention.py that they replace:
//
//   grouped_attention_bf16  <- `_grouped_kernel` (behind `grouped_attention`)
//   flash_attention_bf16    <- `_flash_kernel`   (behind `flash_attention`)
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
// flash entry takes K/V already repeated to N heads, as the reference's
// dispatcher hands them to `_flash_kernel`, and is the same launch with a
// G == N check.  Rows past a row's length are not zero: they attend
// min(length, p + 1) keys, as on the TPU.
//
// Design: both entries run attention_tile.cuh's main loop (an asynchronous
// 3-stage `cp.async` K/V ring zero-filled past the bound and the D padding,
// 128-byte-swizzled tiles, `wgmma` for Q.K and for P.V with V transposed by
// the instruction, Q and O staged through shared memory with 16-byte
// accesses, heaviest row tiles first) with the head-major row policy
// `BnsdRows`.  The rows of one (batch, K/V group) are numbered
// position-major across the group's hpg = N / G heads, so a 128-row block
// holds ~1.8 positions x 71 heads at Falcon-7B (32 positions x 4 heads at
// GQA with hpg = 4): the causal bounds of a block's rows are nearly equal,
// and each K/V tile is staged once in shared memory for every head that
// reads it.  The flash entry's hpg is 1: a block is 128 positions of one
// head.
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
// repeated to 71 heads (71x the grouped entry's K/V, 2 x 130 MB more),
// ~156 us, bound by bytes too.  The design keeps every byte of q/out to one
// read and one write, every score in registers, and each K/V tile to one
// copy into shared memory for all the query rows that share it.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream.

#include "attention_tile.cuh"

// Each returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel
// does not take, else cudaGetLastError() right after the launch.

// q [B, N, S, D], unrepeated k/v [B, G, S, D].
extern "C" int grouped_attention_bf16(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int S, int N, int G,
                                      int D, int causal, void* stream) {
  return attn_tile::launch<attn_tile::BnsdRows>(q, k, v, lengths, out, B, S,
                                                N, G, D, causal, stream);
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
