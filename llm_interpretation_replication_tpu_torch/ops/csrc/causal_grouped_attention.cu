// Causal, length-masked grouped attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel `_causal_grouped_kernel` behind
// `causal_grouped_attention` in llm_interpretation_replication_tpu/ops/attention.py.
// It computes the same function:
//
//   q [B, S, N, D], k/v [B, S, G, D] with N % G == 0 (K/V not repeated),
//   lengths [B] int32  ->  out [B, S, N, D]
//   out[b, p, n] = softmax_j(q[b,p,n] . k[b,j,g(n)] / sqrt(D)) . v[b,j,g(n)]
//   over the keys j < bound(b, p) = min(length[b], p + 1)   (causal)
//                                 = length[b]                (causal == 0)
//   and a row whose bound is 0 is written as exact zeros.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the Falcon-7B
// prefill shape (B=32, S=432, N=71, G=1, D=64) one call moves ~255 MB (q and
// out dominate; K/V are 71x smaller) = ~76 us, against ~5.4e10 causal FLOPs =
// ~55 us, so the kernel is bound by bytes.  Each byte of q/out is read and
// written once, with 16-byte accesses, and no score leaves the chip.
//
// The main loop is attention_tile.cuh's, on the projection layout's rows: a
// block is 128 consecutive (position, head) rows of one K/V group.  For MQA
// the 71 heads of one position are adjacent rows, so a block's q/out rows are
// one contiguous 16 KB run and each K/V tile, staged once in shared memory,
// serves every head of the group -- the MQA saving the TPU kernel made in
// VMEM.  Plain C interface, loaded with ctypes; launches on the caller's
// stream and returns cudaGetLastError().

#include "attention_tile.cuh"

// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel does not
// take, else cudaGetLastError() right after the launch.
extern "C" int causal_grouped_attention_bf16(const void* q, const void* k,
                                             const void* v, const void* lengths,
                                             void* out, int B, int S, int N,
                                             int G, int D, int causal,
                                             void* stream) {
  return attn_tile::launch<attn_tile::BsndRows>(q, k, v, lengths, out, B, S, N,
                                                G, D, causal, stream);
}
