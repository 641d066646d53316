"""Ulysses-style all-to-all sequence parallelism.

Port of ``llm_interpretation_replication_tpu/parallel/ulysses.py``, the
second long-context strategy beside the ring
(``parallel/ring_attention.py``): one all-to-all
(``torch.distributed.all_to_all_single`` on contiguous blocks) turns the
sequence-sharded activations into head-sharded ones, each rank runs dense
attention over the full sequence for its heads, and a second all-to-all
restores sequence sharding (DeepSpeed-Ulysses, arXiv:2309.14509).  It needs
``num_heads`` divisible by the seq-axis size; the ring does not.  Forward
only, like the ring.
"""

from __future__ import annotations

import torch

from .ring_attention import (_block_bias, _group_size, _refuse_grad, _scale,
                             sharded_seq_attention)


def _all_to_all(blocks, group):
    """``blocks`` [n, ...]: block j goes to rank j; returns [n, ...] with
    block j from rank j."""
    import torch.distributed as dist

    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    return out


def _all_gather_seq(x, group, n):
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, 1)


def ulysses_attention(
    q,            # [B, S/n, N, D]  sequence-sharded local block
    k,            # [B, S/n, N, D]
    v,            # [B, S/n, N, D]
    q_pos,        # [B, S/n]  absolute positions of local queries
    kv_valid,     # [B, S/n]  bool validity of local keys
    group=None,   # the seq axis's process group (None: one rank)
    causal: bool = True,
):
    """Per-rank Ulysses body over ``group``: all-to-all #1 seq-sharded
    [B, S/n, N, D] -> head-sharded [B, S, N/n, D]; dense attention over the
    full sequence locally; all-to-all #2 back."""
    _refuse_grad("ulysses_attention", q, k, v)
    n = _group_size(group)
    b, s_local, nh, d = q.shape
    if nh % n != 0:
        raise ValueError(f"num_heads {nh} not divisible by seq axis {n}")
    h = nh // n

    def scatter_heads(x):
        if n == 1:
            return x
        # head block j to rank j; rank j's sequence block lands j-th
        blocks = x.reshape(b, s_local, n, h, d).permute(2, 0, 1, 3, 4)
        got = _all_to_all(blocks, group)                 # [n, B, S/n, h, D]
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * s_local, h, d)

    qg, kg, vg = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if n > 1:
        pos = _all_gather_seq(q_pos, group, n)
        valid = _all_gather_seq(kv_valid.to(torch.uint8), group, n).bool()
    else:
        pos, valid = q_pos, kv_valid
    scores = torch.einsum("bsnd,btnd->bnst", qg * _scale(qg).to(qg.device),
                          kg).float()
    scores = scores + _block_bias(pos, pos, valid, causal)
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    out = torch.einsum("bnst,btnd->bsnd", probs, vg)          # [B, S, h, D]
    # a row with no valid key anywhere softmaxes uniformly: zero it, as the
    # ring's guard does
    out = torch.where(valid.any(-1)[:, None, None, None], out, 0.0)
    if n == 1:
        return out
    # inverse: sequence block j to rank j, heads from rank j land j-th
    blocks = out.reshape(b, n, s_local, h, d).permute(1, 0, 2, 3, 4)
    got = _all_to_all(blocks, group)                     # [n, B, S/n, h, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s_local, nh, d)


def ulysses_attention_sharded(mesh, q, k, v, attention_mask,
                              causal: bool = True):
    """Drive Ulysses attention over a (data, model, seq) mesh -- the same
    calling convention (and shared driver) as ``ring_attention_sharded``.

    q/k/v: [B, S, N, D] with S divisible by the seq-axis size and N divisible
    by seq_axis * model_axis; attention_mask [B, S]."""
    def body(q, k, v, pos, val, group):
        return ulysses_attention(q, k, v, pos, val, group, causal)

    return sharded_seq_attention(mesh, body, q, k, v, attention_mask)
