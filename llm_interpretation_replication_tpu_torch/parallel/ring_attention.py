"""Ring attention: sequence/context parallelism over the ``seq`` mesh axis.

Port of ``llm_interpretation_replication_tpu/parallel/ring_attention.py``.
Each rank keeps its query block while the K/V blocks (with their positions
and validity) rotate one hop a step around the ``seq`` group, sent and
received together by ``torch.distributed.batch_isend_irecv``; the partial
results combine by an online (flash-style) softmax, so a rank holds
O(S/n) K/V.

``ring_attention`` is the per-rank body; ``ring_attention_sharded`` takes
the whole ``[B, S, N, D]`` tensors on every rank, runs each rank's block
(batch over ``data``, heads over ``model``, sequence over ``seq``) and
returns the whole result on every rank.  Forward only: the hand-offs carry
no gradient, so an input that requires grad under grad mode raises.
"""

from __future__ import annotations

import math

import torch

from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, axis_group, axis_rank, \
    axis_size

NEG_INF = -1e9


def _refuse_grad(what, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is forward-only: its collectives carry no gradient")


def _group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def _block_bias(q_pos, kv_pos, kv_valid, causal: bool):
    """fp32 additive bias [B, 1, Sq, Skv] from absolute positions."""
    ok = kv_valid[:, None, :]
    if causal:
        ok = ok & (q_pos[:, :, None] >= kv_pos[:, None, :])
    return torch.where(ok[:, None], 0.0, NEG_INF).float()


def _rotate(tensors, group):
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's (one hop around the ring)."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    tensors = [t.contiguous() for t in tensors]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [op for t, b in zip(tensors, bufs) for op in (
        dist.P2POp(dist.isend, t, nxt, group),
        dist.P2POp(dist.irecv, b, prv, group))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return bufs


def _scale(q):
    """1/sqrt(d) in q's dtype, as the reference rounds it."""
    d = q.shape[-1]
    return 1.0 / torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype)


def ring_attention(
    q,            # [B, Sq, N, D]  local query block
    k,            # [B, Skv, N, D] local key block (rotates)
    v,            # [B, Skv, N, D]
    q_pos,        # [B, Sq]  absolute positions of local queries
    kv_pos,       # [B, Skv] absolute positions of local keys
    kv_valid,     # [B, Skv] bool validity of local keys
    group=None,   # the seq axis's process group (None: one rank)
    causal: bool = True,
):
    """Per-rank ring attention body over ``group``."""
    import torch.distributed as dist

    _refuse_grad("ring_attention", q, k, v)
    n = _group_size(group)
    b, sq, nh, d = q.shape
    qs = q * _scale(q).to(q.device)
    m = torch.full((b, nh, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nh, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, nh, d), dtype=torch.float32, device=q.device)
    # rows with no valid key on ANY rank (from the local block, before it
    # rotates away)
    has_key = kv_valid.any(-1).to(torch.int32)
    valid = kv_valid.to(torch.uint8)        # gloo sends no bool
    for step in range(n):
        scores = torch.einsum("bsnd,btnd->bnst", qs, k).float()
        scores = scores + _block_bias(q_pos, kv_pos, valid.bool(), causal)
        m_new = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * correction + p.sum(-1)
        pv = torch.einsum("bnst,btnd->bsnd", p.to(v.dtype), v).float()
        o = o * correction.transpose(1, 2)[..., None] + pv
        m = m_new
        if step + 1 < n:
            k, v, kv_pos, valid = _rotate([k, v, kv_pos, valid], group)
    denom = l.transpose(1, 2)[..., None]
    out = torch.where(denom > 0, o / torch.clamp(denom, min=1e-30), 0.0)
    # the finite NEG_INF bias makes a row with no valid key anywhere a
    # softmax of garbage: zero it (as the Ulysses leg does)
    if n > 1:
        dist.all_reduce(has_key, group=group)
    out = torch.where(has_key[:, None, None, None] > 0, out, 0.0)
    return out.to(q.dtype)


def _split(x, dim, mesh, axis):
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible over "
                         f"{n} {axis} ranks")
    per = x.shape[dim] // n
    return x.narrow(dim, axis_rank(mesh, axis) * per, per)


def _join(x, dim, mesh, axis):
    import torch.distributed as dist

    group = axis_group(mesh, axis)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def sharded_seq_attention(mesh, body, q, k, v, attention_mask):
    """Shared driver of every sequence-parallel attention strategy (ring,
    Ulysses): batch over ``data``, heads over ``model``, sequence over
    ``seq``.  Takes the whole tensors on every rank and returns the whole
    result on every rank; ``body(q, k, v, pos, valid, group)`` is the
    per-rank computation over the seq group."""
    b, s, nh, d = q.shape
    positions = torch.arange(s, dtype=torch.int64,
                             device=q.device)[None].expand(b, s)
    valid = attention_mask.bool()

    def local(x, heads=True):
        x = _split(_split(x, 0, mesh, DATA_AXIS), 1, mesh, SEQ_AXIS)
        return _split(x, 2, mesh, MODEL_AXIS) if heads else x

    out = body(local(q), local(k), local(v), local(positions, False),
               local(valid, False), axis_group(mesh, SEQ_AXIS))
    out = _join(out, 2, mesh, MODEL_AXIS)
    out = _join(out, 1, mesh, SEQ_AXIS)
    return _join(out, 0, mesh, DATA_AXIS)


def ring_attention_sharded(mesh, q, k, v, attention_mask, causal: bool = True):
    """Drive ring attention over a (data, model, seq) mesh.

    q/k/v: [B, S, N, D] with S divisible by the seq-axis size; attention_mask
    [B, S]."""
    def body(q, k, v, pos, val, group):
        return ring_attention(q, k, v, pos, pos, val, group, causal)

    return sharded_seq_attention(mesh, body, q, k, v, attention_mask)
