"""Mixture-of-Experts MLP with expert parallelism (GShard's all_to_all).

Port of ``llm_interpretation_replication_tpu/ops/moe.py`` (which has no
Pallas kernel: its products are plain ops there, and PyTorch ops here).
Two interchangeable compute paths over one parameter layout:

- :func:`moe_mlp_dense`: every expert computed for every token, masked and
  combined by the router gates.  Exact semantics, O(E·T·F) operations; the
  correctness oracle.
- :func:`moe_mlp_sharded`: experts split over a mesh axis (one process a
  rank), tokens routed with capacity-C one-hot dispatch tensors, moved to
  their expert's rank with ``all_to_all_single``
  (``parallel/ulysses._all_to_all``), computed there and combined on the
  way back.  O(T·K·F) operations plus two all_to_alls.

Router: softmax over all experts, top-k, the selected probabilities
renormalized (Mixtral's), with the Switch Transformer's auxiliary
load-balancing loss.  The top-k keeps ``lax.top_k``'s order: descending,
and of equal probabilities the lower expert index first (a stable sort).
``activation`` defaults to ``jax.nn.gelu``'s, the tanh approximation.

Parameter layout (the leading ``E`` axis splits over the expert axis):
  ``{"router": [H, E], "wi": [E, H, F], "wo": [E, F, H]}``
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

#: ``jax.nn.gelu``'s default: the tanh approximation
gelu = functools.partial(F.gelu, approximate="tanh")


def init_moe_params(generator: torch.Generator, hidden: int, ffn: int,
                    num_experts: int, dtype=torch.float32, device=None):
    """Random parameters, N(0, 0.02^2), drawn from ``generator`` (router,
    then ``wi``, then ``wo``; on ``device``, default the generator's)."""
    device = device or generator.device
    scale = 0.02

    def draw(*shape):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    return {
        "router": draw(hidden, num_experts),
        "wi": draw(num_experts, hidden, ffn),
        "wo": draw(num_experts, ffn, hidden),
    }


def route(params, x, top_k: int, renormalize: bool = True):
    """Top-k routing.  x: [T, H] -> (gates [T, K], indices [T, K] int32,
    probs [T, E], the full softmax for the aux loss)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = order.values[:, :top_k]
    indices = order.indices[:, :top_k].to(torch.int32)
    if renormalize:
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return gates, indices, probs


def routing_stats(probs, indices, num_experts: int):
    """Per expert: the fraction of tokens routed to it first, and its mean
    router probability; the aux loss's two statistics.  The sharded path
    averages them over the ranks before the product, so its loss is the
    single device's."""
    one_hot = F.one_hot(indices[..., 0].long(), num_experts).to(probs.dtype)
    return one_hot.mean(dim=0), probs.mean(dim=0)


def aux_loss_from_stats(fraction, mean_prob, num_experts: int):
    """Switch Transformer's aux loss: E · sum_e fraction_e × mean_prob_e,
    least at uniform routing."""
    return num_experts * torch.sum(fraction * mean_prob)


def load_balancing_loss(probs, indices, num_experts: int):
    fraction, mean_prob = routing_stats(probs, indices, num_experts)
    return aux_loss_from_stats(fraction, mean_prob, num_experts)


def _expert_ffn(wi, wo, x, activation):
    return activation(x @ wi) @ wo


def moe_mlp_dense(params, x, top_k: int = 2, activation=gelu,
                  renormalize: bool = True):
    """The oracle: every expert on every token, gate-combined.  x: [T, H]
    -> ([T, H], aux loss)."""
    num_experts = params["router"].shape[-1]
    gates, indices, probs = route(params, x, top_k, renormalize)
    # [E, T, H]: every expert applied to every token
    expert_out = torch.stack([
        _expert_ffn(params["wi"][e], params["wo"][e], x, activation)
        for e in range(num_experts)])
    # combine weights [T, E]: the gate where selected, 0 elsewhere; float32,
    # as the reference's float32 gates promote them
    combine = torch.zeros((x.shape[0], num_experts), dtype=torch.float32,
                          device=x.device)
    for k in range(top_k):
        combine = combine + gates[:, k, None] * F.one_hot(
            indices[:, k].long(), num_experts).float()
    out = torch.einsum("te,eth->th", combine, expert_out.float())
    return out.to(x.dtype), load_balancing_loss(probs, indices, num_experts)


def _dispatch_tensors(gates, indices, num_experts: int, capacity: int):
    """Capacity-C one-hot dispatch and combine tensors of a top-k routing.

    gates/indices: [T, K].  Returns (dispatch [T, E, C] one-hot, combine
    [T, E, C] gate-weighted).  Token t's k-th choice takes expert e's c-th
    capacity slot, c counting the earlier claims on e in k-major order (all
    first choices before any second); choices past the capacity are dropped
    (GShard's overflow)."""
    t, k = gates.shape
    flat_idx = indices.T.reshape(-1).long()              # [K*T], k-major
    flat_gate = gates.T.reshape(-1).float()
    onehot = F.one_hot(flat_idx, num_experts).float()    # [KT, E]
    position = torch.cumsum(onehot, dim=0) * onehot - 1.0
    keep = (position >= 0) & (position < capacity)
    # one_hot of a slot past the capacity is all zeros, as jax.nn.one_hot
    # gives it (the index is clamped only so that F.one_hot takes it)
    at = position.max(dim=-1).values.to(torch.int64)
    slot = (F.one_hot(at.clamp(0, capacity - 1), capacity).float()
            * ((at >= 0) & (at < capacity)).float()[:, None])
    dispatch_flat = (onehot[:, :, None] * slot[:, None, :]
                     * keep.any(-1).float()[:, None, None])
    combine_flat = dispatch_flat * flat_gate[:, None, None]
    dispatch = dispatch_flat.reshape(k, t, num_experts, capacity).sum(dim=0)
    combine = combine_flat.reshape(k, t, num_experts, capacity).sum(dim=0)
    return dispatch, combine


def moe_mlp_sharded(params, x, mesh, axis_name: str = "data",
                    top_k: int = 2, capacity_factor: float = 2.0,
                    activation=gelu, renormalize: bool = True):
    """Expert-parallel MoE over the ``axis_name`` axis of ``mesh``: each rank
    of the axis holds ``E / n`` experts and ``B / n`` tokens, routes its
    tokens into capacity slots, sends each expert's slots to its rank, runs
    its experts there and sends the results back.

    Takes the whole ``params`` and ``x`` [B, H] on every rank (the rank's
    experts and tokens are blocks of them) and returns ([B, H], aux loss),
    whole on every rank, as the reference's ``shard_map`` does; they match
    :func:`moe_mlp_dense` wherever no token overflowed an expert's
    capacity, ``max(1, int(capacity_factor * top_k * B/n / E))`` slots."""
    import torch.distributed as dist

    from ..parallel.mesh import axis_group, axis_rank, axis_size
    from ..parallel.ulysses import _all_to_all

    num_experts = params["router"].shape[-1]
    n = axis_size(mesh, axis_name)
    if num_experts % n:
        raise ValueError(f"{num_experts} experts not divisible over {n} "
                         f"shards")
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} tokens not divisible over {n} "
                         f"shards")
    group = axis_group(mesh, axis_name)
    me = axis_rank(mesh, axis_name)
    local = num_experts // n
    t = x.shape[0] // n
    xb = x[me * t:(me + 1) * t]
    wi = params["wi"][me * local:(me + 1) * local]
    wo = params["wo"][me * local:(me + 1) * local]
    capacity = max(1, int(capacity_factor * top_k * t / num_experts))
    gates, indices, probs = route(params, xb, top_k, renormalize)
    dispatch, combine = _dispatch_tensors(gates, indices, num_experts,
                                          capacity)
    buf = torch.einsum("tec,th->ech", dispatch, xb.float())
    # [E, C, H] -> [n, E/n*C, H] -> all_to_all -> [E/n, n*C, H]: each rank
    # holds, for each of its experts, the C slots from every source rank
    h = buf.shape[-1]
    buf = buf.reshape(n, local * capacity, h)
    if n > 1:
        buf = _all_to_all(buf, group)
    buf = buf.reshape(n, local, capacity, h).transpose(0, 1).reshape(
        local, n * capacity, h)
    out = torch.stack([_expert_ffn(wi[e].float(), wo[e].float(), buf[e],
                                   activation) for e in range(local)])
    # the way back, to [E, C, H] on the rank that owns the tokens
    out = out.reshape(local, n, capacity, h).transpose(0, 1).reshape(
        n, local * capacity, h)
    if n > 1:
        out = _all_to_all(out, group)
    out = out.reshape(num_experts, capacity, h)
    y = torch.einsum("tec,ech->th", combine, out).to(x.dtype)
    # the global aux loss: the routing stats averaged over the ranks
    # before the product, so that it equals the single device's
    frac, mean_prob = routing_stats(probs, indices, num_experts)
    stats = torch.stack([frac, mean_prob])
    if n > 1:
        dist.all_reduce(stats, group=group)
        stats = stats / n
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        y = torch.cat(parts)
    return y, aux_loss_from_stats(stats[0], stats[1], num_experts)
