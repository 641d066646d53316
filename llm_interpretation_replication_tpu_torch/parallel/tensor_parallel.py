"""Megatron's tensor-parallel collectives over the mesh's ``model`` axis.

The JAX package has no counterpart: it declares GSPMD shardings
(``parallel/sharding.py``) and XLA inserts these collectives itself.  The
port is one process a rank, so the decoder's seams call them explicitly,
each a ``torch.autograd.Function`` under the convention that the loss is
computed alike on every model rank:

- :func:`copy_to_model`: identity forward, all-reduce backward.  It feeds a
  column-parallel product (Q/K/V, the MLP's up and gate, the unembedding),
  whose input gradient is partial on each rank.
- :func:`reduce_from_model`: all-reduce forward, identity backward.  It
  ends a row-parallel product (attention's output projection, the MLP's
  down projection) and the vocab-sharded embedding lookup.  (Not
  ``torch.distributed.nn.functional.all_reduce``: its backward all-reduces
  the gradient too, which counts a replicated loss once a rank.)
- :func:`gather`: all-gather along one dim forward, the rank's own slice of
  the gradient backward.  It joins vocab-sharded logits (and, in the
  pipeline, data-sharded rows).

:class:`TensorParallel` is one rank's share of a decoder: its query heads,
K/V heads, MLP columns and vocab rows, split on head boundaries and
possibly unevenly (Falcon-7B's 71 heads at 2 ranks: 36 + 35).  K/V heads
that the axis does not divide are replicated; :meth:`TensorParallel.local_kv`
then picks each local query head's K/V head.  :func:`for_mesh` gives None
for a model axis of one rank, and every seam is then the unsharded code.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .mesh import MODEL_AXIS, axis_group, axis_rank, axis_size


def split_sizes(n: int, parts: int) -> List[int]:
    """``n`` units in ``parts`` runs, the first ``n % parts`` one longer."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """(first, count) of run ``index`` of :func:`split_sizes`."""
    sizes = split_sizes(n, parts)
    return sum(sizes[:index]), sizes[index]


def _all_reduce(x, group):
    import torch.distributed as dist

    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x, dim: int, group, sizes: Sequence[int]):
    """Concatenate each rank's block along ``dim``; block r holds
    ``sizes[r]`` entries there (blocks are padded to the largest for the
    transfer)."""
    import torch.distributed as dist

    width = max(sizes)
    pad = list(x.shape)
    pad[dim] = width - x.shape[dim]
    block = (torch.cat([x, x.new_zeros(pad)], dim) if pad[dim]
             else x).contiguous()
    parts = [torch.empty_like(block) for _ in sizes]
    dist.all_gather(parts, block, group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sizes, index):
        ctx.dim, ctx.sizes, ctx.index = dim, sizes, index
        return _all_gather(x, dim, group, sizes)

    @staticmethod
    def backward(ctx, grad):
        start = sum(ctx.sizes[:ctx.index])
        return (grad.narrow(ctx.dim, start, ctx.sizes[ctx.index]),
                None, None, None, None)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One model rank's share of a decoder (all ranges are (first, count))."""
    group: object
    rank: int
    size: int
    heads: Tuple[int, int]          # query heads
    kv_heads: Tuple[int, int]       # K/V heads held: all G when replicated
    kv_replicated: bool
    group_size: int                 # query heads a K/V head
    ffn: Tuple[int, int]            # MLP columns
    vocab_sizes: Tuple[int, ...]    # every rank's vocab rows

    @property
    def vocab(self) -> Tuple[int, int]:
        return sum(self.vocab_sizes[:self.rank]), self.vocab_sizes[self.rank]

    def local_heads(self, x, dim: int = 1):
        """The rank's query heads of a per-head tensor (an ALiBi bias)."""
        return x.narrow(dim, *self.heads)

    def local_kv(self, x):
        """K or V ``[B, S, G_held, D]`` -> the K/V heads of the rank's query
        heads, grouped as ``attention_bsnd`` takes them.  Only replicated
        K/V with more than one head need a pick (one K/V head a local
        query head)."""
        if not self.kv_replicated or x.shape[2] == 1:
            return x
        first, count = self.heads
        idx = torch.arange(first, first + count, device=x.device) \
            // self.group_size
        return x.index_select(2, idx)


def for_config(cfg, group, rank: int, size: int) -> Optional[TensorParallel]:
    """The rank's share of ``cfg`` (a ``DecoderConfig``) over ``size``
    model ranks; None for one rank."""
    if size == 1:
        return None
    n, g = cfg.num_heads, cfg.num_kv_heads
    replicated = g % size != 0
    return TensorParallel(
        group=group, rank=rank, size=size,
        heads=split_range(n, size, rank),
        kv_heads=(0, g) if replicated else split_range(g, size, rank),
        kv_replicated=replicated, group_size=n // g,
        ffn=split_range(cfg.intermediate_size, size, rank),
        vocab_sizes=tuple(split_sizes(cfg.vocab_size, size)))


def for_t5(cfg, group, rank: int, size: int) -> Optional[TensorParallel]:
    """The rank's share of a T5 model (``T5Config``): its heads (K/V with
    them, held whole when the model axis does not divide the heads, as
    ``shard_params(kind="t5")`` holds them), MLP columns and vocab rows of
    the shared embedding; None for one rank."""
    if size == 1:
        return None
    n = cfg.num_heads
    replicated = n % size != 0
    return TensorParallel(
        group=group, rank=rank, size=size, heads=split_range(n, size, rank),
        kv_heads=(0, n) if replicated else split_range(n, size, rank),
        kv_replicated=replicated, group_size=1,
        ffn=split_range(cfg.d_ff, size, rank),
        vocab_sizes=tuple(split_sizes(cfg.vocab_size, size)))


def for_mesh(cfg, mesh) -> Optional[TensorParallel]:
    """:func:`for_config` (or :func:`for_t5` for a ``T5Config``) over the
    mesh's ``model`` axis."""
    make = for_t5 if hasattr(cfg, "d_kv") else for_config
    return make(cfg, axis_group(mesh, MODEL_AXIS),
                axis_rank(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS))


def copy_to_model(x, tp: TensorParallel):
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x, tp: TensorParallel):
    return _ReduceFromModel.apply(x, tp.group)


def gather(x, dim: int, group, sizes: Sequence[int], index: int):
    """All-gather ``x`` along ``dim`` over ``group`` (rank ``index`` of it
    holds ``sizes[index]`` entries); backward keeps the rank's slice."""
    return _Gather.apply(x, dim, group, tuple(sizes), index)


def gather_vocab(logits, tp: TensorParallel):
    """Vocab-sharded logits ``[..., V_r]`` -> full ``[..., V]``."""
    return gather(logits, logits.dim() - 1, tp.group, tp.vocab_sizes, tp.rank)
