"""The model's device entry points on a mesh of ranks, for the scoring engine.

The reference engine places each batch's rows over the mesh's ``data`` axis
(``_put``) and lets GSPMD shard the weights over ``model``; every host
decision then reads whole arrays.  PyTorch runs one process a rank, and
every rank runs the engine's host code on the same prompts, so the port
keeps the engine's tensors whole on every rank and makes each device call
row-parallel: :class:`RowParallel` takes the rank's rows of the call's
batched inputs (``parallel.mesh.data_rows``), runs the model function on
them with the rank's share of the weights (``tp``, the mesh's ``model``
axis), and gathers the outputs back over ``data``
(``parallel.mesh.gather_rows``).  So each call's results -- logits, the
position-0 scan's inputs, per-step scores, tokens, and the KV cache --
are whole and equal on every rank before any host decision reads them:
buckets, the pooled selection, slot refills and retirements come out the
same everywhere.  Ranks along ``seq`` compute the same rows (the reference
only replicates over it).

Rows the data axis does not divide (a pooled flush, a ring, a look-ahead
subset) are split all the same, a short block filled out with copies of
row 0 that the gather drops (``parallel.mesh.data_rows``); the reference
raises on such a batch (``jax.device_put``).

Departure from GSPMD: the KV cache between calls is held whole on every
rank (the data axis splits the compute, not the cache), so the plan
search counts it whole on each rank (``plan_search.sharded_need_bytes``).
A call's outputs move in one ``all_gather``; a call that extends its
input cache (``decode_steps``, ``extend_prefill``) gathers only the slots
it appended, and a K-token verify pass (``k_verify_block``) the slots its
block wrote into the chunk's tail.

The OOM ladder.  With one rank on ``model`` a forward holds no collective
until its gather, so the ranks agree on its outcome first
(``parallel.mesh.agree``, an all-reduce MAX): an OOM on any rank raises an
OOM on every rank, and the engine's ladder steps all of them down alike.
With more than one rank on ``model`` an OOM can strike inside a forward
while the other ranks wait in its collectives; the error is then final
(``_no_rebatch``), and the other ranks end with an error when the group's
timeout expires.
"""

from __future__ import annotations

import torch

from ..models import decoder as dmod
from ..models import t5 as t5mod
from ..parallel import tensor_parallel
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, agree, axis_size,
                             data_rows, gather_rows)
from . import faults, strict

_OK, _OOM, _FAILED = 0, 1, 2


class PeerRankFailed(RuntimeError):
    """Another rank of the mesh failed the device call this rank ran."""


def _rows(x) -> int:
    return x.k.shape[1] if isinstance(x, dmod.KVCache) else x.shape[0]


def _map(obj, tensor_fn, cache_fn):
    """``tensor_fn`` on every batched tensor of a call's arguments or
    results (dim >= 1), ``cache_fn`` on a KVCache; the rest as it is."""
    if isinstance(obj, dmod.KVCache):
        return cache_fn(obj)
    if isinstance(obj, torch.Tensor):
        return tensor_fn(obj) if obj.dim() >= 1 else obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(v, tensor_fn, cache_fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(v, tensor_fn, cache_fn) for v in obj)
    return obj


class _Pending:
    """A leaf of a call's outputs waiting for the gather's tensors."""

    def __init__(self, build):
        self.build = build


def _resolve(obj, got):
    if isinstance(obj, _Pending):
        return obj.build(got)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_resolve(v, got) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_resolve(v, got) for v in obj)
    return obj


class RowParallel:
    """The decoder's (or T5's) entry points, each row-parallel over the
    mesh's ``data`` axis and tensor-parallel over ``model``, with the
    signatures of ``models.decoder`` / ``models.t5`` (the module's own
    function is looked up at each call).  Without a mesh each is the
    module's function itself."""

    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.tp = (None if mesh is None
                   else tensor_parallel.for_mesh(cfg, mesh))
        self.data = axis_size(mesh, DATA_AXIS)
        self.agreeing = (mesh is not None and mesh.size() > 1
                         and axis_size(mesh, MODEL_AXIS) == 1)

    def _split_cache(self, c: dmod.KVCache) -> dmod.KVCache:
        def cut(t, dim=1):
            return data_rows(t, self.mesh, dim=dim)

        return dmod.cache_kv_map(c, cut, positions=cut(c.positions, 0),
                                 valid=cut(c.valid, 0))

    def _gather(self, out, rows: int, base=None, extra=()):
        """A call's outputs whole from the ranks' blocks, in one gather.  A
        call that extends its input cache (``base``, whole on every rank)
        appends slots to it without changing the old ones, so only the
        appended slots are gathered.  ``extra`` (tensor, row axis) pairs
        ride the same gather; their whole tensors come back second."""
        sends = list(extra)

        def send(t, dim=0):
            sends.append((t, dim))
            return len(sends) - 1

        def cache(c):
            kv = [f for f in ("k", "v", "k_scale", "v_scale")
                  if getattr(c, f) is not None]
            if base is None:
                at = {f: send(getattr(c, f), 1) for f in kv}
                at.update(positions=send(c.positions),
                          valid=send(c.valid), length=send(c.length, None))
                return _Pending(lambda got: c._replace(
                    **{f: got[i] for f, i in at.items() if f != "length"},
                    length=got[at["length"]].max()))
            t0 = base.k.shape[2]

            def tail(t, dim):
                return t.narrow(dim, t0, t.shape[dim] - t0)

            at = {f: send(tail(getattr(c, f), 2), 1) for f in kv}
            at.update(positions=send(tail(c.positions, 1)),
                      valid=send(tail(c.valid, 1)))
            return _Pending(lambda got: c._replace(
                **{f: torch.cat([getattr(base, f), got[i]],
                                dim=2 if f in kv else 1)
                   for f, i in at.items()}))

        pending = _map(out, lambda t: _Pending(
            lambda got, i=send(t): got[i]), cache)
        got = gather_rows([t for t, _ in sends], self.mesh,
                          [d for _, d in sends], rows=rows)
        if extra:
            return _resolve(pending, got), got[:len(extra)]
        return _resolve(pending, got)

    def _agree(self, code: int) -> int:
        with strict.sanctioned_fetch():
            return agree(code, self.mesh)

    def call(self, fn, params, cfg, *args, **kwargs):
        if self.mesh is None:
            return fn(params, cfg, *args, **kwargs)
        return self._call(fn, params, cfg, args, kwargs)

    def _call(self, fn, params, cfg, args, kwargs, gather=None):
        """``call`` on a mesh; ``gather(out, rows, base)`` replaces
        :meth:`_gather` for outputs it does not cover."""
        if self.tp is not None:
            kwargs["tp"] = self.tp
        rows = next(_rows(a) for a in args
                    if isinstance(a, (torch.Tensor, dmod.KVCache)))
        base = next((a for a in args if isinstance(a, dmod.KVCache)), None)
        split = self.data > 1
        if split:
            cut = (lambda t: data_rows(t, self.mesh)
                   if t.shape[0] == rows else t)
            args = _map(args, cut, self._split_cache)
            kwargs = {k: _map(v, cut, self._split_cache)
                      for k, v in kwargs.items()}
        try:
            out = fn(params, cfg, *args, **kwargs)
        except Exception as err:
            if self.agreeing:
                self._agree(_OOM if faults.is_oom(err) else _FAILED)
            elif self.tp is not None:
                # the other model ranks may wait inside this forward's
                # collectives: a retry would pair with them
                err._no_rebatch = True
            raise
        if self.agreeing:
            code = self._agree(_OK)
            if code == _OOM:
                raise torch.OutOfMemoryError(
                    "CUDA out of memory on a peer rank of the mesh (the "
                    "ranks step down together)")
            if code:
                raise PeerRankFailed("a peer rank of the mesh failed this "
                                     "device call")
        if split:
            out = (gather or self._gather)(out, rows, base)
        return out

    def k_verify_block(self, params, cfg, cache, tail_k, tail_v, *args,
                       **kwargs):
        """``decoder.k_verify_block`` over the rank's rows and heads.  The
        pass writes its block's K/V in place into the chunk's tail, which
        the caller holds whole ([L, B, n, G, D]): on a data split each rank
        writes its rows of a copy, and the gather brings back the block's
        slots (``block_start .. block_start + kb``) of every row into the
        caller's tail, beside the chain, the acceptance vector and, at the
        chunk's last block, the folded cache's appended slots.  So every
        rank reads the same whole acceptance before it decides."""
        if self.data == 1:
            return self.call(dmod.k_verify_block, params, cfg, cache, tail_k,
                             tail_v, *args, **kwargs)
        start = int(args[3] if len(args) > 3 else kwargs["block_start"])
        whole = tail_k, tail_v
        # the rank's rows of the tail, bound here: the split of the call's
        # arguments cuts tensors by their leading axis, and a tail's is L
        mine = [data_rows(t, self.mesh, dim=1).contiguous() for t in whole]

        def fn(params, cfg, cache, *rest, **kw):
            return dmod.k_verify_block(params, cfg, cache, *mine, *rest,
                                       **kw)

        def gather(out, rows, base):
            kb = out.tokens.shape[1]
            slots = [(t.narrow(2, start, kb), 1)
                     for t in (out.tail_k, out.tail_v)]
            out, got = self._gather(out._replace(tail_k=None, tail_v=None),
                                    rows, base, extra=slots)
            for t, block in zip(whole, got):
                t[:, :, start:start + kb] = block
            return out._replace(tail_k=whole[0], tail_v=whole[1])

        return self._call(fn, params, cfg, (cache,) + args, kwargs,
                          gather=gather)

    # the entry points the engine calls, as in models.decoder / models.t5

    def prefill(self, params, cfg, *args, **kwargs):
        return self.call(dmod.prefill, params, cfg, *args, **kwargs)

    def chunked_prefill(self, params, cfg, *args, **kwargs):
        return self.call(dmod.chunked_prefill, params, cfg, *args, **kwargs)

    def extend_prefill(self, params, cfg, *args, **kwargs):
        return self.call(dmod.extend_prefill, params, cfg, *args, **kwargs)

    def decode_steps(self, params, cfg, *args, **kwargs):
        return self.call(dmod.decode_steps, params, cfg, *args, **kwargs)

    def distill_forward(self, params, cfg, *args, **kwargs):
        return self.call(dmod.distill_forward, params, cfg, *args, **kwargs)

    def forward_anchor_logits(self, params, cfg, *args, **kwargs):
        return self.call(dmod.forward_anchor_logits, params, cfg, *args,
                         **kwargs)

    def forward_last_logits(self, params, cfg, *args, **kwargs):
        return self.call(dmod.forward_last_logits, params, cfg, *args,
                         **kwargs)

    def t5_greedy_decode(self, params, cfg, *args, **kwargs):
        return self.call(t5mod.greedy_decode, params, cfg, *args, **kwargs)

    def t5_forward(self, params, cfg, *args, **kwargs):
        return self.call(t5mod.forward, params, cfg, *args, **kwargs)
