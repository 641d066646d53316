"""Pipeline parallelism: GPipe-style microbatched stages over a ``pipe`` axis.

Port of ``llm_interpretation_replication_tpu/parallel/pipeline.py``.
Layers split into contiguous stages, one stage a rank along the ``pipe``
mesh axis; microbatches stream through the stages, each stage handing its
activations to the next, M + P - 1 ticks in all (the GPipe bubble).  In
one process a rank the schedule is the data flow itself: stage s takes
microbatch m when stage s - 1 hands it over, so stage s runs microbatch m
at tick m + s.

The hand-off is a send/recv pair wrapped in ``torch.autograd.Function``\\ s,
so ``backward`` carries the gradients back stage by stage: a stage's send
receives the gradient of what it sent, and its receive sends the gradient
of what it received.  The last stage's outputs are broadcast over the pipe
group (the reference's psum replicates them); every rank computes the
same loss from them, and only the last stage keeps their gradient.
Gradients land on the rank that owns the computation: a stage's
parameters on its rank, the pipeline's input on stage 0.  Data and
tensor parallelism inside a stage are the decoder's own seams
(``parallel/tensor_parallel.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import DATA_AXIS, PIPE_AXIS, axis_group, axis_rank, axis_size


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def split_stage_params(params, n_stages: int):
    """Reshape stacked-layer leaves ``[L, ...]`` -> ``[P, L/P, ...]`` (stage
    s holds layers ``[s·L/P, (s+1)·L/P)``)."""

    def reshape(x):
        n_layers = x.shape[0]
        if n_layers % n_stages:
            raise ValueError(
                f"{n_layers} layers not divisible into {n_stages} stages")
        return x.reshape(n_stages, n_layers // n_stages, *x.shape[1:])

    return _tree_map(reshape, params)


def _differentiable(t) -> bool:
    return torch.is_grad_enabled() and t.is_floating_point()


class _Send(torch.autograd.Function):
    """Forward: send ``x`` to ``peer``; returns a token to tie into the
    loss.  Backward: receive the gradient of ``x`` from ``peer``."""

    @staticmethod
    def forward(ctx, x, peer, group, anchor):
        import torch.distributed as dist

        ctx.peer, ctx.group = peer, group
        ctx.like = (x.shape, x.dtype, x.device)
        dist.send(x.detach().contiguous(), peer, group=group)
        return anchor.new_zeros(())

    @staticmethod
    def backward(ctx, _token_grad):
        import torch.distributed as dist

        shape, dtype, device = ctx.like
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, ctx.peer, group=ctx.group)
        return grad, None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor like ``like`` from ``peer``.  Backward:
    send its gradient back to ``peer``.  ``anchors`` (this stage's
    parameters and a leaf of its own) put the receive on the path of any
    gradient the stage is asked for."""

    @staticmethod
    def forward(ctx, like, peer, group, *anchors):
        import torch.distributed as dist

        ctx.peer, ctx.group, ctx.n = peer, group, len(anchors)
        buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.recv(buf, peer, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        dist.send(grad.contiguous(), ctx.peer, group=ctx.group)
        return (None, None, None) + (None,) * ctx.n


class _Outputs(torch.autograd.Function):
    """Forward: broadcast the last stage's stacked outputs over the pipe
    group.  Backward: the last stage keeps its gradient; the other stages
    release their sends' backward through their tokens."""

    @staticmethod
    def forward(ctx, out, src, group, is_src, *tokens):
        import torch.distributed as dist

        ctx.is_src, ctx.n = is_src, len(tokens)
        out = out.clone().contiguous()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        tokens = tuple(grad.new_zeros(()) for _ in range(ctx.n))
        return (grad if ctx.is_src else None, None, None, None) + tokens


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    xs,
    mesh,
):
    """Run ``xs`` microbatches through ``stage_fn`` pipelined over ``pipe``.

    stage_fn: ``(params_for_one_stage, x) -> x`` -- same tree structure and
       shapes in and out, so activations can flow stage to stage.
    stage_params: tree with leading stage axis ``P`` on every leaf (see
       :func:`split_stage_params`); each rank runs its own stage's block.
    xs: tree of microbatched tensors ``[M, ...]`` (microbatch-major), the
       same on every rank.
    Returns the same tree, ``[M, ...]``, fully processed by all stages, on
    every rank."""
    import torch.distributed as dist

    n_stages = axis_size(mesh, PIPE_AXIS)
    leaves = _leaves(xs)
    if not leaves:
        return xs
    n_micro = leaves[0].shape[0]
    if n_micro < 1:
        raise ValueError("need at least one microbatch")
    stage = axis_rank(mesh, PIPE_AXIS)
    my_params = _tree_map(lambda a: a[stage], stage_params)

    def take(m):
        return _rebuild(xs, [x[m] for x in leaves])

    if n_stages == 1:
        outs = [_leaves(stage_fn(my_params, take(m))) for m in range(n_micro)]
        return _rebuild(xs, [torch.stack(col) for col in zip(*outs)])

    group = axis_group(mesh, PIPE_AXIS)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) \
        if stage < n_stages - 1 else None
    last = dist.get_global_rank(group, n_stages - 1)
    anchor = torch.zeros((), device=leaves[0].device, requires_grad=True)
    anchors = [anchor] + [p for p in _leaves(my_params)
                          if isinstance(p, torch.Tensor) and p.requires_grad]
    tokens, outs = [], []
    for m in range(n_micro):
        x = take(m)
        if prev is not None:
            x = _rebuild(xs, [
                _Recv.apply(t, prev, group, *anchors) if _differentiable(t)
                else _recv(t, prev, group) for t in _leaves(x)])
        y = _leaves(stage_fn(my_params, x))
        if nxt is None:
            outs.append(y)
            continue
        for t in y:
            if _differentiable(t):
                tokens.append(_Send.apply(t, nxt, group, anchor))
            else:
                dist.send(t.contiguous(), nxt, group=group)
    stacked = ([torch.stack(col) for col in zip(*outs)] if outs
               else [torch.zeros_like(x) for x in leaves])
    result = [_Outputs.apply(o, last, group, nxt is None,
                             *(tokens if o.is_floating_point() else ()))
              if torch.is_grad_enabled() else _broadcast(o, last, group)
              for o in stacked]
    return _rebuild(xs, result)


def _recv(like, peer, group):
    import torch.distributed as dist

    buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    dist.recv(buf, peer, group=group)
    return buf


def _broadcast(out, src, group):
    import torch.distributed as dist

    out = out.contiguous()
    dist.broadcast(out, src, group=group)
    return out


def pipeline_decoder_forward(
    params,
    cfg,
    token_ids,       # [B, S] int
    attention_mask,  # [B, S] int
    mesh,
    n_microbatches: int = 2,
):
    """models/decoder.py forward with the layer trunk pipelined over ``pipe``.

    Takes the whole params tree and batch on every rank and returns the
    whole fp32 logits ``[B, S, V]`` on every rank.  Each data rank runs its
    rows (``B`` must split evenly over data ranks and then microbatches),
    each model rank its tensor-parallel share; the embedding and the final
    norm and unembedding run outside the pipeline.  Each stage runs
    ``decoder.run_layers`` over its layers, so the attention route is the
    decoder's own (the causal kernel on the card under
    ``attention_impl="flash"``)."""
    from ..models import decoder as dmod
    from . import tensor_parallel
    from .sharding import shard_params

    b = token_ids.shape[0]
    if b % n_microbatches:
        raise ValueError(
            f"batch {b} not divisible into {n_microbatches} microbatches")
    n_data = axis_size(mesh, DATA_AXIS)
    if b % (n_data * n_microbatches):
        raise ValueError(f"batch {b} not divisible over {n_data} data ranks "
                         f"x {n_microbatches} microbatches")
    n_stages = axis_size(mesh, PIPE_AXIS)
    tp = tensor_parallel.for_mesh(cfg, mesh)
    params = dmod._tree(params)
    if tp is not None:
        params = shard_params(params, mesh, cfg=cfg)
    rows = b // n_data
    first = axis_rank(mesh, DATA_AXIS) * rows
    ids = token_ids[first:first + rows]
    mask = attention_mask[first:first + rows]

    positions = dmod._positions(mask)
    x = dmod._embed(cfg, params, ids, positions, tp)

    def micro(a):  # [rows, ...] -> [M, rows/M, ...]
        return a.reshape(n_microbatches, rows // n_microbatches, *a.shape[1:])

    xs = {"h": micro(x), "pos": micro(positions), "mask": micro(mask)}
    stage_layers = split_stage_params(params["layers"], n_stages)

    def stage_fn(layers, mb):
        # decoder.run_layers is the driver _trunk uses, so the pipelined
        # path takes the decoder's attention dispatch as it is
        h = dmod.run_layers(cfg, layers, mb["h"], mb["pos"], mb["mask"], tp)
        return {"h": h, "pos": mb["pos"], "mask": mb["mask"]}

    outs = pipeline_apply(stage_fn, stage_layers, xs, mesh)
    h = outs["h"].reshape(rows, *outs["h"].shape[2:])
    logits = dmod._unembed(cfg, params, h, tp)
    if n_data == 1:
        return logits
    return tensor_parallel.gather(logits, 0, axis_group(mesh, DATA_AXIS),
                                  [rows] * n_data, axis_rank(mesh, DATA_AXIS))
