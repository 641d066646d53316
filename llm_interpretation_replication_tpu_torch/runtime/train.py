"""Training step: causal-LM cross entropy and optax's AdamW chain, by hand.

Port of ``llm_interpretation_replication_tpu/runtime/train.py``.  The
reference differentiates ``models/decoder.forward`` with ``jax.grad`` and
lets GSPMD partition the step; here one process a rank differentiates the
decoder's undecorated trunk (``_trunk``/``_unembed``; the scoring entry
points stay under ``torch.no_grad``) with autograd, and the mesh's
collectives are explicit:

- the batch's rows split over ``data``; the loss is the global weighted
  mean ``sum(nll * w) / max(sum(w), 1)``, its numerator and denominator
  all-reduced over ``data`` (never a mean of the ranks' means), and each
  rank's gradient is its rows' share, summed over ``data``;
- parameters are the rank's tensor-parallel blocks
  (``parallel.sharding.shard_params``), the decoder's seams run the
  Megatron collectives (``parallel.tensor_parallel``), and K/V projections
  held whole on every model rank (heads the axis does not divide) have
  their partial gradients all-reduced over ``model``;
- the global norm is the unsharded gradient's: squared norms of the cut
  leaves summed over ``model``, whole leaves counted once.

:func:`make_optimizer` writes out ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...), weight_decay))`` as optax computes
it (``torch.optim.AdamW`` differs: its clip adds an epsilon, its schedule
starts one count later).  The first update has learning rate 0.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import decoder as dmod
from ..parallel import tensor_parallel
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, \
    axis_size
from ..parallel.sharding import model_sharded_leaves, param_specs

#: elements of a leaf the optimizer updates at a time: on the card a run
#: long enough that launches cost little, on the CPU one that stays in cache
CHUNK, CPU_CHUNK = 1 << 26, 1 << 20


def _chunk(t) -> int:
    return CPU_CHUNK if t.device.type == "cpu" else CHUNK


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: int


class AdamWState(NamedTuple):
    count: int          # updates taken (optax's adam and schedule counts)
    mu: dict            # first moments, in the parameters' dtype
    nu: dict            # second moments


def _flatten(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flatten(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


def _unflatten(pairs) -> dict:
    out: dict = {}
    for path, value in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable:
    """optax's ``warmup_cosine_decay_schedule``, in float32 as optax
    computes it: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps`` counts, then cosine decay to ``end_value`` at
    ``decay_steps`` (the warmup included)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> np.float32:
        if count < warmup_steps:
            if warmup_steps <= 0:
                return f32(init_value)
            c = f32(min(max(count, 0), warmup_steps))
            frac = f32(1) - c / f32(warmup_steps)
            return f32(init_value - peak_value) * frac + f32(peak_value)
        span = f32(float(decay_steps - warmup_steps))
        c = min(f32(count - warmup_steps), span)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / span))
        return f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha))

    return schedule


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay=...))`` on a tree of tensors.

    Moments live in each parameter's dtype and every constant is rounded
    to it, as optax's weakly typed scalars are; the global norm is
    accumulated in float32.  Leaves are updated a run of elements at a
    time (``CHUNK`` on the card, ``CPU_CHUNK`` on the CPU), so the
    update's temporaries stay small beside a 7B model's leaves.  :meth:`update` returns optax's updates;
    :meth:`apply_` adds them to the parameters in place."""

    def __init__(self, schedule: Callable, weight_decay: float = 0.01,
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamWState:
        pairs = list(_flatten(params))
        return AdamWState(
            0, _unflatten((p, torch.zeros_like(t)) for p, t in pairs),
            _unflatten((p, torch.zeros_like(t)) for p, t in pairs))

    def update(self, grads, state: AdamWState, params, norm=None):
        """(updates, new state) as optax's ``update`` gives them; the
        state's moments are not modified."""
        new = AdamWState(state.count,
                         _unflatten((p, t.clone()) for p, t in _flatten(state.mu)),
                         _unflatten((p, t.clone()) for p, t in _flatten(state.nu)))
        updates = []
        state = self._run(grads, new, params, norm, updates.append)
        return _unflatten(updates), state

    def apply_(self, params, grads, state: AdamWState, norm=None) -> AdamWState:
        """Take one step in place: the moments and ``params`` are updated
        (``grads`` are read only); returns the new state."""
        return self._run(grads, state, params, norm, None)

    @torch.no_grad()
    def _run(self, grads, state, params, norm, collect):
        if norm is None:
            norm = grad_norm(grads)
        clip = not bool(norm < self.max_norm)
        count = state.count + 1
        f32 = np.float32
        lr = f32(-1) * self.schedule(state.count)
        bc1 = f32(1) - f32(self.b1) ** f32(count)
        bc2 = f32(1) - f32(self.b2) ** f32(count)
        mu, nu, pr = dict(_flatten(state.mu)), dict(_flatten(state.nu)), \
            dict(_flatten(params))
        for path, g in _flatten(grads):
            p, m, v = pr[path], mu[path], nu[path]

            def c(x, t=p):
                return torch.tensor(float(x), dtype=t.dtype, device=t.device)

            consts = dict(b1=c(self.b1), b1c=c(1 - self.b1), b2=c(self.b2),
                          b2c=c(1 - self.b2), bc1=c(bc1), bc2=c(bc2),
                          eps=c(self.eps), wd=c(self.weight_decay), lr=c(lr),
                          max_norm=c(self.max_norm), norm=norm.to(p.dtype))
            out = torch.empty_like(p) if collect is not None else None
            g, run = g.contiguous(), _chunk(p)
            for i in range(0, p.numel(), run):
                sl = slice(i, i + run)
                u = _adamw_chunk(g.view(-1)[sl], m.view(-1)[sl],
                                 v.view(-1)[sl], p.view(-1)[sl], clip, consts)
                if collect is None:
                    p.view(-1)[sl].add_(u)
                else:
                    out.view(-1)[sl] = u
            if collect is not None:
                collect((path, out))
        return AdamWState(count, state.mu, state.nu)


def _leaf_sum_sq(t) -> torch.Tensor:
    """``sum(t * t)`` as ``jnp.sum`` takes it: the squares in ``t``'s
    dtype, accumulated in float32 run by run (not yet rounded back)."""
    t, run = t.contiguous().view(-1), _chunk(t)
    return sum(t[i:i + run].square().float().sum()
               for i in range(0, t.numel(), run))


def _adamw_chunk(g, m, v, p, clip, k):
    """One run of a leaf: clip, the moments (in place), the update."""
    if clip:
        g = (g / k["norm"]) * k["max_norm"]
    m.mul_(k["b1"]).add_(g * k["b1c"])
    v.mul_(k["b2"]).add_(g.square() * k["b2c"])
    u = (m / k["bc1"]) / (torch.sqrt(v / k["bc2"]) + k["eps"])
    u = u + k["wd"] * p
    return k["lr"] * u


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 0.01,
                   warmup_steps: int = 100,
                   total_steps: int = 10_000) -> Optimizer:
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return Optimizer(schedule, weight_decay=weight_decay)


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    """The state of a params tree (a ``DecoderWeights`` or the tree of a
    rank's blocks): its float leaves become autograd leaves, in place."""
    params = dmod._tree(params)
    for path, t in _flatten(params):
        if not t.is_floating_point():
            raise ValueError(f"{'/'.join(path)} is {t.dtype}: training takes "
                             f"float weights")
        t.requires_grad_(True)
    return TrainState(params, optimizer.init(params), 0)


def _data_rows(t, mesh):
    """This data rank's contiguous block of the batch's rows."""
    n = axis_size(mesh, DATA_AXIS)
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} not divisible over {n} data "
                         f"ranks")
    per = t.shape[0] // n
    return t[axis_rank(mesh, DATA_AXIS) * per:][:per]


def causal_lm_loss(params, cfg, token_ids, attention_mask, mesh=None):
    """Next-token cross entropy over real (non-pad) positions, fp32: the
    global ``sum(nll * w) / max(sum(w), 1)``.

    ``token_ids``/``attention_mask`` are the whole batch on every rank;
    with a mesh each data rank takes its rows and ``params`` are the rank's
    blocks.  The value is the global loss on every rank; its gradient is
    the rank's rows' share of it."""
    import torch.distributed as dist

    params = dmod._tree(params)
    tp = tensor_parallel.for_mesh(cfg, mesh)
    ids = _data_rows(token_ids, mesh)
    mask = _data_rows(attention_mask, mesh)
    x, _ = dmod._trunk(params, cfg, ids, mask, None, tp)
    logits = dmod._unembed(cfg, params, x, tp)
    targets = ids[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    weights = (mask[:, 1:] * mask[:, :-1]).float()
    num, den = (nll * weights).sum(), weights.sum()
    group = axis_group(mesh, DATA_AXIS)
    if group is not None:
        total = torch.stack([num.detach(), den])
        dist.all_reduce(total, group=group)
        num = num + (total[0] - num.detach())
        den = total[1]
    return num / torch.clamp(den, min=1.0)


def loss_and_grads(params, cfg, token_ids, attention_mask, mesh=None):
    """(loss, gradient tree) of :func:`causal_lm_loss`: each leaf's
    gradient summed over ``data``, and over ``model`` for the leaves held
    whole whose users are the rank's own heads (replicated K/V)."""
    import torch.distributed as dist

    params = dmod._tree(params)
    pairs = list(_flatten(params))
    loss = causal_lm_loss(params, cfg, token_ids, attention_mask, mesh)
    grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(
        pairs, torch.autograd.grad(loss, [t for _, t in pairs],
                                   allow_unused=True))]
    data = axis_group(mesh, DATA_AXIS)
    model = axis_group(mesh, MODEL_AXIS)
    specs = dict(_flatten(param_specs(params)))
    cut = model_sharded_leaves(params, cfg, mesh)
    for (path, _), g in zip(pairs, grads):
        if data is not None:
            dist.all_reduce(g, group=data)
        if model is not None and MODEL_AXIS in specs[path] and not cut[path]:
            dist.all_reduce(g, group=model)
    return loss.detach(), _unflatten((p, g) for (p, _), g in zip(pairs, grads))


def grad_norm(grads, cfg=None, mesh=None) -> torch.Tensor:
    """The global norm of the unsharded gradient as ``optax.global_norm``
    takes it, in the leaves' dtype: each leaf's squares summed in float32
    and rounded to the leaf's dtype, the leaves' sums added in that dtype
    in ``jax.tree.leaves`` order (sorted keys), and the root taken there.
    A leaf cut over ``model`` adds its ranks' float32 partial sums before
    the rounding; a leaf held whole counts once.  Float32 leaves give the
    float32 norm."""
    import torch.distributed as dist

    model = axis_group(mesh, MODEL_AXIS)
    cut = model_sharded_leaves(grads, cfg, mesh) if model is not None else {}
    leaves = list(_flatten(grads))
    sums = [_leaf_sum_sq(g) for _, g in leaves]
    shared = [i for i, (path, _) in enumerate(leaves) if cut.get(path)]
    if shared:
        part = torch.stack([sums[i] for i in shared])
        dist.all_reduce(part, group=model)
        for j, i in enumerate(shared):
            sums[i] = part[j]
    total = sum(s.to(g.dtype) for s, (_, g) in zip(sums, leaves))
    return torch.sqrt(total)


def make_train_step(cfg, optimizer: Optimizer, mesh=None,
                    donate: bool = True) -> Callable:
    """Returns ``step(state, token_ids, attention_mask, on_grads=None) ->
    (state, loss)``.

    ``token_ids``/``attention_mask`` are the whole batch on every rank;
    with a mesh, ``state.params`` hold the rank's blocks
    (``shard_params``) and the step is partitioned as the module says.
    ``on_grads(grads, norm)``, when given, sees the reduced gradient tree
    and its global norm before the update.  The update is always in place
    (the returned state holds the same tensors), so ``donate`` is accepted
    and ignored."""
    del donate

    def step(state: TrainState, token_ids, attention_mask, on_grads=None):
        loss, grads = loss_and_grads(state.params, cfg, token_ids,
                                     attention_mask, mesh)
        norm = grad_norm(grads, cfg, mesh)
        if on_grads is not None:
            on_grads(grads, norm)
        opt_state = optimizer.apply_(state.params, grads, state.opt_state,
                                     norm=norm)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return step
