"""Tensor-parallel sharding rules for param trees and activations.

Port of ``llm_interpretation_replication_tpu/parallel/sharding.py``.  The
specs are the reference's Megatron layout, each a tuple of mesh axis names
or None a dim (``()`` is replicated):

- attention: Q/K/V projections column-sharded over heads (``model`` on the
  N*D output dim), output projection row-sharded (``model`` on the N*D
  input dim);
- MLP: up/gate column-sharded, down row-sharded;
- embeddings / lm_head sharded on the vocab dim; layernorms replicated;
- the stacked layer axis L is never sharded.

:func:`shard_params` gives each rank its local block.  Where GSPMD splits a
sharded dim evenly by bytes, the port splits on **head boundaries** (the
rank's heads of ``parallel/tensor_parallel.py``; Falcon-7B's 71 heads at
two ranks are 36 + 35), and K/V projections whose heads the model axis does
not divide (Falcon's one K/V head) are **replicated**: each rank computes
the K/V its own query heads read, and the train step all-reduces their
partial gradients over ``model``.  The numbers are GSPMD's; only the bytes
a rank holds differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, axis_group, axis_rank, \
    axis_size
from .tensor_parallel import split_range

M = MODEL_AXIS
REPLICATED: Tuple = ()


def _decoder_param_specs() -> dict:
    """Spec tree matching models/decoder.py's param layout."""
    attn = {
        "wq": (None, None, M), "wk": (None, None, M), "wv": (None, None, M),
        "wo": (None, M, None),
        "bq": (None, M), "bk": (None, M), "bv": (None, M),
        "bo": (None,),
        # w8a8 int8 scales: per output channel, so they shard with the
        # weight's output dim (column-sharded) or replicate (row-).
        "wq_qscale": (None, M), "wk_qscale": (None, M),
        "wv_qscale": (None, M), "wo_qscale": (None,),
    }
    mlp = {
        "wi": (None, None, M), "wg": (None, None, M),
        "bi": (None, M), "bg": (None, M),
        "wo": (None, M, None), "bo": (None,),
        "wi_qscale": (None, M), "wg_qscale": (None, M), "wo_qscale": (None,),
    }
    ln = {"scale": (None,), "bias": (None,)}
    return {
        "embed": {"tokens": (M, None), "pos": (None,),
                  "ln": {"scale": (), "bias": ()}},
        "layers": {"ln1": ln, "ln2": ln, "attn": attn, "mlp": mlp},
        "final_ln": {"scale": (), "bias": ()},
        "lm_head": (None, M),
    }


def _t5_param_specs() -> dict:
    attn = {"wq": (None, None, M), "wk": (None, None, M),
            "wv": (None, None, M), "wo": (None, M, None)}
    mlp = {"wi": (None, None, M), "wi0": (None, None, M),
           "wi1": (None, None, M), "wo": (None, M, None)}
    ln = {"scale": (None,)}
    return {
        "shared": (M, None),
        "encoder": {
            "rel_bias": (),
            "layers": {"ln1": ln, "ln2": ln, "attn": attn, "mlp": mlp},
            "final_ln": {"scale": ()},
        },
        "decoder": {
            "rel_bias": (),
            "layers": {"ln1": ln, "ln2": ln, "ln3": ln, "self_attn": attn,
                       "cross_attn": attn, "mlp": mlp},
            "final_ln": {"scale": ()},
        },
        "lm_head": (None, M),
    }


def _match_tree(params, spec_tree, path=""):
    """Walk ``params``; for every leaf take the spec at the same path (falling
    back to replicated)."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            sub = spec_tree.get(k, {}) if isinstance(spec_tree, dict) else {}
            out[k] = _match_tree(v, sub, f"{path}/{k}")
        return out
    return spec_tree if isinstance(spec_tree, tuple) else REPLICATED


def _plain(params):
    return params.tree() if hasattr(params, "tree") else params


def param_specs(params, kind: str = "decoder") -> dict:
    """Spec tree for a params tree (missing entries replicate)."""
    table = _decoder_param_specs() if kind == "decoder" else _t5_param_specs()
    return _match_tree(_plain(params), table)


_ATTN = ("attn", "self_attn", "cross_attn")
_KV = ("wk", "wv", "bk", "bv", "wk_qscale", "wv_qscale")


def _heads(cfg, kind):
    """(query heads, K/V heads, head dim) of ``cfg``."""
    if kind == "decoder":
        return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return cfg.num_heads, cfg.num_heads, cfg.d_kv


def leaf_split(path: Tuple[str, ...], spec, shape, cfg, size: int,
               kind: str = "decoder") -> Optional[Tuple[int, int, int]]:
    """How a leaf splits over ``size`` model ranks: (dim, units, unit) --
    ``units`` runs of ``unit`` entries along ``dim``, cut by
    ``tensor_parallel.split_sizes`` -- or None when it is held whole
    (replicated by its spec, or K/V heads the axis does not divide)."""
    if size == 1 or M not in spec:
        return None
    dim = spec.index(M)
    if any(p in _ATTN for p in path):
        n, g, d = _heads(cfg, kind)
        if path[-1] in _KV:
            return None if g % size else (dim, g, d)
        return dim, n, d
    return dim, shape[dim], 1


def _walk(tree, specs, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _walk(tree[key], specs[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key], specs[key]


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def shard_params(params, mesh, kind: str = "decoder", cfg=None,
                 device: Optional[str] = None):
    """Each rank's local block of a full params tree, on ``device`` (a
    device type; default the mesh's): column- and row-parallel leaves cut
    to the rank's heads, MLP columns or vocab rows (:func:`leaf_split`),
    everything else whole (the same tensors when they already sit on that
    device).  ``cfg`` (the model's config) names the head boundaries; it
    is needed when the model axis has more than one rank."""
    params = _plain(params)
    size = axis_size(mesh, MODEL_AXIS)
    rank = axis_rank(mesh, MODEL_AXIS)
    if size > 1 and cfg is None:
        raise ValueError("shard_params over a model axis needs cfg= to cut "
                         "on head boundaries")
    if device is None and mesh is not None:
        device = mesh.device_type
    out: dict = {}
    for path, leaf, spec in _walk(params, param_specs(params, kind)):
        split = leaf_split(path, spec, tuple(leaf.shape), cfg, size, kind)
        if split is not None:
            dim, units, unit = split
            first, count = split_range(units, size, rank)
            leaf = leaf.narrow(dim, first * unit, count * unit).contiguous()
        if device is not None and leaf.device.type != device:
            leaf = leaf.to(device)
        _set(out, path, leaf)
    return out


def model_sharded_leaves(params, cfg, mesh, kind: str = "decoder") -> dict:
    """path -> True for each leaf cut over ``model`` (its gradient and
    norm are the rank's share), False for one held whole."""
    params = _plain(params)
    size = axis_size(mesh, MODEL_AXIS)
    return {path: leaf_split(path, spec, tuple(leaf.shape), cfg, size, kind)
            is not None
            for path, leaf, spec in _walk(params, param_specs(params, kind))}


def batch_spec() -> Tuple:
    """Activations: batch over data axis, sequence optionally over seq axis."""
    return (DATA_AXIS,)


def activation_spec(seq_sharded: bool = False) -> Tuple:
    return (DATA_AXIS, SEQ_AXIS if seq_sharded else None)


def constrain(x, mesh, spec, current: Tuple = ()):
    """This rank's block of ``x`` under ``spec``, from its block under
    ``current`` (default: the full tensor): a dim sharded by ``current``
    but not by ``spec`` is gathered over its axis, one sharded by ``spec``
    but not by ``current`` is sliced to the rank's run (the first
    ``n % ranks`` runs one longer)."""
    from . import tensor_parallel

    def axis_at(s, dim):
        return s[dim] if dim < len(s) else None

    for dim in range(x.dim()):
        have, want = axis_at(current, dim), axis_at(spec, dim)
        if have == want:
            continue
        if have is not None:
            n = axis_size(mesh, have)
            if n > 1:
                import torch
                import torch.distributed as dist

                local = torch.tensor([x.shape[dim]], device=x.device)
                sizes = [torch.zeros_like(local) for _ in range(n)]
                dist.all_gather(sizes, local, group=axis_group(mesh, have))
                x = tensor_parallel._all_gather(
                    x, dim, axis_group(mesh, have), [int(s) for s in sizes])
        if want is not None:
            first, count = split_range(x.shape[dim], axis_size(mesh, want),
                                       axis_rank(mesh, want))
            x = x.narrow(dim, first, count)
    return x
