"""Weight bridge into the port's :class:`~.decoder.DecoderWeights`.

``params_from_jax`` carries the JAX package's stacked param tree (as numpy
arrays) across unchanged in layout, quantized (w8a8) trees included;
``random_params`` builds full-width random weights directly on the device
from an explicit generator, optionally quantized as they are made.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..ops import quant as qops
from .config import DecoderConfig
from .decoder import DecoderWeights, _flatten


def params_from_jax(params_np: Dict, cfg: DecoderConfig, device=DEFAULT_DEVICE,
                    dtype="bf16") -> DecoderWeights:
    """The reference's param tree (``embed.tokens``, ``layers.{ln1, ln2,
    attn.{wq,wk,wv,wo}, mlp.{wi,wo}}``, ``final_ln``, optional ``lm_head``;
    leaves are numpy arrays or anything ``np.asarray`` takes) -> the port's
    weights on ``device`` in ``dtype``.  A tied model keeps no ``lm_head``:
    the unembedding reads ``embed.tokens.T``, as in the reference.  A
    quantized tree (``ops/quant.quantize_decoder_params_np``) keeps its int8
    weights int8 and its ``*_qscale`` scales float32, as the reference's
    loader does."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    tree: Dict = {}
    for path, leaf in _flatten(params_np):
        arr = np.asarray(leaf)
        if arr.dtype == np.int8:
            t = torch.from_numpy(arr).to(device=dev)
        else:
            # via float32: numpy has no bfloat16 of its own (JAX hands over
            # ml_dtypes arrays, which torch cannot read)
            t = torch.from_numpy(arr.astype(np.float32)).to(device=dev)
            if not path[-1].endswith(qops.QSCALE_SUFFIX):
                t = t.to(dt)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    if "lm_head" not in tree and not cfg.tie_word_embeddings:
        raise ValueError("untied config but the param tree has no lm_head")
    return DecoderWeights(cfg, tree)


def random_params(cfg: DecoderConfig, seed: int = 0, device=DEFAULT_DEVICE,
                  dtype="bf16", scale: float = 0.02,
                  quant: str = "none") -> DecoderWeights:
    """Random weights at the config's full width, made on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: projections and embeddings are
    N(0, scale^2), norms are scale 1 / bias 0; projection biases, which
    would be zero, are left out (the forward adds none).

    ``quant="int8"`` quantizes each projection (w8a8,
    ``ops.quant.quantize_weight``) one layer at a time right after it is drawn,
    as the loader does with ``quant='int8'``, so the full ``dtype`` copy
    never sits on the device beside the int8 one; the values drawn are those
    of ``quant="none"`` with the same seed."""
    if quant not in ("none", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, nd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    L, F, V = cfg.num_layers, cfg.intermediate_size, cfg.vocab_size

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt).mul_(scale)

    def norm(*lead):
        return {"scale": torch.ones((*lead, h), device=dev, dtype=dt),
                "bias": torch.zeros((*lead, h), device=dev, dtype=dt)}

    def proj(group, name, k, n):
        w = rnd(L, k, n)
        if quant == "none":
            group[name] = w
            return
        pairs = [qops.quantize_weight(w[i]) for i in range(L)]
        del w
        group[name] = torch.stack([q for q, _ in pairs])
        group[name + qops.QSCALE_SUFFIX] = torch.stack([s for _, s in pairs])

    attn, mlp = {}, {}
    for name, k, n in (("wq", h, nd), ("wk", h, kvd), ("wv", h, kvd),
                       ("wo", nd, h)):
        proj(attn, name, k, n)
    proj(mlp, "wi", h, F)
    proj(mlp, "wo", F, h)
    if cfg.mlp_type == "gated":
        proj(mlp, "wg", h, F)
    layers = {"ln1": norm(L), "attn": attn, "mlp": mlp}
    if not (cfg.parallel_residual and cfg.shared_layernorm):
        layers["ln2"] = norm(L)
    tree = {"embed": {"tokens": rnd(V, h)}, "layers": layers,
            "final_ln": norm()}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = rnd(h, V)
    return DecoderWeights(cfg, tree)
