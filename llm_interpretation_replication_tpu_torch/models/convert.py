"""Weight bridge into the port's :class:`~.decoder.DecoderWeights`.

``params_from_jax`` carries the JAX package's stacked param tree (as numpy
arrays) across unchanged in layout, quantized (w8a8) trees included;
``random_params`` builds full-width random weights directly on the device
from an explicit generator, optionally quantized as they are made; the
converters turn a HF checkpoint of the GPT-NeoX, Falcon, BLOOM or
LLaMA/Mistral family (any ``get(name) -> tensor``) into the same stacked
tree (copies of ``models/convert.py``'s ``convert_neox``,
``convert_falcon``, ``convert_bloom`` and ``convert_llama`` with their
fused-QKV splits, on tensors), so both load paths meet in one
``DecoderWeights``.
"""

from __future__ import annotations

from typing import Callable, Dict

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


Getter = Callable[[str], torch.Tensor]


def _linear(get: Getter, name: str) -> torch.Tensor:
    """A torch ``Linear`` weight ``[out, in]`` as the ``x @ W`` layout
    ``[in, out]``."""
    return get(f"{name}.weight").t().contiguous()


def _maybe(get: Getter, name: str):
    try:
        return get(name)
    except KeyError:
        return None


def _ln(get: Getter, name: str, layers=None, bias: bool = True) -> Dict:
    keys = ("scale", "bias") if bias else ("scale",)
    if layers is None:
        return {k: get(f"{name}.{w}") for k, w in zip(keys, ("weight", "bias"))}
    return {k: torch.stack([get(f"{name.format(i=i)}.{w}") for i in layers])
            for k, w in zip(keys, ("weight", "bias"))}


def _stack_linear(get: Getter, name: str, layers) -> torch.Tensor:
    return torch.stack([_linear(get, name.format(i=i)) for i in layers])


def _stack_get(get: Getter, name: str, layers) -> torch.Tensor:
    return torch.stack([get(name.format(i=i)) for i in layers])


def _split_neox_qkv(w: torch.Tensor, b, n_heads: int, head_dim: int):
    """GPT-NeoX / BLOOM fused QKV: rows are head-major, ``[q(D); k(D);
    v(D)]`` per head.  ``w`` ``[3*N*D, H]`` -> (wq, wk, wv) each ``[H,
    N*D]``, and ``b`` ``[3*N*D]`` -> (bq, bk, bv) each ``[N*D]``."""
    h = w.shape[1]
    w4 = w.reshape(n_heads, 3, head_dim, h)
    ws = [w4[:, j].reshape(n_heads * head_dim, h).t().contiguous()
          for j in range(3)]
    b4 = b.reshape(n_heads, 3, head_dim)
    return ws, [b4[:, j].reshape(n_heads * head_dim).contiguous()
                for j in range(3)]


def _fused_attn(get: Getter, prefix: str, layers, cfg: DecoderConfig) -> Dict:
    """The attention of a NeoX- or BLOOM-style layer stack: its fused QKV
    (``{prefix}.query_key_value``) split per head, and ``{prefix}.dense``."""
    split = [_split_neox_qkv(get(f"{prefix.format(i=i)}.query_key_value.weight"),
                             get(f"{prefix.format(i=i)}.query_key_value.bias"),
                             cfg.num_heads, cfg.head_dim) for i in layers]
    attn = {}
    for j, name in enumerate(("q", "k", "v")):
        attn["w" + name] = torch.stack([ws[j] for ws, _ in split])
        attn["b" + name] = torch.stack([bs[j] for _, bs in split])
    attn["wo"] = _stack_linear(get, prefix + ".dense", layers)
    attn["bo"] = _stack_get(get, prefix + ".dense.bias", layers)
    return attn


def _biased_mlp(get: Getter, prefix: str, layers) -> Dict:
    """``{prefix}.dense_h_to_4h`` and ``dense_4h_to_h`` with their biases."""
    return {
        "wi": _stack_linear(get, prefix + ".dense_h_to_4h", layers),
        "bi": _stack_get(get, prefix + ".dense_h_to_4h.bias", layers),
        "wo": _stack_linear(get, prefix + ".dense_4h_to_h", layers),
        "bo": _stack_get(get, prefix + ".dense_4h_to_h.bias", layers),
    }


def convert_neox(get: Getter, cfg: DecoderConfig) -> Dict:
    """A HF GPT-NeoX checkpoint -> the stacked param tree (untied
    ``embed_out``)."""
    L = range(cfg.num_layers)
    return {
        "embed": {"tokens": get("gpt_neox.embed_in.weight")},
        "layers": {
            "ln1": _ln(get, "gpt_neox.layers.{i}.input_layernorm", L),
            "ln2": _ln(get, "gpt_neox.layers.{i}.post_attention_layernorm", L),
            "attn": _fused_attn(get, "gpt_neox.layers.{i}.attention", L, cfg),
            "mlp": _biased_mlp(get, "gpt_neox.layers.{i}.mlp", L),
        },
        "final_ln": _ln(get, "gpt_neox.final_layer_norm"),
        "lm_head": get("embed_out.weight").t().contiguous(),
    }


def _split_falcon_qkv(w: torch.Tensor, n_heads: int, n_kv: int, head_dim: int):
    """Falcon's fused QKV ``[rows, H]`` -> (wq, wk, wv) ``[H, N*D]`` /
    ``[H, G*D]``.  Old architecture with multi-query (Falcon-7B): rows are
    ``[q(N*D); k(D); v(D)]``; grouped (new architecture): ``[q(g*D); k(D);
    v(D)]`` for each of the ``n_kv`` groups; one K/V per head: ``[q; k; v]``
    per head."""
    h = w.shape[1]
    g = 1 if n_kv == n_heads else n_heads // n_kv
    wg = w.reshape(n_kv, g + 2, head_dim, h)
    wq = wg[:, :g].reshape(n_heads * head_dim, h).t().contiguous()
    wk = wg[:, g].reshape(n_kv * head_dim, h).t().contiguous()
    wv = wg[:, g + 1].reshape(n_kv * head_dim, h).t().contiguous()
    return wq, wk, wv


def convert_falcon(get: Getter, cfg: DecoderConfig) -> Dict:
    """A HF Falcon checkpoint -> the stacked param tree, in the
    checkpoint's own dtype, on the device ``get`` puts its tensors on."""
    L = range(cfg.num_layers)
    qkv = [_split_falcon_qkv(
        get(f"transformer.h.{i}.self_attention.query_key_value.weight"),
        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) for i in L]
    ln1_name = (
        "transformer.h.{i}.input_layernorm"
        if _maybe(get, "transformer.h.0.input_layernorm.weight") is not None
        else "transformer.h.{i}.ln_attn"
    )
    layers = {
        "ln1": _ln(get, ln1_name, L),
        "attn": {
            "wq": torch.stack([q for q, _, _ in qkv]),
            "wk": torch.stack([k for _, k, _ in qkv]),
            "wv": torch.stack([v for _, _, v in qkv]),
            "wo": _stack_linear(get, "transformer.h.{i}.self_attention.dense", L),
        },
        "mlp": {
            "wi": _stack_linear(get, "transformer.h.{i}.mlp.dense_h_to_4h", L),
            "wo": _stack_linear(get, "transformer.h.{i}.mlp.dense_4h_to_h", L),
        },
    }
    del qkv
    if not cfg.shared_layernorm:
        layers["ln2"] = _ln(get, "transformer.h.{i}.ln_mlp", L)
    params = {
        "embed": {"tokens": get("transformer.word_embeddings.weight")},
        "layers": layers,
        "final_ln": _ln(get, "transformer.ln_f"),
    }
    head = _maybe(get, "lm_head.weight")
    if head is not None and not cfg.tie_word_embeddings:
        params["lm_head"] = head.t().contiguous()
    return params


def convert_bloom(get: Getter, cfg: DecoderConfig) -> Dict:
    """A HF BLOOM checkpoint -> the stacked param tree (embedding
    LayerNorm, tied head)."""
    L = range(cfg.num_layers)
    return {
        "embed": {
            "tokens": get("transformer.word_embeddings.weight"),
            "ln": _ln(get, "transformer.word_embeddings_layernorm"),
        },
        "layers": {
            "ln1": _ln(get, "transformer.h.{i}.input_layernorm", L),
            "ln2": _ln(get, "transformer.h.{i}.post_attention_layernorm", L),
            "attn": _fused_attn(get, "transformer.h.{i}.self_attention", L, cfg),
            "mlp": _biased_mlp(get, "transformer.h.{i}.mlp", L),
        },
        "final_ln": _ln(get, "transformer.ln_f"),
    }


def convert_llama(get: Getter, cfg: DecoderConfig) -> Dict:
    """A HF LLaMA / Mistral checkpoint -> the stacked param tree (RMSNorm
    scales, gated MLP, untied ``lm_head`` unless the config ties it)."""
    L = range(cfg.num_layers)
    pre = "model.layers.{i}"
    attn = {f"w{n}": _stack_linear(get, f"{pre}.self_attn.{n}_proj", L)
            for n in ("q", "k", "v", "o")}
    if cfg.qkv_bias:
        attn.update({f"b{n}": _stack_get(get, f"{pre}.self_attn.{n}_proj.bias", L)
                     for n in ("q", "k", "v")})
    params = {
        "embed": {"tokens": get("model.embed_tokens.weight")},
        "layers": {
            "ln1": _ln(get, pre + ".input_layernorm", L, bias=False),
            "ln2": _ln(get, pre + ".post_attention_layernorm", L, bias=False),
            "attn": attn,
            "mlp": {
                "wg": _stack_linear(get, pre + ".mlp.gate_proj", L),
                "wi": _stack_linear(get, pre + ".mlp.up_proj", L),
                "wo": _stack_linear(get, pre + ".mlp.down_proj", L),
            },
        },
        "final_ln": _ln(get, "model.norm", bias=False),
    }
    head = _maybe(get, "lm_head.weight")
    if head is not None and not cfg.tie_word_embeddings:
        params["lm_head"] = head.t().contiguous()
    return params


#: family -> checkpoint converter, for the families ported
CONVERTERS = {"neox": convert_neox, "falcon": convert_falcon,
              "bloom": convert_bloom, "llama": convert_llama}
