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

import re
from typing import Callable, Dict

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..ops import quant as qops
from .config import DecoderConfig, T5Config
from .decoder import DecoderWeights, _flatten
from .t5 import T5Weights


def params_from_jax(params_np: Dict, cfg, device=DEFAULT_DEVICE,
                    dtype="bf16") -> DecoderWeights:
    """The reference's param tree (``embed.tokens``, ``layers.{ln1, ln2,
    attn.{wq,wk,wv,wo}, mlp.{wi,wo}}``, ``final_ln``, optional ``lm_head``;
    or, for a ``T5Config``, the T5 tree of ``models/t5.py``; leaves are
    numpy arrays or anything ``np.asarray`` takes) -> the port's weights
    (``DecoderWeights`` or ``T5Weights``) on ``device`` in ``dtype``.  A
    tied model keeps no ``lm_head``: the unembedding reads the embedding
    table, as in the reference.  A quantized tree
    (``ops/quant.quantize_decoder_params_np``) keeps its int8 weights int8
    and its ``*_qscale`` scales float32, as the reference's loader does."""
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
    holder = T5Weights if isinstance(cfg, T5Config) else DecoderWeights
    return holder(cfg, tree)


def random_params(cfg, seed: int = 0, device=DEFAULT_DEVICE,
                  dtype="bf16", scale: float = 0.02,
                  quant: str = "none") -> DecoderWeights:
    """Random weights at the config's full width, made on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: projections and embeddings are
    N(0, scale^2), norms are scale 1 / bias 0; projection biases, which
    would be zero, are left out (the forward adds none).  A ``T5Config``
    gets T5's own initialization instead (:func:`random_t5_state_dict`
    through :func:`convert_t5`; ``scale`` and ``quant`` do not apply).

    ``quant="int8"`` quantizes each projection (w8a8,
    ``ops.quant.quantize_weight``) one layer at a time right after it is drawn,
    as the loader does with ``quant='int8'``, so the full ``dtype`` copy
    never sits on the device beside the int8 one; the values drawn are those
    of ``quant="none"`` with the same seed."""
    if isinstance(cfg, T5Config):
        sd = random_t5_state_dict(cfg, seed, device, dtype)
        return T5Weights(cfg, convert_t5(sd.__getitem__, cfg))
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


def _split_concat_qkv(w: torch.Tensor, b=None):
    """Straight-concatenated fused QKV (Qwen-1's ``c_attn``, Baichuan's
    ``W_pack``): rows ``[q (all heads); k; v]``.  ``w`` ``[3*N*D, H]`` ->
    (wq, wk, wv) each ``[H, N*D]``, and ``b`` -> (bq, bk, bv)."""
    ws = tuple(part.t().contiguous() for part in torch.chunk(w, 3, dim=0))
    if b is None:
        return ws, (None, None, None)
    return ws, tuple(part.contiguous() for part in torch.chunk(b, 3))


def convert_qwen(get: Getter, cfg: DecoderConfig) -> Dict:
    """A Qwen-7B (first generation) checkpoint -> the stacked param tree:
    ``transformer.h.{i}`` with ``ln_1``/``ln_2``, the fused ``attn.c_attn``
    with its bias, and the ``w1``/``w2``/``c_proj`` gated MLP, whose SiLU
    acts on ``w2`` (our gate; ``w1`` is the up projection)."""
    L = range(cfg.num_layers)
    pre = "transformer.h.{i}"
    split = [_split_concat_qkv(get(f"transformer.h.{i}.attn.c_attn.weight"),
                               get(f"transformer.h.{i}.attn.c_attn.bias"))
             for i in L]
    attn = {}
    for j, name in enumerate(("q", "k", "v")):
        attn["w" + name] = torch.stack([ws[j] for ws, _ in split])
        attn["b" + name] = torch.stack([bs[j] for _, bs in split])
    del split
    attn["wo"] = _stack_linear(get, pre + ".attn.c_proj", L)
    params = {
        "embed": {"tokens": get("transformer.wte.weight")},
        "layers": {
            "ln1": _ln(get, pre + ".ln_1", L, bias=False),
            "ln2": _ln(get, pre + ".ln_2", L, bias=False),
            "attn": attn,
            "mlp": {
                "wg": _stack_linear(get, pre + ".mlp.w2", L),
                "wi": _stack_linear(get, pre + ".mlp.w1", L),
                "wo": _stack_linear(get, pre + ".mlp.c_proj", L),
            },
        },
        "final_ln": _ln(get, "transformer.ln_f", bias=False),
    }
    head = _maybe(get, "lm_head.weight")
    if head is not None and not cfg.tie_word_embeddings:
        params["lm_head"] = head.t().contiguous()
    return params


def convert_baichuan(get: Getter, cfg: DecoderConfig) -> Dict:
    """A Baichuan(2) checkpoint: LLaMA names but for the fused
    ``self_attn.W_pack`` QKV, so :func:`convert_llama` reads it through a
    getter that splits it.  With ``cfg.norm_head`` (Baichuan2) each vocab
    column of the transposed ``lm_head`` ``[H, V]`` is L2-normalized in
    float32 and stored back in the checkpoint's dtype: the model
    normalizes on every forward, and static weights make that exact at
    conversion."""

    def get_split(name: str) -> torch.Tensor:
        m = re.fullmatch(r"model\.layers\.(\d+)\.self_attn\.([qkv])_proj\.weight",
                         name)
        if m is None:
            return get(name)
        packed = get(f"model.layers.{m.group(1)}.self_attn.W_pack.weight")
        return torch.chunk(packed, 3, dim=0)["qkv".index(m.group(2))]

    params = convert_llama(get_split, cfg)
    if cfg.norm_head and "lm_head" in params:
        head = params["lm_head"]
        h32 = head.float()
        params["lm_head"] = (h32 / torch.linalg.vector_norm(
            h32, dim=0, keepdim=True).clamp(min=1e-12)).to(head.dtype)
    return params


def convert_opt(get: Getter, cfg: DecoderConfig) -> Dict:
    """An OPT checkpoint -> the stacked param tree.  The stored position
    table already holds the +2 offset (the decoder adds
    ``cfg.learned_pos_offset`` back to the positions)."""
    L = range(cfg.num_layers)
    pre = "model.decoder"
    lay = pre + ".layers.{i}"
    attn = {f"w{n}": _stack_linear(get, f"{lay}.self_attn.{n}_proj", L)
            for n in ("q", "k", "v")}
    attn.update({f"b{n}": _stack_get(get, f"{lay}.self_attn.{n}_proj.bias", L)
                 for n in ("q", "k", "v")})
    attn["wo"] = _stack_linear(get, lay + ".self_attn.out_proj", L)
    attn["bo"] = _stack_get(get, lay + ".self_attn.out_proj.bias", L)
    return {
        "embed": {"tokens": get(f"{pre}.embed_tokens.weight"),
                  "pos": get(f"{pre}.embed_positions.weight")},
        "layers": {
            "ln1": _ln(get, lay + ".self_attn_layer_norm", L),
            "ln2": _ln(get, lay + ".final_layer_norm", L),
            "attn": attn,
            "mlp": {
                "wi": _stack_linear(get, lay + ".fc1", L),
                "bi": _stack_get(get, lay + ".fc1.bias", L),
                "wo": _stack_linear(get, lay + ".fc2", L),
                "bo": _stack_get(get, lay + ".fc2.bias", L),
            },
        },
        "final_ln": _ln(get, f"{pre}.final_layer_norm"),
    }


def convert_t5(get: Getter, cfg: T5Config) -> Dict:
    """A HF ``T5ForConditionalGeneration`` checkpoint (T5, T0, tk-instruct,
    Flan-T5) -> the stacked T5 tree of ``models/t5.py``."""
    gated = cfg.feed_forward_proj == "gated-gelu"
    mlp_names = (("wi0", "wi_0"), ("wi1", "wi_1"), ("wo", "wo")) if gated \
        else (("wi", "wi"), ("wo", "wo"))

    def stack(prefix, n_layers):
        L = range(n_layers)
        return lambda name: _stack_linear(get, f"{prefix}.{{i}}.{name}", L)

    def attn(lin, part):
        return {f"w{n}": lin(f"{part}.{n}") for n in ("q", "k", "v", "o")}

    def scales(prefix, n_layers, j):
        return {"scale": _stack_get(get, f"{prefix}.{{i}}.layer.{j}.layer_norm.weight",
                                    range(n_layers))}

    enc = stack("encoder.block", cfg.num_layers)
    dec = stack("decoder.block", cfg.num_decoder_layers)
    Ld = cfg.num_decoder_layers
    params = {
        "shared": get("shared.weight"),
        "encoder": {
            "rel_bias": get("encoder.block.0.layer.0.SelfAttention."
                            "relative_attention_bias.weight"),
            "layers": {
                "ln1": scales("encoder.block", cfg.num_layers, 0),
                "ln2": scales("encoder.block", cfg.num_layers, 1),
                "attn": attn(enc, "layer.0.SelfAttention"),
                "mlp": {k: enc(f"layer.1.DenseReluDense.{n}")
                        for k, n in mlp_names},
            },
            "final_ln": {"scale": get("encoder.final_layer_norm.weight")},
        },
        "decoder": {
            "rel_bias": get("decoder.block.0.layer.0.SelfAttention."
                            "relative_attention_bias.weight"),
            "layers": {
                "ln1": scales("decoder.block", Ld, 0),
                "ln2": scales("decoder.block", Ld, 1),
                "ln3": scales("decoder.block", Ld, 2),
                "self_attn": attn(dec, "layer.0.SelfAttention"),
                "cross_attn": attn(dec, "layer.1.EncDecAttention"),
                "mlp": {k: dec(f"layer.2.DenseReluDense.{n}")
                        for k, n in mlp_names},
            },
            "final_ln": {"scale": get("decoder.final_layer_norm.weight")},
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight").t().contiguous()
    return params


def random_t5_state_dict(cfg: T5Config, seed: int = 0, device=DEFAULT_DEVICE,
                         dtype="bf16") -> Dict[str, torch.Tensor]:
    """A random checkpoint of ``cfg`` under ``T5ForConditionalGeneration``'s
    tensor names, made on ``device`` from a generator seeded with ``seed``
    at T5's initialization scales (HF ``T5PreTrainedModel._init_weights``
    with factor 1): embeddings N(0, 1); q N(0, (d_model*d_kv)^-1), k and v
    N(0, d_model^-1), o N(0, (N*d_kv)^-1); the MLP's input projections
    N(0, d_model^-1), its output N(0, d_ff^-1); the relative-bias tables
    N(0, d_model^-1); norm scales 1.  T5 has no attention scale, so
    unit-normal projections would overflow bf16 at full depth.  An untied
    head is drawn at N(0, d_model^-1), the scale a tied model's output
    gets (HF draws it at 1, which puts random logits at a standard
    deviation of sqrt(d_model), 45 at T0_3B's width)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, n, dk, f = cfg.d_model, cfg.num_heads, cfg.d_kv, cfg.d_ff
    sd: Dict[str, torch.Tensor] = {}

    def rnd(name, std, *shape):
        sd[name] = torch.randn(shape, generator=gen, device=dev,
                               dtype=dt).mul_(std)

    def ones(name):
        sd[name] = torch.ones(d, device=dev, dtype=dt)

    gated = cfg.feed_forward_proj == "gated-gelu"
    rnd("shared.weight", 1.0, cfg.vocab_size, d)
    for side, n_layers, parts in (
            ("encoder", cfg.num_layers, ("SelfAttention", "DenseReluDense")),
            ("decoder", cfg.num_decoder_layers,
             ("SelfAttention", "EncDecAttention", "DenseReluDense"))):
        rnd(f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            d ** -0.5, cfg.relative_attention_num_buckets, n)
        for i in range(n_layers):
            for j, part in enumerate(parts):
                pre = f"{side}.block.{i}.layer.{j}"
                ones(f"{pre}.layer_norm.weight")
                if part == "DenseReluDense":
                    for name in (("wi_0", "wi_1") if gated else ("wi",)):
                        rnd(f"{pre}.{part}.{name}.weight", d ** -0.5, f, d)
                    rnd(f"{pre}.{part}.wo.weight", f ** -0.5, d, f)
                    continue
                rnd(f"{pre}.{part}.q.weight", (d * dk) ** -0.5, n * dk, d)
                rnd(f"{pre}.{part}.k.weight", d ** -0.5, n * dk, d)
                rnd(f"{pre}.{part}.v.weight", d ** -0.5, n * dk, d)
                rnd(f"{pre}.{part}.o.weight", (n * dk) ** -0.5, d, n * dk)
        ones(f"{side}.final_layer_norm.weight")
    if not cfg.tie_word_embeddings:
        rnd("lm_head.weight", d ** -0.5, cfg.vocab_size, d)
    return sd


#: family -> checkpoint converter, for the families ported
CONVERTERS = {"neox": convert_neox, "falcon": convert_falcon,
              "bloom": convert_bloom, "llama": convert_llama,
              "qwen": convert_qwen, "baichuan": convert_baichuan,
              "opt": convert_opt, "t5": convert_t5}
