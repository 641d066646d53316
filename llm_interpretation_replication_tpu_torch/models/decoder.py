"""Decoder-only transformer: prefill and scored greedy decode in PyTorch.

Port of ``llm_interpretation_replication_tpu/models/decoder.py`` for the
binary scoring slice.  The weights live in :class:`DecoderWeights`, an
``nn.Module`` holding the reference's stacked layout (layer tensors carry a
leading ``L`` axis); the paths are functions on tensors that take
``weights.tree()``, the same nested dict the JAX functions take:

    embed/tokens            [V, H]
    layers/ln1/{scale,bias} [L, H]            (ln2 absent when shared)
    layers/attn/{wq,wk,wv}  [L, H, N*D] / [L, H, G*D]   (+ bq, bk, bv)
    layers/attn/wo          [L, N*D, H]       (+ bo)
    layers/mlp/wi, wo       [L, H, F], [L, F, H]  (+ wg when gated, biases)
    final_ln/{scale,bias}   [H]
    lm_head                 [H, V]            (absent when tied: embed.T)

``lax.scan`` over layers becomes a Python loop over layer views.  Softmax and
the final logits run in float32 whatever the weights' dtype; products run in
the weights' dtype, or on the int8 path where a projection carries a
``{key}_qscale`` (w8a8, ``ops.quant``).  The prompt forward's attention goes
through ``ops.attention.attention_bsnd`` (the Hopper kernel on the card) when
``DecoderConfig.use_flash_attention`` says so, else the dense path.  With
``kv_cache_dtype="int8"`` the prompt cache stores int8 codes and per-head
scales, quantized on append and dequantized at the decode attention.
:func:`extend_prefill` runs a suffix over a prefilled prefix cache (the
fused prefix-reuse path) through ``ops.attention.cache_extend_attention``,
and :func:`chunked_prefill` replays a long prompt through it chunk by chunk.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import DecoderConfig
from ..ops import quant
from ..ops.attention import NEG_INF, attention_bsnd, cache_extend_attention


class DecoderWeights(nn.Module):
    """Owns a decoder's weights in the reference's stacked layout.

    Each leaf of the nested param dict is a buffer named by its dotted path
    with ``__`` in place of ``.``; :meth:`tree` rebuilds the nested dict of
    (shared, not copied) tensors the path functions take.  int8 weights are
    stored once in the layout the int8 product takes
    (``quant.int8_matmul_layout``)."""

    def __init__(self, cfg: DecoderConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self._paths = []
        for path, t in _flatten(tree):
            if t.dtype == torch.int8:
                t = quant.int8_matmul_layout(t)
            self.register_buffer("__".join(path), t)
            self._paths.append(path)

    def tree(self) -> Dict:
        out: Dict = {}
        for path in self._paths:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return out


def _flatten(tree, prefix=()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _tree(params) -> Dict:
    return params.tree() if isinstance(params, DecoderWeights) else params


def _layer(layers: Dict, i: int) -> Dict:
    """Views of layer ``i`` of the stacked layer tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x, scale, eps):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _norm(cfg: DecoderConfig, x, p):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p.get("bias"), cfg.norm_eps)


def activation(name: str, x):
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_new":
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def rotary_embedding(positions, dim: int, theta: float, dtype=torch.float32):
    """Return (sin, cos) of shape [..., dim/2] for the given positions."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    angles = positions[..., None].float() * inv_freq
    return torch.sin(angles).to(dtype), torch.cos(angles).to(dtype)


def apply_rotary(x, sin, cos, rotary_dim: int, style: str = "half"):
    """RoPE on the first ``rotary_dim`` dims of the head axis.  x: [B, S, N,
    D]; sin/cos: [B, S, rotary_dim/2].  "half" pairs (i, i+rd/2), "interleaved"
    pairs (2i, 2i+1), "glm" is rotate-half with interleaved frequencies."""
    rot, pass_ = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    if style == "half":
        x1, x2 = rot[..., :half], rot[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    elif style == "interleaved":
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        rotated = torch.stack(
            [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
        ).reshape(rot.shape)
    elif style == "glm":
        cs = torch.repeat_interleave(cos, 2, dim=-1)
        sn = torch.repeat_interleave(sin, 2, dim=-1)
        x1, x2 = rot[..., :half], rot[..., half:]
        rotated = rot * cs + torch.cat([-x2, x1], dim=-1) * sn
    else:
        raise ValueError(f"unknown rotary style {style!r}")
    return torch.cat([rotated.to(x.dtype), pass_], dim=-1)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes (Press et al.; matches HF BLOOM/Falcon)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = pow2_slopes(closest)
        slopes += pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _repeat_kv(x, groups: int):
    """[B, T, Nkv, D] -> [B, T, Nkv*groups, D] for GQA/MQA."""
    if groups == 1:
        return x
    b, t, nkv, d = x.shape
    return x[:, :, :, None, :].expand(b, t, nkv, groups, d).reshape(
        b, t, nkv * groups, d)


def dot_product_attention(q, k, v, bias):
    """q: [B,S,N,D], k/v: [B,T,N,D], bias: broadcastable to [B,N,S,T]."""
    d = q.shape[-1]
    scale = torch.tensor(math.sqrt(d), dtype=q.dtype)
    scores = torch.einsum("bsnd,btnd->bnst", q, k) / scale
    scores = scores.float() + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def _grouped_scores(q, k):
    """q [B,S,N,D] x unrepeated k [B,T,G,D] -> scores [B,G,N/G,S,T]."""
    b, s, n, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, s, g, n // g, d)
    scale = torch.tensor(math.sqrt(d), dtype=q.dtype)
    return torch.einsum("bsghd,btgd->bghst", qg, k) / scale


def _bias_grouped(bias, b, n, g, s, t):
    bias = bias.expand(b, bias.shape[1], s, t)
    if bias.shape[1] == n:
        return bias.reshape(b, g, n // g, s, t)
    return bias[:, :, None]                        # head-agnostic [B,1,1,S,T]


def grouped_attention_two_block(q, kp, vp, bias_p, kt, vt, bias_t):
    """Attention over two K/V blocks with one joint softmax: the read-only
    prompt cache and the small per-chunk tail of generated tokens."""
    b, s, n, d = q.shape
    g = kp.shape[2]
    sp = _grouped_scores(q, kp).float() + _bias_grouped(
        bias_p, b, n, g, s, kp.shape[1])
    st = _grouped_scores(q, kt).float() + _bias_grouped(
        bias_t, b, n, g, s, kt.shape[1])
    m = torch.maximum(sp.amax(-1, keepdim=True), st.amax(-1, keepdim=True))
    ep = torch.exp(sp - m)
    et = torch.exp(st - m)
    denom = ep.sum(-1, keepdim=True) + et.sum(-1, keepdim=True)
    op = torch.einsum("bghst,btgd->bsghd", (ep / denom).to(q.dtype), vp)
    ot = torch.einsum("bghst,btgd->bsghd", (et / denom).to(q.dtype), vt)
    return (op + ot).reshape(b, s, n, d)


def make_attention_bias(cfg: DecoderConfig, q_positions, kv_positions, kv_valid):
    """Additive fp32 bias [B, N_or_1, S, T]: causal + padding + sliding
    window (+ ALiBi when configured)."""
    mask = q_positions[:, :, None] >= kv_positions[:, None, :]           # [B,S,T]
    mask = mask & kv_valid[:, None, :]
    if cfg.sliding_window is not None:
        mask = mask & (q_positions[:, :, None] - kv_positions[:, None, :]
                       < cfg.sliding_window)
    bias = torch.where(mask[:, None], 0.0, NEG_INF).float()
    if cfg.position_embedding == "alibi":
        slopes = alibi_slopes(cfg.num_heads, q_positions.device)
        dist = (q_positions[:, :, None] - kv_positions[:, None, :]).float()
        bias = bias - slopes[None, :, None, None] * dist[:, None]
    return bias


class KVCache(NamedTuple):
    """Read-only K/V block for decode: per-layer prompt K/V plus the
    slot->position mapping.  Decode never writes into it; each decode chunk
    keeps its new K/V in a small tail and folds it in once at the end.

    With ``kv_cache_dtype == "int8"`` k/v hold int8 codes and
    ``k_scale``/``v_scale`` the per-(layer, row, slot, head) fp32 scales
    (``quant.quantize_kv``), quantized on append (prefill, the end-of-chunk
    tail fold) and dequantized at the decode attention.  ``None`` scales
    mean the bf16 layout."""
    k: torch.Tensor          # [L, B, T, G, D] (compute dtype, or int8)
    v: torch.Tensor          # [L, B, T, G, D]
    positions: torch.Tensor  # [B, T] int64 absolute position of each slot
    valid: torch.Tensor      # [B, T] bool: slot holds a real token
    length: torch.Tensor     # [] int64 -- slots filled so far
    k_scale: Optional[torch.Tensor] = None  # [L, B, T, G] fp32 (int8 only)
    v_scale: Optional[torch.Tensor] = None  # [L, B, T, G] fp32 (int8 only)


def cache_kv_map(cache: KVCache, f, **replace) -> KVCache:
    """Apply ``f`` to the cache's k/v blocks and, when quantized, their
    scales; ``f`` acts only on the leading ``[L, B, T]`` axes the two share.
    Other fields are set from ``replace``."""
    return cache._replace(
        k=f(cache.k), v=f(cache.v),
        k_scale=None if cache.k_scale is None else f(cache.k_scale),
        v_scale=None if cache.v_scale is None else f(cache.v_scale),
        **replace)


def _deq(x, scale, dtype):
    """Cache block -> compute dtype: dequantize when per-head scales are
    present (int8 cache), plain cast otherwise."""
    if scale is None:
        return x.to(dtype)
    return quant.dequantize_kv(x, scale, dtype)


def _quantize_append(cfg: DecoderConfig, k, v):
    """(k, v, k_scale | None, v_scale | None) in the cache's storage layout
    for a freshly computed K/V block."""
    if cfg.kv_cache_dtype != "int8":
        return k, v, None, None
    kq, ks = quant.quantize_kv(k)
    vq, vs = quant.quantize_kv(v)
    return kq, vq, ks, vs


def _rotary_dim(cfg: DecoderConfig) -> int:
    return int(cfg.rotary_pct * cfg.head_dim) // 2 * 2


def _qkv(cfg: DecoderConfig, ap, x, sin_cos):
    b, s, _ = x.shape
    n, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = quant.linear(ap, "wq", x)
    k = quant.linear(ap, "wk", x)
    v = quant.linear(ap, "wv", x)
    if "bq" in ap:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = q.reshape(b, s, n, d)
    k = k.reshape(b, s, nkv, d)
    v = v.reshape(b, s, nkv, d)
    if sin_cos is not None:
        sin, cos = sin_cos
        rd = _rotary_dim(cfg)
        q = apply_rotary(q, sin, cos, rd, cfg.rotary_style)
        k = apply_rotary(k, sin, cos, rd, cfg.rotary_style)
    return q, k, v


def _out_proj(ap, out):
    b, s = out.shape[:2]
    out = quant.linear(ap, "wo", out.reshape(b, s, -1))
    if "bo" in ap:
        out = out + ap["bo"]
    return out


# ---------------------------------------------------------------------------
# Block + full forward
# ---------------------------------------------------------------------------

def _attn(cfg: DecoderConfig, lp, x, sin_cos, bias, cache_len=None,
          flash_lengths=None):
    """One attention sub-block.  With ``cache_len`` the prompt K/V are
    zero-padded to that many slots and returned as this layer's cache.  With
    ``flash_lengths`` the layout-native kernel path replaces the dense
    bias-based attention."""
    s = x.shape[1]
    n, nkv = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _qkv(cfg, lp["attn"], x, sin_cos)
    new_cache = None
    if cache_len is not None:
        pad = (0, 0, 0, 0, 0, cache_len - s)
        new_cache = (F.pad(k, pad), F.pad(v, pad))
        if flash_lengths is None:
            k, v = new_cache
    if flash_lengths is not None:
        out = attention_bsnd(q.contiguous(), k.contiguous(), v.contiguous(),
                             flash_lengths, causal=True)
    else:
        out = dot_product_attention(q, _repeat_kv(k, n // nkv),
                                    _repeat_kv(v, n // nkv), bias)
    return _out_proj(lp["attn"], out), new_cache


def _mlp(cfg: DecoderConfig, lp, x):
    mp = lp["mlp"]
    if cfg.mlp_type == "gated":
        gate = quant.linear(mp, "wg", x)
        up = quant.linear(mp, "wi", x)
        if "bg" in mp:
            gate, up = gate + mp["bg"], up + mp["bi"]
        hidden = activation(cfg.activation, gate) * up
    else:
        hidden = quant.linear(mp, "wi", x)
        if "bi" in mp:
            hidden = hidden + mp["bi"]
        hidden = activation(cfg.activation, hidden)
    out = quant.linear(mp, "wo", hidden)
    if "bo" in mp:
        out = out + mp["bo"]
    return out


def _residual(cfg: DecoderConfig, lp, x, ln1_out, attn_out):
    if cfg.parallel_residual:
        # NeoX/Falcon: mlp reads the same (or its own) LN of the block input
        mlp_in = ln1_out if cfg.shared_layernorm else _norm(cfg, x, lp["ln2"])
        return x + attn_out + _mlp(cfg, lp, mlp_in)
    x = x + attn_out
    return x + _mlp(cfg, lp, _norm(cfg, x, lp["ln2"]))


def _block(cfg: DecoderConfig, lp, x, sin_cos, bias, cache_len=None,
           flash_lengths=None):
    ln1_out = _norm(cfg, x, lp["ln1"])
    attn_out, new_cache = _attn(cfg, lp, ln1_out, sin_cos, bias, cache_len,
                                flash_lengths)
    return _residual(cfg, lp, x, ln1_out, attn_out), new_cache


def _embed(cfg: DecoderConfig, params, token_ids, positions):
    x = params["embed"]["tokens"][token_ids]
    if cfg.position_embedding == "learned":
        x = x + params["embed"]["pos"][positions + cfg.learned_pos_offset]
    if cfg.embedding_layernorm:
        ln = params["embed"]["ln"]
        x = layer_norm(x, ln["scale"], ln["bias"], cfg.norm_eps)
    return x


def _matmul_f32(x, w, chunk: int = 8192):
    """``x @ w`` accumulated and returned in float32.  Low-precision operands
    are upcast a column slice of ``w`` at a time (the products of bf16 values
    are exact in float32, so this is the reference's fp32-accumulating
    product up to summation order) to bound the float32 copy of ``w``."""
    if w.dtype == torch.float32:
        return x.float() @ w
    xf = x.float()
    return torch.cat([xf @ w[:, i:i + chunk].float()
                      for i in range(0, w.shape[1], chunk)], dim=-1)


def _final_hidden(cfg: DecoderConfig, params, x):
    """The final-normed hidden states the unembedding (and a K-head) read."""
    if cfg.final_norm:
        x = _norm(cfg, x, params["final_ln"])
    return x


def _unembed_hidden(cfg: DecoderConfig, params, x):
    """(final-normed hidden, fp32 logits)."""
    x = _final_hidden(cfg, params, x)
    table = params.get("lm_head")
    if table is None:
        table = params["embed"]["tokens"].T
    logits = _matmul_f32(x, table) * cfg.logit_scale
    bias = params.get("lm_head_bias")
    if bias is not None:
        logits = logits + bias.float()
    return x, logits


def _unembed(cfg: DecoderConfig, params, x):
    return _unembed_hidden(cfg, params, x)[1]


def _positions(attention_mask):
    """Right-padded prompts: position = running count of real tokens - 1."""
    return torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)


def run_layers(cfg: DecoderConfig, layers, x, positions, attention_mask):
    """Rotary setup + flash/dense attention dispatch + the loop over the
    stacked ``layers``."""
    mask = attention_mask.bool()
    sin_cos = None
    if cfg.position_embedding == "rotary":
        sin_cos = rotary_embedding(positions, _rotary_dim(cfg), cfg.rope_theta,
                                   x.dtype)
    use_flash = cfg.use_flash_attention(x.shape[1])
    bias = None if use_flash else make_attention_bias(cfg, positions, positions, mask)
    flash_lengths = (attention_mask.sum(-1).to(torch.int32).contiguous()
                     if use_flash else None)
    for i in range(cfg.num_layers):
        x, _ = _block(cfg, _layer(layers, i), x, sin_cos, bias, None,
                      flash_lengths)
    return x


def _trunk(params, cfg: DecoderConfig, token_ids, attention_mask,
           cache_len: Optional[int] = None):
    """Embed + blocks.  Returns (hidden [B,S,H], cache | None)."""
    b, s = token_ids.shape
    positions = _positions(attention_mask)
    x = _embed(cfg, params, token_ids, positions)
    if cache_len is None:
        return run_layers(cfg, params["layers"], x, positions, attention_mask), None

    sin_cos = None
    if cfg.position_embedding == "rotary":
        sin_cos = rotary_embedding(positions, _rotary_dim(cfg), cfg.rope_theta,
                                   params["embed"]["tokens"].dtype)
    t = cache_len
    mask = attention_mask.bool()
    # slot index == position for right-padded rows
    kv_positions = torch.arange(t, device=token_ids.device)[None, :].expand(b, t)
    kv_valid = F.pad(mask, (0, t - s))
    use_flash = cfg.use_flash_attention(s)
    flash_lengths = (attention_mask.sum(-1).to(torch.int32).contiguous()
                     if use_flash else None)
    bias = (None if use_flash
            else make_attention_bias(cfg, positions, kv_positions, kv_valid))
    # per layer (k, v, k_scale, v_scale): quantized on append, after the
    # layer's attention read its exact K/V
    per_layer = []
    for i in range(cfg.num_layers):
        x, (ck, cv) = _block(cfg, _layer(params["layers"], i), x, sin_cos,
                             bias, t, flash_lengths)
        per_layer.append(_quantize_append(cfg, ck, cv))
    ks, vs, kss, vss = zip(*per_layer)
    quantized = cfg.kv_cache_dtype == "int8"
    cache = KVCache(
        k=torch.stack(ks), v=torch.stack(vs), positions=kv_positions,
        valid=kv_valid, length=attention_mask.sum(-1).max(),
        k_scale=torch.stack(kss) if quantized else None,
        v_scale=torch.stack(vss) if quantized else None,
    )
    return x, cache


def _last_hidden(x, attention_mask):
    lengths = attention_mask.sum(-1)
    idx = (lengths - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]  # [B,1,H]


@torch.no_grad()
def forward(params, cfg: DecoderConfig, token_ids, attention_mask):
    """Full-sequence forward: fp32 logits [B, S, V]."""
    params = _tree(params)
    x, _ = _trunk(params, cfg, token_ids, attention_mask, None)
    return _unembed(cfg, params, x)


@torch.no_grad()
def forward_last_logits(params, cfg: DecoderConfig, token_ids, attention_mask):
    """fp32 logits at each row's last real position only -- [B, V]."""
    params = _tree(params)
    x, _ = _trunk(params, cfg, token_ids, attention_mask, None)
    return _unembed(cfg, params, _last_hidden(x, attention_mask))[:, 0, :]


@torch.no_grad()
def forward_anchor_logits(params, cfg: DecoderConfig, token_ids,
                          attention_mask, anchors):
    """fp32 logits at K anchor positions a row -- [B, K, V].

    The packed-scoring op (``scoring.packed``): a packed row carries K
    questions, each ending at an anchor token whose next-token logits score
    its answer.  The final hidden states are gathered at the anchors
    (``anchors`` [B, K] token indices within each row's real length) before
    the unembedding, so the logits never span the whole sequence."""
    params = _tree(params)
    x, _ = _trunk(params, cfg, token_ids, attention_mask, None)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return _unembed(cfg, params, x[rows, anchors.long()])


@torch.no_grad()
def prefill(params, cfg: DecoderConfig, token_ids, attention_mask, cache_len: int):
    """One prompt forward returning (last_logits [B, V] fp32 at each row's
    last real token, KVCache padded to ``cache_len`` slots)."""
    params = _tree(params)
    x, cache = _trunk(params, cfg, token_ids, attention_mask, cache_len)
    last = _unembed(cfg, params, _last_hidden(x, attention_mask))[:, 0, :]
    return last, cache


def _attn_extend(cfg: DecoderConfig, lp, x, sin_cos, bias, kp_l, vp_l,
                 ks_l=None, vs_l=None):
    """Attention sub-block of a suffix-extension prefill: the suffix's
    queries over the read-only prefix cache slice of this layer plus the
    suffix's own K/V, one joint softmax (``cache_extend_attention``, which
    dequantizes an int8 prefix block with ``ks_l``/``vs_l``).  Returns the
    suffix's K/V for the caller to append to the cache."""
    q, k, v = _qkv(cfg, lp["attn"], x, sin_cos)
    out = cache_extend_attention(q, kp_l, vp_l, k, v, bias,
                                 kp_scale=ks_l, vp_scale=vs_l)
    return _out_proj(lp["attn"], out), (k, v)


def _block_extend(cfg: DecoderConfig, lp, x, sin_cos, bias, kp_l, vp_l,
                  ks_l=None, vs_l=None):
    ln1_out = _norm(cfg, x, lp["ln1"])
    attn_out, new_kv = _attn_extend(cfg, lp, ln1_out, sin_cos, bias, kp_l,
                                    vp_l, ks_l, vs_l)
    return _residual(cfg, lp, x, ln1_out, attn_out), new_kv


@torch.no_grad()
def extend_prefill(params, cfg: DecoderConfig, cache: KVCache, token_ids,
                   attention_mask, prefix_lengths):
    """Suffix-extension prefill: the trunk over ``token_ids`` ([B, S]
    right-padded suffix tokens) attending over a prefilled prefix
    :class:`KVCache`, so each leg of a fused call extends one shared prefix
    cache instead of re-running the whole prompt.

    Suffix token j of row b sits at position ``prefix_lengths[b] + j``; one
    bias over the concatenated key axis (prefix slots, then suffix slots)
    gives causal masking inside the suffix and full sight of the valid
    prefix, the mask the full-prompt prefill builds.  The returned cache
    appends the suffix block's K/V (quantized on append for an int8 cache)
    and positions, so :func:`decode_steps` continues from it as from
    :func:`prefill`'s; the input cache is not modified.

    Returns (last_logits [B, V] fp32 at each row's last real suffix token,
    the extended KVCache, total lengths [B] = prefix + suffix real
    tokens)."""
    params = _tree(params)
    quantized = cache.k_scale is not None
    if quantized != (cfg.kv_cache_dtype == "int8"):
        raise ValueError(
            f"cache quantization ({'int8' if quantized else 'bf16'}) does "
            f"not match cfg.kv_cache_dtype={cfg.kv_cache_dtype!r}")
    s = token_ids.shape[1]
    mask = attention_mask.bool()
    positions = prefix_lengths[:, None] + _positions(attention_mask)  # [B, S]
    x = _embed(cfg, params, token_ids, positions)
    sin_cos = None
    if cfg.position_embedding == "rotary":
        sin_cos = rotary_embedding(positions, _rotary_dim(cfg), cfg.rope_theta,
                                   params["embed"]["tokens"].dtype)
    kv_positions = torch.cat([cache.positions, positions], dim=1)
    kv_valid = torch.cat([cache.valid, mask], dim=1)
    bias = make_attention_bias(cfg, positions, kv_positions, kv_valid)
    per_layer = []
    for i in range(cfg.num_layers):
        x, (k_s, v_s) = _block_extend(
            cfg, _layer(params["layers"], i), x, sin_cos, bias,
            cache.k[i], cache.v[i],
            cache.k_scale[i] if quantized else None,
            cache.v_scale[i] if quantized else None)
        per_layer.append(_quantize_append(cfg, k_s, v_s))
    ks, vs, kss, vss = zip(*per_layer)
    last = _unembed(cfg, params, _last_hidden(x, attention_mask))[:, 0, :]
    new_cache = KVCache(
        k=torch.cat([cache.k, torch.stack(ks).to(cache.k.dtype)], dim=2),
        v=torch.cat([cache.v, torch.stack(vs).to(cache.v.dtype)], dim=2),
        positions=kv_positions, valid=kv_valid, length=cache.length + s,
        k_scale=(torch.cat([cache.k_scale, torch.stack(kss)], dim=2)
                 if quantized else None),
        v_scale=(torch.cat([cache.v_scale, torch.stack(vss)], dim=2)
                 if quantized else None),
    )
    return last, new_cache, prefix_lengths + attention_mask.sum(-1)


@torch.no_grad()
def chunked_prefill(params, cfg: DecoderConfig, token_ids, attention_mask,
                    chunk: int):
    """Prompt forward in chunks of ``chunk`` tokens: chunk 0 runs the
    ordinary :func:`prefill` (the causal kernel when the flash path is on),
    and every later chunk replays through :func:`extend_prefill` against the
    cache built so far, so the widest attention transient is ``[B, chunk,
    S]`` instead of ``[B, S, S]``.  A chunk's queries attend over the
    concatenated key axis under one joint softmax with the monolithic
    forward's mask, so the result is the monolithic one up to rounding; an
    int8 cache's later chunks read its dequantized prefix.

    Returns (last_logits [B, V] fp32 at each row's last real token, KVCache
    over all ``S`` slots, n_chunks)."""
    s = token_ids.shape[1]
    c0 = min(int(chunk), s)
    last, cache = prefill(params, cfg, token_ids[:, :c0],
                          attention_mask[:, :c0], cache_len=c0)
    lengths = attention_mask[:, :c0].sum(-1)
    offset, n_chunks = c0, 1
    while offset < s:
        c = min(int(chunk), s - offset)
        sub_mask = attention_mask[:, offset:offset + c]
        nlast, cache, lengths = extend_prefill(
            params, cfg, cache, token_ids[:, offset:offset + c], sub_mask,
            lengths)
        # a row right-padded out before this chunk keeps the logits of the
        # chunk that holds its last token
        has = sub_mask.sum(-1) > 0
        last = torch.where(has[:, None], nlast, last)
        offset += c
        n_chunks += 1
    return last, cache, n_chunks


#: Candidates kept per step by the reduced score mode (the confidence leg's
#: 19-candidate contract); any yes/no scan with top_k <= this reads its
#: threshold from the kept candidates.
REDUCED_TOPK = 19


class ReducedScores(NamedTuple):
    """Per-step score statistics in place of stacked [B, P, V] logits."""
    topk_vals: torch.Tensor      # [B, P, REDUCED_TOPK] fp32 logits, descending
    topk_ids: torch.Tensor       # [B, P, REDUCED_TOPK] int64 token ids
    logz: torch.Tensor           # [B, P] fp32 logsumexp over the vocab
    target_logits: torch.Tensor  # [B, P, 2] fp32 logits at (yes_id, no_id)


def _reduce_step_scores(logits, target_ids):
    """One step's [B, V] logits -> (vals, ids, logz, tgt) for ReducedScores."""
    sub = logits.float()
    logz = torch.logsumexp(sub, dim=-1)
    vals, ids = torch.topk(sub, REDUCED_TOPK, dim=-1)
    tgt = torch.gather(sub, -1, target_ids.long())
    return vals, ids, logz, tgt


def _block_decode(cfg, lp, x, sin_cos, bias_p, bias_t, kp_l, vp_l, tk_l, tv_l,
                  i, ks_l=None, vs_l=None):
    """_block for one decode step, or for a K-token verify pass: the S
    tokens' K/V go into slots ``i .. i+S`` of the layer's tail (in place);
    the prompt cache slice is read-only."""
    ln1_out = _norm(cfg, x, lp["ln1"])
    attn_out = _attn_decode(cfg, lp, ln1_out, sin_cos, bias_p, bias_t, kp_l,
                            vp_l, tk_l, tv_l, i, ks_l, vs_l)
    return _residual(cfg, lp, x, ln1_out, attn_out)


def _attn_decode(cfg, lp, x, sin_cos, bias_p, bias_t, kp_l, vp_l, tk_l, tv_l,
                 i, ks_l=None, vs_l=None):
    q, k, v = _qkv(cfg, lp["attn"], x, sin_cos)
    # in-place write of slots i..i+S of the small tail (the reference's
    # dynamic-update-slice); the tail is the chunk's own buffer
    tk_l[:, i:i + k.shape[1]] = k.to(tk_l.dtype)
    tv_l[:, i:i + v.shape[1]] = v.to(tv_l.dtype)
    out = grouped_attention_two_block(
        q, _deq(kp_l, ks_l, x.dtype), _deq(vp_l, vs_l, x.dtype), bias_p,
        tk_l.to(x.dtype), tv_l.to(x.dtype), bias_t)
    return _out_proj(lp["attn"], out)


def _fold_tail(cache: KVCache, tail_k, tail_v, tail_positions) -> KVCache:
    """The end-of-chunk fold: one concat appends the chunk's tail to a new
    cache (the input cache is not modified); an int8 cache quantizes the
    tail here, once per generated token."""
    b, n = tail_positions.shape
    quantized = cache.k_scale is not None
    tk_s = tv_s = None
    if quantized:
        tail_k, tk_s = quant.quantize_kv(tail_k)
        tail_v, tv_s = quant.quantize_kv(tail_v)
    return KVCache(
        k=torch.cat([cache.k, tail_k], dim=2),
        v=torch.cat([cache.v, tail_v], dim=2),
        positions=torch.cat([cache.positions, tail_positions], dim=1),
        valid=torch.cat([cache.valid, torch.ones(
            (b, n), dtype=torch.bool, device=tail_positions.device)], dim=1),
        length=cache.length + n,
        k_scale=torch.cat([cache.k_scale, tk_s], dim=2) if quantized else None,
        v_scale=torch.cat([cache.v_scale, tv_s], dim=2) if quantized else None,
    )


@torch.no_grad()
def decode_steps(params, cfg: DecoderConfig, cache: KVCache, prev_logits,
                 lengths, offset: int, num_steps: int,
                 eos_token_id: Optional[int] = None, done=None,
                 with_scores=True, target_ids=None):
    """Continue a batched greedy decode from an existing KV cache.

    ``prev_logits`` [B, V] fp32 predict the next token; ``lengths`` [B] are
    the prompt lengths and ``offset`` the tokens generated before this call.
    ``with_scores``: True stacks the [B, n, V] fp32 scores, "reduced" stacks
    :class:`ReducedScores` (needs ``target_ids`` [B, 2]), False none.  Rows
    in ``done`` (EOS seen) emit ``eos_token_id`` from then on.

    Returns (tokens [B, n], scores, cache with this chunk's tail folded in,
    last_logits [B, V], done); ``scores[:, 0]`` are ``prev_logits``'s.  An
    int8 cache is read dequantized; the tail stays in the compute dtype for
    the chunk and is quantized when it is folded in."""
    params = _tree(params)
    quantized = cache.k_scale is not None
    if quantized != (cfg.kv_cache_dtype == "int8"):
        # folding a tail of the wrong storage into the cache would corrupt
        # every later read
        raise ValueError(
            f"cache quantization ({'int8' if quantized else 'bf16'}) does "
            f"not match cfg.kv_cache_dtype={cfg.kv_cache_dtype!r}")
    b = prev_logits.shape[0]
    n = num_steps
    dev = prev_logits.device
    if done is None:
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
    if with_scores == "reduced" and target_ids is None:
        raise ValueError("with_scores='reduced' needs target_ids [B, 2]")
    cdt = params["embed"]["tokens"].dtype if quantized else cache.k.dtype
    tail_shape = (cfg.num_layers, b, n, cfg.num_kv_heads, cfg.head_dim)
    tail_k = torch.zeros(tail_shape, dtype=cdt, device=dev)
    tail_v = torch.zeros(tail_shape, dtype=cdt, device=dev)
    # tail slot j holds the step-j token, at position lengths + offset + j
    steps = torch.arange(n, device=dev)
    tail_positions = lengths[:, None] + offset + steps[None, :]         # [B,n]
    layers = params["layers"]
    toks, outs = [], []
    for i in range(n):
        next_tok = torch.argmax(prev_logits, dim=-1)                    # [B]
        if eos_token_id is not None:
            next_tok = torch.where(done, eos_token_id, next_tok)
        q_pos = (lengths + offset + i)[:, None]                         # [B,1]
        bias_p = make_attention_bias(cfg, q_pos, cache.positions, cache.valid)
        tail_valid = (steps <= i)[None, :].expand(b, n)
        bias_t = make_attention_bias(cfg, q_pos, tail_positions, tail_valid)
        sin_cos = None
        if cfg.position_embedding == "rotary":
            sin_cos = rotary_embedding(q_pos, _rotary_dim(cfg), cfg.rope_theta,
                                       cdt)
        x = _embed(cfg, params, next_tok[:, None], q_pos)
        for li in range(cfg.num_layers):
            x = _block_decode(
                cfg, _layer(layers, li), x, sin_cos, bias_p, bias_t,
                cache.k[li], cache.v[li], tail_k[li], tail_v[li], i,
                cache.k_scale[li] if quantized else None,
                cache.v_scale[li] if quantized else None)
        step_logits = _unembed(cfg, params, x)[:, 0, :]
        if eos_token_id is not None:
            done = done | (next_tok == eos_token_id)
        if with_scores == "reduced":
            outs.append(_reduce_step_scores(prev_logits, target_ids))
        elif with_scores:
            outs.append(prev_logits)
        toks.append(next_tok)
        prev_logits = step_logits
    cache = _fold_tail(cache, tail_k, tail_v, tail_positions)
    if with_scores == "reduced":
        scores = ReducedScores(*(torch.stack(f, dim=1) for f in zip(*outs)))
    elif with_scores:
        scores = torch.stack(outs, dim=1)
    else:
        scores = None
    return torch.stack(toks, dim=1), scores, cache, prev_logits, done


@torch.no_grad()
def greedy_decode(params, cfg: DecoderConfig, token_ids, attention_mask,
                  num_steps: int, eos_token_id: Optional[int] = None):
    """Batched greedy decode of right-padded prompts: one prefill and
    ``num_steps`` single-token steps.  Returns (tokens [B, num_steps], fp32
    scores [B, num_steps, V] at each generated position)."""
    s = token_ids.shape[1]
    last, cache = prefill(params, cfg, token_ids, attention_mask, s)
    tokens, scores, _, _, _ = decode_steps(
        params, cfg, cache, last, attention_mask.sum(-1), 0, num_steps,
        eos_token_id, None, with_scores=True)
    return tokens, scores


# ---------------------------------------------------------------------------
# Joint next-K-token decode with verify-and-accept
# ---------------------------------------------------------------------------
#
# A K-head (per-offset logit projections off the last final-normed hidden
# state) proposes the next K tokens, and one joint pass over the proposed
# block (`k_verify_block`) checks them against the single-step argmax chain.
# The pass runs the decode path's own per-layer machinery (`_block_decode`,
# the two-block softmax, the chunk's tail buffer and its end-of-chunk fold),
# so an accepted block gives `decode_steps`' tokens exactly and its scores to
# float32 reduction-order noise (single-query blocks bit for bit).  Any
# mismatch is a rejection: the engine discards the pass and re-runs the chunk
# sequentially from its entry state, so a bad head costs passes, never rows.


class KVerifyOut(NamedTuple):
    """One joint verification pass over a proposed block of ``kb`` tokens."""
    tokens: torch.Tensor          # [B, kb] true tokens (EOS-frozen argmax chain)
    scores: Optional[object]      # ReducedScores | [B, kb, V] fp32 | None
    last_logits: torch.Tensor     # [B, V] fp32, predicting the next position
    last_hidden: torch.Tensor     # [B, H] final-normed hidden at the block's
    #                             # last position (the next proposals' input)
    done: torch.Tensor            # [B] EOS-done after the true chain
    a_len: torch.Tensor           # [B] leading proposals that match
    accepted: torch.Tensor        # [B] bool: the whole block matched
    tail_k: torch.Tensor          # the chunk's tail buffers (written in place)
    tail_v: torch.Tensor
    cache: Optional[KVCache]      # the folded cache when ``fold``, else None


def k_head_num_heads(k_head) -> int:
    """Look-ahead heads a K-head carries (a proposal block holds one more:
    position 0 is the free, exact argmax)."""
    if k_head is None:
        return 0
    return int(k_head["w"].shape[0])


def init_k_head(cfg: DecoderConfig, k: int, seed: int = 0, dtype=None,
                device=None):
    """Random K-head: ``k - 1`` per-offset logit projections [H, V], drawn
    from numpy's ``default_rng(seed)`` as the reference draws them (a head
    at a time, the same stream).  Random proposals verify and reject almost
    everywhere: the forced-rejection fixture."""
    import numpy as np

    heads = max(0, int(k) - 1)
    rng = np.random.default_rng(seed)
    w = torch.empty((heads, cfg.hidden_size, cfg.vocab_size),
                    dtype=dtype or torch.float32, device=device)
    for i in range(heads):
        draw = rng.standard_normal((cfg.hidden_size, cfg.vocab_size))
        w[i] = torch.from_numpy(draw.astype(np.float32) * np.float32(0.02))
    return {"w": w}


@torch.no_grad()
def distill_k_head(params, cfg: DecoderConfig, token_ids, attention_mask,
                   k: int, eos_token_id: Optional[int] = None,
                   gen_steps: Optional[int] = None, ridge: float = 1e-4):
    """Greedy self-distillation of the K-head on sample prompts.

    Each row greedy-generates ``gen_steps`` tokens (default ``k + 4``); one
    forward over prompt and continuation gives the final-normed hidden
    states along the greedy path, and head ``i`` is the ridge probe from
    the hidden at position ``t`` to the one-hot greedy token at ``t + 1 +
    i``: the reference's normal equations (:func:`ridge_probe`), solved
    with ``torch.linalg`` on the weights' device.  The continuation is appended right
    after each row's real tokens (no padding between them), so the
    teacher-forced forward is one right-padded batch on any attention
    path.  The head is stored in the weights' dtype."""
    tree = _tree(params)
    dtype = tree["embed"]["tokens"].dtype
    dev = tree["embed"]["tokens"].device
    heads = max(0, int(k) - 1)
    h_dim, v = cfg.hidden_size, cfg.vocab_size
    if heads == 0:
        return {"w": torch.zeros((0, h_dim, v), dtype=dtype, device=dev)}
    gen = int(gen_steps or (k + 4))
    ids = torch.as_tensor(token_ids, device=dev).long()
    mask = torch.as_tensor(attention_mask, device=dev).to(torch.int32)
    b, s = ids.shape
    toks, _ = greedy_decode(tree, cfg, ids, mask, gen, eos_token_id)
    lens = mask.sum(-1).long()
    slots = torch.arange(s + gen, device=dev)[None, :]
    seq = torch.zeros((b, s + gen), dtype=torch.long, device=dev)
    seq[:, :s] = ids * mask
    seq.scatter_(1, lens[:, None] + torch.arange(gen, device=dev)[None], toks)
    full_mask = (slots < (lens + gen)[:, None]).to(torch.int32)
    x, _ = _trunk(tree, cfg, seq, full_mask, None)
    hidden = _final_hidden(cfg, tree, x).float()               # [B, S+gen, H]
    lens_np = lens.cpu().tolist()
    toks_np = toks.cpu().tolist()
    ws = []
    for i in range(1, heads + 1):
        rows, at, targets = [], [], []
        for r in range(b):
            # the frontier hidden (position len-1) predicts greedy token i;
            # the hidden at greedy token jj predicts greedy token jj + 1 + i
            if i < gen:
                rows.append(r)
                at.append(lens_np[r] - 1)
                targets.append(toks_np[r][i])
            for jj in range(0, gen - 1 - i):
                rows.append(r)
                at.append(lens_np[r] + jj)
                targets.append(toks_np[r][jj + 1 + i])
        if not rows:
            ws.append(torch.zeros((h_dim, v), dtype=dtype, device=dev))
            continue
        hm = hidden[torch.as_tensor(rows, device=dev),
                    torch.as_tensor(at, device=dev)]           # [N, H]
        ws.append(ridge_probe(hm, torch.as_tensor(targets, device=dev), v,
                              ridge).to(dtype))
    return {"w": torch.stack(ws)}


def ridge_probe(features, targets, vocab_size: int, ridge: float = 1e-4):
    """The ridge probe ``(F^T F + ridge * N * I)^-1 F^T onehot(targets)``
    from features ``F`` [N, H] to one-hot targets, [H, V] float32.

    Formed and solved in float64 (the reference's ``numpy.linalg.solve``
    also solves its float32 system in double precision).  Final-normed
    hidden states lie close to a hyperplane, so the system's condition
    number reaches ~1e6 on the test geometry: there a float32 solve moves
    the head by ~0.5%, and the head's components along directions the
    features hardly span follow the features' float32 rounding, while its
    logits on the features themselves are stable."""
    f = features.double()
    h_dim = f.shape[1]
    a = f.T @ f + ridge * max(1, f.shape[0]) * torch.eye(
        h_dim, dtype=torch.float64, device=f.device)
    # F^T @ onehot(targets) without the [N, V] one-hot
    rhs = torch.zeros((h_dim, vocab_size), dtype=torch.float64,
                      device=f.device)
    rhs.index_add_(1, targets.long(), f.T)
    return torch.linalg.solve(a, rhs).float()


@torch.no_grad()
def k_propose(k_head, hidden, prev_logits, k: int, done=None,
              eos_token_id: Optional[int] = None):
    """[B, k] proposed next tokens: position 0 is the free, exact
    ``argmax(prev_logits)``; positions 1..k-1 project ``hidden`` (the last
    final-normed hidden state) through the K-head's per-offset matrices,
    accumulated in float32.  Rows already EOS-done propose EOS throughout."""
    cols = [torch.argmax(prev_logits, dim=-1)]
    for i in range(1, k):
        logits_i = _matmul_f32(hidden, k_head["w"][i - 1].to(hidden.dtype))
        cols.append(torch.argmax(logits_i, dim=-1))
    props = torch.stack(cols, dim=1)
    if eos_token_id is not None and done is not None:
        props = torch.where(done[:, None], eos_token_id, props)
    return props


@torch.no_grad()
def k_verify_block(params, cfg: DecoderConfig, cache: KVCache, tail_k, tail_v,
                   prev_logits, lengths, offset: int, block_start: int,
                   proposals, eos_token_id: Optional[int] = None, done=None,
                   target_ids=None, with_scores="reduced",
                   fold: bool = False) -> KVerifyOut:
    """One joint forward over a proposed token block and its verification
    against the single-step argmax chain.

    The block's ``kb`` proposals run as ``kb`` queries at positions
    ``lengths + offset + block_start + i`` through ``_block_decode``: the
    two-block softmax over the read-only cache and the chunk's ``n``-slot
    tail, their K/V written into tail slots ``block_start ..
    block_start+kb`` (in place; the caller allocates the tail per chunk),
    later slots masked.  The true token at block position ``i`` is the
    EOS-frozen argmax of the logits predicting it (``prev_logits`` at 0,
    the pass's own logits at ``i - 1`` after), computed with the exact ops
    of ``decode_steps``' step; ``a_len`` counts each row's leading matches
    and ``accepted`` says the whole block matched.  A row's outputs past its
    first mismatch are meaningless, so a caller keeps a pass only when every
    real row accepted.  ``fold=True`` (a chunk's last block) folds the tail
    into a new cache with ``decode_steps``' end-of-chunk fold, so the int8
    quantization points are the sequential path's."""
    params = _tree(params)
    quantized = cache.k_scale is not None
    if quantized != (cfg.kv_cache_dtype == "int8"):
        raise ValueError(
            f"cache quantization ({'int8' if quantized else 'bf16'}) does "
            f"not match cfg.kv_cache_dtype={cfg.kv_cache_dtype!r}")
    if with_scores == "reduced" and target_ids is None:
        raise ValueError("with_scores='reduced' needs target_ids [B, 2]")
    b, kb = proposals.shape
    n = tail_k.shape[2]
    offset, block_start = int(offset), int(block_start)
    dev = prev_logits.device
    if done is None:
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
    cdt = params["embed"]["tokens"].dtype if quantized else cache.k.dtype
    slots = torch.arange(n, device=dev)
    q_pos = (lengths[:, None] + offset + block_start
             + torch.arange(kb, device=dev)[None, :])
    tail_positions = lengths[:, None] + offset + slots[None, :]
    # slots of earlier blocks stay visible, later ones are masked; causality
    # inside the block comes from the position comparison, as in the steps
    tail_valid = (slots < block_start + kb)[None, :].expand(b, n)
    bias_p = make_attention_bias(cfg, q_pos, cache.positions, cache.valid)
    bias_t = make_attention_bias(cfg, q_pos, tail_positions, tail_valid)
    sin_cos = None
    if cfg.position_embedding == "rotary":
        sin_cos = rotary_embedding(q_pos, _rotary_dim(cfg), cfg.rope_theta,
                                   cdt)
    x = _embed(cfg, params, proposals.long(), q_pos)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        x = _block_decode(
            cfg, _layer(layers, li), x, sin_cos, bias_p, bias_t,
            cache.k[li], cache.v[li], tail_k[li], tail_v[li], block_start,
            cache.k_scale[li] if quantized else None,
            cache.v_scale[li] if quantized else None)
    hidden, logits_blk = _unembed_hidden(cfg, params, x)       # [B, kb, H|V]
    # the chain, position by position, with decode_steps' own step ops
    cur = done
    toks, outs = [], []
    for i in range(kb):
        pred = prev_logits if i == 0 else logits_blk[:, i - 1]
        nt = torch.argmax(pred, dim=-1)
        if eos_token_id is not None:
            nt = torch.where(cur, eos_token_id, nt)
            cur = cur | (nt == eos_token_id)
        if with_scores == "reduced":
            outs.append(_reduce_step_scores(pred, target_ids))
        elif with_scores:
            outs.append(pred)
        toks.append(nt)
    true_toks = torch.stack(toks, dim=1)
    if with_scores == "reduced":
        scores = ReducedScores(*(torch.stack(f, dim=1) for f in zip(*outs)))
    elif with_scores:
        scores = torch.stack(outs, dim=1)
    else:
        scores = None
    match = proposals.long() == true_toks
    a_len = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    new_cache = None
    if fold:
        new_cache = _fold_tail(cache, tail_k, tail_v, tail_positions)
    return KVerifyOut(true_toks, scores, logits_blk[:, -1], hidden[:, -1],
                      cur, a_len, a_len == kb, tail_k, tail_v, new_cache)
