"""T5-family encoder-decoder in PyTorch (port of
``llm_interpretation_replication_tpu/models/t5.py``).

The scoring leg of T0, tk-instruct and Flan-T5: the engine reads the first
decoder tokens' distributions.  T5's specifics, as in the reference:

- RMS layer norm without mean subtraction, eps inside rsqrt (float32);
- a relative-position bias from a bucket table owned by layer 0 and shared
  by every layer (bidirectional buckets in the encoder, causal in the
  decoder);
- no 1/sqrt(d) attention scale (T5 folds it into its initialization), and a
  float32 softmax over scores plus bias plus mask;
- a gated-GELU MLP (v1.1, T0: ``wi0``/``wi1``) or a ReLU one (``wi``);
- with tied embeddings the decoder output is scaled by ``d_model**-0.5``.

The weights live in :class:`T5Weights` (``DecoderWeights``' holder), in the
reference's stacked layout::

    shared                      [V, D]
    encoder/rel_bias            [num_buckets, N]
    encoder/layers/ln1,ln2      {scale: [L, D]}
    encoder/layers/attn/{wq,wk,wv,wo}
    encoder/layers/mlp/{wi | wi0, wi1, wo}
    encoder/final_ln            {scale: [D]}
    decoder/rel_bias            [num_buckets, N]
    decoder/layers/ln1,ln2,ln3  {scale: [L, D]}
    decoder/layers/self_attn/*, cross_attn/*, mlp/*
    decoder/final_ln            {scale: [D]}
    lm_head                     [D, V]    (absent when tied)

:func:`greedy_decode` re-runs the decoder over its short token prefix at
every step (no decoder KV cache), as the reference does; the cross
attention's keys and values over the encoder output are computed once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from .config import T5Config
from .decoder import DecoderWeights, _layer, _matmul_f32, _tree, rms_norm


class T5Weights(DecoderWeights):
    """Owns a T5 model's weights in the stacked layout above."""


def _relative_position_bucket(relative_position, bidirectional: bool,
                              num_buckets: int, max_distance: int):
    """T5's bucketing of key-minus-query offsets (the reference's, which
    adds 1e-6 inside the log)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def _position_bias(cfg: T5Config, rel_bias_table, q_pos, k_pos,
                   bidirectional: bool):
    """Query/key positions ``[S]``, ``[T]`` -> float32 bias ``[N, S, T]``."""
    rel = k_pos[None, :] - q_pos[:, None]
    buckets = _relative_position_bucket(
        rel, bidirectional, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    return rel_bias_table[buckets].permute(2, 0, 1).float()


def _mask_bias(mask):
    """``[B, T]`` key mask -> additive float32 bias ``[B, 1, 1, T]``."""
    return torch.where(mask[:, None, None, :].bool(), 0.0, NEG_INF).float()


def _kv(ap, kv_in, num_heads: int, d_kv: int):
    b, t, _ = kv_in.shape
    return ((kv_in @ ap["wk"]).reshape(b, t, num_heads, d_kv),
            (kv_in @ ap["wv"]).reshape(b, t, num_heads, d_kv))


def _t5_attention(ap, q_in, kv, bias, num_heads: int, d_kv: int):
    """Attention without the 1/sqrt(d) scale; ``kv`` is (k, v) ``[B, T, N,
    d_kv]``."""
    b, s, _ = q_in.shape
    k, v = kv
    q = (q_in @ ap["wq"]).reshape(b, s, num_heads, d_kv)
    scores = torch.einsum("bsnd,btnd->bnst", q, k).float() + bias
    probs = torch.softmax(scores, dim=-1).to(q_in.dtype)
    out = torch.einsum("bnst,btnd->bsnd", probs, v).reshape(
        b, s, num_heads * d_kv)
    return out @ ap["wo"]


def _t5_mlp(cfg: T5Config, mp, x):
    if cfg.feed_forward_proj == "gated-gelu":
        h = F.gelu(x @ mp["wi0"], approximate="tanh") * (x @ mp["wi1"])
    else:
        h = F.relu(x @ mp["wi"])
    return h @ mp["wo"]


def encode(params, cfg: T5Config, enc_ids, enc_mask):
    """Encoder hidden states ``[B, S, D]`` of right-padded ``enc_ids``."""
    p = _tree(params)
    s = enc_ids.shape[1]
    x = p["shared"][enc_ids]
    pos = torch.arange(s, device=enc_ids.device)
    bias = (_position_bias(cfg, p["encoder"]["rel_bias"], pos, pos, True)[None]
            + _mask_bias(enc_mask))
    layers = p["encoder"]["layers"]
    for i in range(cfg.num_layers):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        x = x + _t5_attention(lp["attn"], h, _kv(lp["attn"], h, cfg.num_heads,
                                                 cfg.d_kv),
                              bias, cfg.num_heads, cfg.d_kv)
        x = x + _t5_mlp(cfg, lp["mlp"],
                        rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps))
    return rms_norm(x, p["encoder"]["final_ln"]["scale"], cfg.norm_eps)


def _cross_kv(p, cfg: T5Config, enc_hidden):
    """Every decoder layer's cross-attention (k, v) over the encoder."""
    layers = p["decoder"]["layers"]["cross_attn"]
    return [_kv(_layer(layers, i), enc_hidden, cfg.num_heads, cfg.d_kv)
            for i in range(cfg.num_decoder_layers)]


def _decoder_stack(p, cfg: T5Config, x, self_bias, cross_bias, cross_kv):
    layers = p["decoder"]["layers"]
    for i in range(cfg.num_decoder_layers):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        x = x + _t5_attention(
            lp["self_attn"], h, _kv(lp["self_attn"], h, cfg.num_heads,
                                    cfg.d_kv),
            self_bias, cfg.num_heads, cfg.d_kv)
        x = x + _t5_attention(
            lp["cross_attn"], rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps),
            cross_kv[i], cross_bias, cfg.num_heads, cfg.d_kv)
        x = x + _t5_mlp(cfg, lp["mlp"],
                        rms_norm(x, lp["ln3"]["scale"], cfg.norm_eps))
    return rms_norm(x, p["decoder"]["final_ln"]["scale"], cfg.norm_eps)


def _unembed(p, cfg: T5Config, x):
    """float32 logits; a tied model scales the hidden by ``d_model**-0.5``
    and reads ``shared.T``."""
    if cfg.tie_word_embeddings:
        x = x * (cfg.d_model ** -0.5)
        return _matmul_f32(x, p["shared"].T)
    return _matmul_f32(x, p["lm_head"])


def _causal_self_bias(p, cfg: T5Config, s: int, device):
    pos = torch.arange(s, device=device)
    causal = pos[:, None] >= pos[None, :]
    return (_position_bias(cfg, p["decoder"]["rel_bias"], pos, pos, False)
            + torch.where(causal, 0.0, NEG_INF))[None]


@torch.no_grad()
def forward(params, cfg: T5Config, enc_ids, enc_mask, dec_ids):
    """Teacher-forced decoder logits ``[B, S_dec, V]`` (float32)."""
    p = _tree(params)
    enc_hidden = encode(p, cfg, enc_ids, enc_mask)
    x = p["shared"][dec_ids]
    x = _decoder_stack(p, cfg, x,
                       _causal_self_bias(p, cfg, dec_ids.shape[1],
                                         dec_ids.device),
                       _mask_bias(enc_mask), _cross_kv(p, cfg, enc_hidden))
    return _unembed(p, cfg, x)


@torch.no_grad()
def greedy_decode(params, cfg: T5Config, enc_ids, enc_mask, num_steps: int,
                  eos_token_id: Optional[int] = None,
                  score_steps: Optional[int] = None):
    """Greedy generation from ``decoder_start_token_id``.

    Returns (tokens ``[B, num_steps]``, scores ``[B, K, V]``): ``scores[:,
    i]`` is the float32 distribution token ``i`` was picked from, for the
    first ``K = score_steps`` steps (all steps by default); later steps
    keep their tokens only.  After a row emits ``eos_token_id`` it emits
    only that id."""
    p = _tree(params)
    b = enc_ids.shape[0]
    dev = enc_ids.device
    enc_hidden = encode(p, cfg, enc_ids, enc_mask)
    cross_kv = _cross_kv(p, cfg, enc_hidden)
    cross_bias = _mask_bias(enc_mask)
    k = num_steps if score_steps is None else min(score_steps, num_steps)
    self_bias = _causal_self_bias(p, cfg, num_steps + 1, dev)
    tokens = torch.full((b, num_steps + 1), cfg.decoder_start_token_id,
                        dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    scores = []
    for i in range(num_steps):
        x = p["shared"][tokens[:, :i + 1]]
        x = _decoder_stack(p, cfg, x, self_bias[:, :, :i + 1, :i + 1],
                           cross_bias, cross_kv)
        step_logits = _unembed(p, cfg, x[:, i])
        nxt = torch.argmax(step_logits, dim=-1)
        if eos_token_id is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        tokens[:, i + 1] = nxt
        if i < k:
            scores.append(step_logits)
    return tokens[:, 1:].to(torch.int32), torch.stack(scores, dim=1)
