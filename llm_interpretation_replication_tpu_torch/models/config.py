"""Model configuration (a copy of what the port needs from
``llm_interpretation_replication_tpu/models/config.py``): ``DecoderConfig``,
``T5Config``, every family translator (GPT-NeoX, Falcon, BLOOM,
LLaMA/Mistral/XGen, Qwen and Qwen2, Baichuan(2), OPT, GPT-J, MPT, GLM-4,
ChatGLM2/3 and T5), ``from_hf_config`` for their model types, the two
Falcon geometries and ``BENCH_GEOMETRIES``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    # Grouped/multi-query attention: Falcon-7B uses 1 kv head (MQA).
    num_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    intermediate_size: Optional[int] = None

    # Position encoding: "rotary" | "alibi" | "learned"
    position_embedding: str = "rotary"
    rotary_pct: float = 1.0
    # "half" (LLaMA/NeoX), "interleaved" (GPT-J, ChatGLM2), "glm" (GLM-4)
    rotary_style: str = "half"
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    learned_pos_offset: int = 0

    # Block structure
    parallel_residual: bool = False
    shared_layernorm: bool = False
    norm_type: str = "layernorm"     # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    embedding_layernorm: bool = False

    # Projections
    qkv_bias: bool = True
    out_bias: bool = True
    mlp_bias: bool = True
    fused_qkv: bool = False
    mlp_type: str = "mlp"             # "mlp" | "gated"
    activation: str = "gelu"          # "gelu" | "gelu_new" | "silu" | "relu"

    sliding_window: Optional[int] = None
    norm_head: bool = False
    tie_word_embeddings: bool = False
    final_norm: bool = True
    logit_scale: float = 1.0
    # "xla"   -- dense attention (plain PyTorch in the port)
    # "flash" -- the causal grouped attention kernel for every prompt forward
    #            (causal + right-padding only; rejected for ALiBi / window)
    # "auto"  -- dense up to ``auto_flash_seq``, the kernel beyond it
    attention_impl: str = "xla"
    auto_flash_seq: int = 1024
    kv_cache_dtype: str = "bf16"      # "bf16" | "int8" (codes + per-head scales)

    def __post_init__(self):
        if self.num_kv_heads is None:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_heads)
        if self.intermediate_size is None:
            object.__setattr__(self, "intermediate_size", 4 * self.hidden_size)
        if self.attention_impl not in ("xla", "flash", "auto"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {self.kv_cache_dtype!r}")
        refusal = self.flash_refusal()
        if self.attention_impl == "flash" and refusal:
            raise ValueError(
                f"flash attention kernel supports causal+padding only "
                f"({refusal})"
            )

    def flash_refusal(self) -> Optional[str]:
        """Why the causal kernel cannot carry this model's prompt forwards
        (it takes neither an ALiBi bias nor a sliding window), else None."""
        if self.position_embedding == "alibi":
            return "ALiBi; the causal kernel takes no bias"
        if self.sliding_window is not None:
            return (f"sliding window {self.sliding_window}; the causal kernel "
                    f"takes no window")
        return None

    def use_flash_attention(self, seq_len: int) -> bool:
        """Resolve the attention impl for a prompt forward at ``seq_len``."""
        if self.attention_impl == "flash":
            return True
        if self.attention_impl == "auto":
            return seq_len > self.auto_flash_seq and not self.flash_refusal()
        return False


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Encoder-decoder config of the T0 / tk-instruct / Flan-T5 scoring leg
    (the engine scores the first decoder tokens)."""

    vocab_size: int
    d_model: int
    num_layers: int          # encoder layers
    num_decoder_layers: int
    num_heads: int
    d_kv: int
    d_ff: int
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    norm_eps: float = 1e-6
    # T5 v1.1 / T0 use gated-gelu; the original T5 relu
    feed_forward_proj: str = "gated-gelu"
    tie_word_embeddings: bool = False
    decoder_start_token_id: int = 0

    def flash_refusal(self) -> Optional[str]:
        """Why the causal kernel cannot carry this model's attention: T5
        adds a relative position bias and scales nothing."""
        return "T5; the causal kernel takes no position bias"


def neox_config(hf) -> DecoderConfig:
    """GPT-NeoX: Pythia/Dolly, StableLM-alpha, RedPajama-INCITE, h2ogpt."""
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        intermediate_size=hf.intermediate_size,
        position_embedding="rotary",
        rotary_pct=getattr(hf, "rotary_pct", 0.25),
        rope_theta=getattr(hf, "rotary_emb_base", 10000.0),
        max_position_embeddings=hf.max_position_embeddings,
        parallel_residual=getattr(hf, "use_parallel_residual", True),
        norm_eps=hf.layer_norm_eps,
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        fused_qkv=True,
        activation=_act(getattr(hf, "hidden_act", "gelu")),
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
    )


def falcon_config(hf) -> DecoderConfig:
    """Falcon-7B(-Instruct): MQA, parallel attention, shared LN, no biases."""
    new_arch = getattr(hf, "new_decoder_architecture", False)
    if new_arch:
        num_kv = getattr(hf, "num_kv_heads", None) or hf.num_attention_heads
    else:
        # old arch (falcon-7b): multi_query governs
        num_kv = 1 if getattr(hf, "multi_query", True) else hf.num_attention_heads
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        num_kv_heads=num_kv,
        intermediate_size=getattr(hf, "ffn_hidden_size", 4 * hf.hidden_size),
        position_embedding="alibi" if getattr(hf, "alibi", False) else "rotary",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        max_position_embeddings=getattr(hf, "max_position_embeddings", 2048),
        parallel_residual=getattr(hf, "parallel_attn", True),
        shared_layernorm=getattr(hf, "parallel_attn", True) and not new_arch,
        norm_eps=getattr(hf, "layer_norm_epsilon", 1e-5),
        qkv_bias=getattr(hf, "bias", False),
        out_bias=getattr(hf, "bias", False),
        mlp_bias=getattr(hf, "bias", False),
        fused_qkv=True,
        activation="gelu",
        tie_word_embeddings=True,
    )


def bloom_config(hf) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.n_layer,
        num_heads=hf.n_head,
        intermediate_size=4 * hf.hidden_size,
        position_embedding="alibi",
        max_position_embeddings=getattr(hf, "seq_length", 2048),
        embedding_layernorm=True,
        norm_eps=hf.layer_norm_epsilon,
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        fused_qkv=True,
        activation="gelu_new",
        tie_word_embeddings=True,
    )


def llama_config(hf) -> DecoderConfig:
    """LLaMA-2 / Mistral: RMSNorm + SwiGLU + RoPE."""
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        num_kv_heads=getattr(hf, "num_key_value_heads", hf.num_attention_heads),
        head_dim=getattr(hf, "head_dim", None) or hf.hidden_size // hf.num_attention_heads,
        intermediate_size=hf.intermediate_size,
        position_embedding="rotary",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        max_position_embeddings=hf.max_position_embeddings,
        norm_type="rmsnorm",
        norm_eps=hf.rms_norm_eps,
        qkv_bias=getattr(hf, "attention_bias", False),
        out_bias=False,
        mlp_bias=getattr(hf, "mlp_bias", False),
        mlp_type="gated",
        activation=_act(hf.hidden_act),
        sliding_window=getattr(hf, "sliding_window", None),
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
    )


def qwen_config(hf) -> DecoderConfig:
    """Qwen-7B(-Chat), first generation (``model_type: "qwen"``): a
    LLaMA-style RMSNorm + RoPE + SwiGLU block whose HF ``intermediate_size``
    is twice the MLP width, with a QKV bias and no other bias."""
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        head_dim=getattr(hf, "kv_channels", None) or hf.hidden_size // hf.num_attention_heads,
        intermediate_size=hf.intermediate_size // 2,
        position_embedding="rotary",
        rope_theta=getattr(hf, "rotary_emb_base", 10000.0),
        rotary_pct=getattr(hf, "rotary_pct", 1.0),
        max_position_embeddings=getattr(hf, "seq_length", 8192),
        norm_type="rmsnorm",
        norm_eps=hf.layer_norm_epsilon,
        qkv_bias=True,
        out_bias=False,
        mlp_bias=False,
        fused_qkv=True,
        mlp_type="gated",
        activation="silu",
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
    )


def qwen2_config(hf) -> DecoderConfig:
    """Qwen2/Qwen1.5: llama-shaped but QKV bias is hardwired on in the HF
    model (no ``attention_bias`` config attr).  Checkpoints ship a
    ``sliding_window`` value alongside ``use_sliding_window: false``; the
    window only applies when the latter is set."""
    cfg = dataclasses.replace(llama_config(hf), qkv_bias=True, out_bias=False)
    if not getattr(hf, "use_sliding_window", False):
        cfg = dataclasses.replace(cfg, sliding_window=None)
    return cfg


def baichuan_config(hf) -> DecoderConfig:
    """Baichuan(2)-7B/13B(-Chat) (``model_type: "baichuan"``): a LLaMA
    block with a fused ``W_pack`` QKV; rotary at 7B (32 layers), ALiBi at
    13B (40), and Baichuan2's NormHead when the vocabulary is over 100k."""
    is_13b = hf.num_hidden_layers >= 40
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        intermediate_size=hf.intermediate_size,
        position_embedding="alibi" if is_13b else "rotary",
        max_position_embeddings=getattr(hf, "max_position_embeddings", None)
        or getattr(hf, "model_max_length", 4096),
        norm_type="rmsnorm",
        norm_eps=hf.rms_norm_eps,
        qkv_bias=False,
        out_bias=False,
        mlp_bias=False,
        fused_qkv=True,
        mlp_type="gated",
        activation="silu",
        norm_head=hf.vocab_size > 100_000,  # Baichuan2
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
    )


def gptj_config(hf) -> DecoderConfig:
    """GPT-J-6B / GPT-JT-6B (``model_type: "gptj"`` — togethercomputer/GPT-JT
    in the reference's commented word-meaning roster,
    compare_instruct_models.py:162).  Parallel attn+mlp off ONE shared LN
    (Falcon-style block), interleaved RoPE on ``rotary_dim`` dims, no
    qkv/out biases but fc biases, untied lm_head WITH bias."""
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.n_embd,
        num_layers=hf.n_layer,
        num_heads=hf.n_head,
        intermediate_size=getattr(hf, "n_inner", None) or 4 * hf.n_embd,
        position_embedding="rotary",
        rotary_pct=(hf.rotary_dim or hf.n_embd // hf.n_head)
        / (hf.n_embd // hf.n_head),
        rotary_style="interleaved",
        max_position_embeddings=hf.n_positions,
        parallel_residual=True,
        shared_layernorm=True,
        norm_eps=hf.layer_norm_epsilon,
        qkv_bias=False,
        out_bias=False,
        mlp_bias=True,
        activation=_act(getattr(hf, "activation_function", "gelu_new")),
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
    )


def mpt_config(hf) -> DecoderConfig:
    """MPT-7B(-Instruct) (``model_type: "mpt"`` — mosaicml/mpt-7b-instruct in
    the reference's commented word-meaning roster,
    compare_instruct_models.py:157).  ALiBi, fused Wqkv, and — with the
    standard ``no_bias: true`` — no biases anywhere including LayerNorm."""
    attn_cfg = getattr(hf, "attn_config", None)
    alibi, kv_heads, clip_qkv, qk_ln = True, None, None, False
    if attn_cfg is not None:
        _get = attn_cfg.get if isinstance(attn_cfg, dict) else (
            lambda k, d=None: getattr(attn_cfg, k, d))
        alibi = _get("alibi", True)
        kv_heads = _get("kv_n_heads", None)
        clip_qkv = _get("clip_qkv", None)
        qk_ln = _get("qk_ln", False)
    if not alibi:
        # HF's MPT port itself has no learned-position path; neither do we.
        raise ValueError("MPT without ALiBi (attn_config.alibi=false) is unsupported")
    if kv_heads is not None and kv_heads != hf.n_heads:
        raise ValueError("GQA MPT (attn_config.kv_n_heads) is unsupported")
    if clip_qkv:
        raise ValueError("MPT clip_qkv (e.g. mpt-30b/storywriter) is unsupported")
    if qk_ln:
        raise ValueError("MPT qk_ln checkpoints are unsupported")
    no_bias = getattr(hf, "no_bias", True)
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.d_model,
        num_layers=hf.n_layers,
        num_heads=hf.n_heads,
        intermediate_size=int(getattr(hf, "expansion_ratio", 4) * hf.d_model),
        position_embedding="alibi",
        max_position_embeddings=getattr(hf, "max_seq_len", 2048),
        norm_eps=getattr(hf, "layer_norm_epsilon", 1e-5),
        qkv_bias=not no_bias,
        out_bias=not no_bias,
        mlp_bias=not no_bias,
        fused_qkv=True,
        activation="gelu",
        tie_word_embeddings=True,   # MPT always ties (no lm_head weight)
    )


def glm_config(hf) -> DecoderConfig:
    """GLM-4 (``model_type: "glm"``, HF-native GlmForCausalLM) — the current
    lineage of the ChatGLM family the reference's loader special-cases
    (compare_instruct_models.py:416-421).  LLaMA-shaped block with GQA, a
    partial GLM-convention RoPE, and QKV-only biases."""
    head_dim = getattr(hf, "head_dim", None) or hf.hidden_size // hf.num_attention_heads
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        num_kv_heads=getattr(hf, "num_key_value_heads", hf.num_attention_heads),
        head_dim=head_dim,
        intermediate_size=hf.intermediate_size,
        position_embedding="rotary",
        rotary_pct=getattr(hf, "partial_rotary_factor", 0.5),
        rotary_style="glm",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        max_position_embeddings=getattr(hf, "max_position_embeddings", 131072),
        norm_type="rmsnorm",
        norm_eps=hf.rms_norm_eps,
        qkv_bias=getattr(hf, "attention_bias", True),
        out_bias=False,
        mlp_bias=False,
        mlp_type="gated",
        activation=_act(getattr(hf, "hidden_act", "silu")),
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
    )


def chatglm_config(hf) -> DecoderConfig:
    """ChatGLM2/3-6B (``model_type: "chatglm"``, the trust_remote_code arch in
    the reference's roster — compare_instruct_models.py:165 (commented) and
    its tokenizer special-case ibid.:416-421).  RMSNorm + SwiGLU + GQA
    (``multi_query_group_num``) with interleaved RoPE on half the head dims.
    No in-process HF oracle exists offline (remote-code only), so conversion
    is structurally tested; the GLM-4 leg above is oracle-tested."""
    return DecoderConfig(
        vocab_size=getattr(hf, "padded_vocab_size", None) or hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_layers,
        num_heads=hf.num_attention_heads,
        num_kv_heads=(getattr(hf, "multi_query_group_num", None)
                      if getattr(hf, "multi_query_attention", False) else None),
        head_dim=getattr(hf, "kv_channels", None),
        intermediate_size=hf.ffn_hidden_size,
        position_embedding="rotary",
        rotary_pct=0.5,
        rotary_style="interleaved",
        rope_theta=10000.0 * getattr(hf, "rope_ratio", 1.0),
        max_position_embeddings=getattr(hf, "seq_length", 32768),
        norm_type="rmsnorm" if getattr(hf, "rmsnorm", True) else "layernorm",
        norm_eps=getattr(hf, "layernorm_epsilon", 1e-5),
        qkv_bias=getattr(hf, "add_qkv_bias", True),
        out_bias=getattr(hf, "add_bias_linear", False),
        mlp_bias=getattr(hf, "add_bias_linear", False),
        fused_qkv=True,
        mlp_type="gated",
        activation="silu",
        tie_word_embeddings=False,
    )


def opt_config(hf) -> DecoderConfig:
    """OPT / OPT-IML: learned positions stored with a +2 offset, biases
    everywhere."""
    return DecoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        intermediate_size=hf.ffn_dim,
        position_embedding="learned",
        learned_pos_offset=2,
        max_position_embeddings=hf.max_position_embeddings,
        norm_eps=1e-5,
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        activation=_act(hf.activation_function),
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", True),
    )


def t5_config(hf) -> T5Config:
    return T5Config(
        vocab_size=hf.vocab_size,
        d_model=hf.d_model,
        num_layers=hf.num_layers,
        num_decoder_layers=getattr(hf, "num_decoder_layers", hf.num_layers),
        num_heads=hf.num_heads,
        d_kv=hf.d_kv,
        d_ff=hf.d_ff,
        relative_attention_num_buckets=hf.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(hf, "relative_attention_max_distance", 128),
        norm_eps=hf.layer_norm_epsilon,
        feed_forward_proj="gated-gelu" if getattr(hf, "is_gated_act", False) else _act(hf.dense_act_fn),
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", True),
        decoder_start_token_id=hf.decoder_start_token_id or 0,
    )


def _act(name: str) -> str:
    return {
        "gelu": "gelu",
        "gelu_new": "gelu_new",
        "gelu_fast": "gelu_new",
        "gelu_pytorch_tanh": "gelu_new",
        "silu": "silu",
        "swish": "silu",
        "relu": "relu",
    }[name]


#: HF ``model_type`` -> (family, config translator)
FAMILY_BY_MODEL_TYPE = {
    "gpt_neox": ("neox", neox_config),
    "falcon": ("falcon", falcon_config),
    "RefinedWeb": ("falcon", falcon_config),
    "RefinedWebModel": ("falcon", falcon_config),
    "bloom": ("bloom", bloom_config),
    "llama": ("llama", llama_config),
    "mistral": ("llama", llama_config),
    "qwen": ("qwen", qwen_config),
    "qwen2": ("llama", qwen2_config),
    "baichuan": ("baichuan", baichuan_config),
    "opt": ("opt", opt_config),
    "gptj": ("gptj", gptj_config),
    "mpt": ("mpt", mpt_config),
    "glm": ("glm", glm_config),
    "chatglm": ("chatglm", chatglm_config),
    # Salesforce XGen ships LLaMA-architecture weights behind remote code;
    # only its tokenizer needs special handling (compare_instruct_models.py:409-415)
    "xgen": ("llama", llama_config),
    "t5": ("t5", t5_config),
}


def from_hf_config(hf) -> Tuple[str, Union[DecoderConfig, T5Config]]:
    """Map a HF config (any object with its attributes) to (family, our
    config); an unknown model type raises ``ValueError``."""
    mt = getattr(hf, "model_type", None)
    if mt not in FAMILY_BY_MODEL_TYPE:
        raise ValueError(f"unsupported model_type {mt!r}")
    family, translate = FAMILY_BY_MODEL_TYPE[mt]
    return family, translate(hf)


#: Falcon-7B's published geometry (tiiuae/falcon-7b config.json).
FALCON_7B_GEOMETRY = dict(
    vocab_size=65024, hidden_size=4544, num_layers=32, num_heads=71,
    num_kv_heads=1, intermediate_size=18176, parallel_residual=True,
    shared_layernorm=True, qkv_bias=False, out_bias=False, mlp_bias=False,
    position_embedding="rotary", tie_word_embeddings=True,
    max_position_embeddings=2048,
)

#: The bench's second synthetic geometry (a 1B GPT-NeoX-style decoder).
SMALL_1B_GEOMETRY = dict(
    vocab_size=50304, hidden_size=2048, num_layers=16, num_heads=16,
    intermediate_size=8192, parallel_residual=True, qkv_bias=True,
    out_bias=True, mlp_bias=True, position_embedding="rotary",
    rotary_pct=0.25, max_position_embeddings=2048,
)

#: The geometries ``plan search --model`` prices.
BENCH_GEOMETRIES = {"falcon-7b": FALCON_7B_GEOMETRY,
                    "small-1b": SMALL_1B_GEOMETRY}

#: The same architecture at test scale (MQA + parallel attention + shared LN).
FLAGSHIP_SMALL_GEOMETRY = dict(
    vocab_size=1024, hidden_size=256, num_layers=4, num_heads=8,
    num_kv_heads=1, intermediate_size=1024, parallel_residual=True,
    shared_layernorm=True, qkv_bias=False, out_bias=False, mlp_bias=False,
    position_embedding="rotary", tie_word_embeddings=True,
    max_position_embeddings=512,
)
