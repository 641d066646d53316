"""Model configuration (a copy of what the port needs from
``llm_interpretation_replication_tpu/models/config.py``): ``DecoderConfig``,
``T5Config``, the GPT-NeoX, Falcon, BLOOM, LLaMA/Mistral, Qwen (first
generation), Baichuan(2), OPT and T5 family translators, ``from_hf_config``
for their model types and the two Falcon geometries.  Other family presets
come with the slices that port them."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

_ITEM_FAMILIES = "ROADMAP.md queue 1, 'Other decoder families'"


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


#: HF ``model_type`` -> (family, config translator), for the types ported
FAMILY_BY_MODEL_TYPE = {
    "gpt_neox": ("neox", neox_config),
    "falcon": ("falcon", falcon_config),
    "RefinedWeb": ("falcon", falcon_config),
    "RefinedWebModel": ("falcon", falcon_config),
    "bloom": ("bloom", bloom_config),
    "llama": ("llama", llama_config),
    "mistral": ("llama", llama_config),
    "qwen": ("qwen", qwen_config),
    "baichuan": ("baichuan", baichuan_config),
    "opt": ("opt", opt_config),
    "t5": ("t5", t5_config),
}


def from_hf_config(hf) -> Tuple[str, Union[DecoderConfig, T5Config]]:
    """Map a HF config (any object with its attributes) to (family, our
    config).  GPT-NeoX, Falcon, BLOOM, LLaMA/Mistral, Qwen, Baichuan, OPT
    and T5 model types are ported; another raises ``NotImplementedError``
    naming its ROADMAP.md item."""
    mt = getattr(hf, "model_type", None)
    if mt not in FAMILY_BY_MODEL_TYPE:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported yet ({_ITEM_FAMILIES})")
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

#: The same architecture at test scale (MQA + parallel attention + shared LN).
FLAGSHIP_SMALL_GEOMETRY = dict(
    vocab_size=1024, hidden_size=256, num_layers=4, num_heads=8,
    num_kv_heads=1, intermediate_size=1024, parallel_residual=True,
    shared_layernorm=True, qkv_bias=False, out_bias=False, mlp_bias=False,
    position_embedding="rotary", tie_word_embeddings=True,
    max_position_embeddings=512,
)
