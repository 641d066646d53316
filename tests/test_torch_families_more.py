"""The Qwen2, GPT-J, MPT, GLM-4 and ChatGLM2/3 decoder families in the port
against the JAX package (and the Hugging Face models themselves, where
``transformers`` has them), and the attention kernels' plain versions at
GPT-J's head dim 256.

Five tiny cases (2 layers, width 32; ChatGLM 3 layers, ``helpers``' shared
geometry), each an HF-named state dict drawn from a numpy seed, so the same
tensors go through the JAX converter and the port's:

- ``qwen2``: ``transformers``' Qwen2 (GQA, QKV biases hardwired on);
- ``gptj``: GPT-J (one shared LN, parallel block, interleaved rotary on 4
  of 8 head dims, untied head with its bias);
- ``mpt``: MPT (ALiBi, fused ``Wqkv``, no biases, tied);
- ``glm``: HF GLM-4 (GQA, partial GLM rotary, fused ``gate_up_proj``);
- ``chatglm``: ``tests/helpers.chatglm_test_setup`` (THUDM's remote-code
  names), its HF oracle the GLM-4 model mapped onto the same tensors, as
  the JAX package's ``tests/test_model_parity.py`` does.

Classes (ROADMAP.md): converted trees identical; float32 forward logits atol
2e-5 against JAX and 2e-3 against the HF model; engine rows at
``EngineConfig()`` on the dense route and on the causal kernel's plain
version (MPT dense only: ALiBi) with verdicts and completions identical and
probabilities rtol 2e-5; the kernels' plain versions at D=256 within atol
2e-5, rtol 1e-4 of the interpret-mode Pallas kernels.
"""

import dataclasses
import functools
import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.models import convert as jconvert
from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import loader
from llm_interpretation_replication_tpu_torch.utils import tokenizer as ttok
from test_torch_families import (ATOL, HF_ATOL, _encode, assert_rows_match,
                                 base_strings, instruct_strings, pairs, tok)
from test_torch_slots import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

tattn = importlib.import_module(
    "llm_interpretation_replication_tpu_torch.ops.attention")
jattn = importlib.import_module("llm_interpretation_replication_tpu.ops.attention")

KERNEL_ATOL, KERNEL_RTOL = 2e-5, 1e-4
CASES = {
    # case: (family, transformers class stem or None, config keys)
    "qwen2": ("llama", "Qwen2", dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64,
        max_position_embeddings=256, use_sliding_window=False,
        tie_word_embeddings=False)),
    "gptj": ("gptj", "GPTJ", dict(
        n_embd=32, n_layer=2, n_head=4, rotary_dim=4, n_positions=256,
        activation_function="gelu_new", tie_word_embeddings=False)),
    "mpt": ("mpt", "Mpt", dict(
        d_model=32, n_heads=4, n_layers=2, expansion_ratio=2,
        max_seq_len=256)),
    "glm": ("glm", "Glm", dict(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        partial_rotary_factor=0.5, pad_token_id=0,
        max_position_embeddings=256, tie_word_embeddings=False)),
    "chatglm": ("chatglm", None, {}),
}


def _draw(rng, name, shape):
    """A parameter drawn as ``test_torch_families`` draws them: norm scales
    near 1, biases and weights non-zero."""
    x = rng.standard_normal(shape).astype(np.float32)
    if "norm" in name or ".ln_" in name or name.startswith("transformer.ln"):
        return 1.0 + 0.1 * x if name.endswith("weight") else 0.1 * x
    if name.endswith("bias"):
        return 0.1 * x
    return (0.5 if "embed" in name or "wte" in name else 0.15) * x


@functools.lru_cache(maxsize=None)
def hf_case(case, seed=13):
    """(HF config, HF model or None, float32 state dict): the model's
    parameters redrawn from a numpy seed (ChatGLM's from ``helpers``), the
    " Yes" and " No" rows of the output projection scaled by 4."""
    family, stem, kw = CASES[case]
    if stem is None:
        from helpers import chatglm_test_setup

        hf_cfg, sd = chatglm_test_setup(vocab_size=len(tok()))
        sd = {k: v.float() for k, v in sd.items()}
        head = sd["transformer.output_layer.weight"]
        model = None
    else:
        import transformers

        hf_cfg = getattr(transformers, f"{stem}Config")(
            vocab_size=len(tok()), **kw)
        model = getattr(transformers, f"{stem}ForCausalLM")(hf_cfg).eval()
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(_draw(rng, name, tuple(p.shape))))
            head = model.get_output_embeddings().weight
        sd = None
    with torch.no_grad():
        for word in ("Yes", "No"):
            head[tok().ids[" " + word]] *= 4.0
    if sd is None:
        sd = {k: v for k, v in model.state_dict().items()
              if v.is_floating_point()}
    return hf_cfg, model, sd


@functools.lru_cache(maxsize=None)
def models(case):
    """(family, jax cfg, port cfg, jax params, port weights) converted from
    the same state dict by each package's converter."""
    hf_cfg, _, sd = hf_case(case)
    family, jcfg = jconfig.from_hf_config(hf_cfg)
    tfamily, tcfg = tconfig.from_hf_config(hf_cfg)
    assert tfamily == family == CASES[case][0]
    jtree = jconvert.CONVERTERS[family](
        jconvert.getter_from_torch_state_dict(sd), jcfg)
    ttree = convert.CONVERTERS[family](lambda name: sd[name], tcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jtree)
    return family, jcfg, tcfg, params, tdec.DecoderWeights(tcfg, ttree)


@functools.lru_cache(maxsize=None)
def chatglm_oracle():
    """HF's GLM-4 model holding ChatGLM's tensors: the same block (RMSNorm,
    biased QKV, two K/V groups, rotary on half of each head, chunked
    SwiGLU, untied head), written by another code base."""
    from transformers import GlmConfig, GlmForCausalLM

    hf, _, sd = hf_case("chatglm")
    n, d, g = hf.num_attention_heads, hf.kv_channels, hf.multi_query_group_num
    nd, kvd = n * d, g * d
    model = GlmForCausalLM(GlmConfig(
        vocab_size=len(tok()), hidden_size=hf.hidden_size,
        intermediate_size=hf.ffn_hidden_size,
        num_hidden_layers=hf.num_layers, num_attention_heads=n,
        num_key_value_heads=g, head_dim=d, partial_rotary_factor=0.5,
        attention_bias=True, rms_norm_eps=hf.layernorm_epsilon,
        rope_theta=10000.0, tie_word_embeddings=False,
        attention_dropout=0.0, max_position_embeddings=hf.seq_length,
        pad_token_id=0)).eval()
    mapped = {}
    for i in range(hf.num_layers):
        src, dst = f"transformer.encoder.layers.{i}", f"model.layers.{i}"
        w = sd[f"{src}.self_attention.query_key_value.weight"]
        b = sd[f"{src}.self_attention.query_key_value.bias"]
        for name, lo, hi in (("q", 0, nd), ("k", nd, nd + kvd),
                             ("v", nd + kvd, nd + 2 * kvd)):
            mapped[f"{dst}.self_attn.{name}_proj.weight"] = w[lo:hi]
            mapped[f"{dst}.self_attn.{name}_proj.bias"] = b[lo:hi]
        mapped[f"{dst}.self_attn.o_proj.weight"] = \
            sd[f"{src}.self_attention.dense.weight"]
        mapped[f"{dst}.mlp.gate_up_proj.weight"] = \
            sd[f"{src}.mlp.dense_h_to_4h.weight"]
        mapped[f"{dst}.mlp.down_proj.weight"] = sd[f"{src}.mlp.dense_4h_to_h.weight"]
        for ln in ("input_layernorm", "post_attention_layernorm"):
            mapped[f"{dst}.{ln}.weight"] = sd[f"{src}.{ln}.weight"]
    mapped["model.embed_tokens.weight"] = \
        sd["transformer.embedding.word_embeddings.weight"]
    mapped["model.norm.weight"] = sd["transformer.encoder.final_layernorm.weight"]
    mapped["lm_head.weight"] = sd["transformer.output_layer.weight"]
    model.load_state_dict(mapped, strict=True)
    return model


def engines(case, impl="xla", **ecfg):
    family, jcfg, tcfg, params, weights = models(case)
    jeng = jengine.ScoringEngine(
        family, dataclasses.replace(jcfg, attention_impl=impl), params, tok(),
        engine_config=jengine.EngineConfig(**ecfg))
    teng = tengine.ScoringEngine(
        family, dataclasses.replace(tcfg, attention_impl=impl), weights, tok(),
        engine_config=tengine.EngineConfig(**ecfg), device="cpu")
    return jeng, teng


# -- configs -------------------------------------------------------------------

MPT_REFUSALS = [
    dict(alibi=False), dict(kv_n_heads=2), dict(clip_qkv=8.0), dict(qk_ln=True)]


@pytest.mark.parametrize("attn", MPT_REFUSALS,
                         ids=[next(iter(a)) for a in MPT_REFUSALS])
def test_mpt_refusals_match_reference(attn):
    """MPT without ALiBi, with GQA, ``clip_qkv`` or ``qk_ln`` raises the JAX
    package's ``ValueError``, word for word."""
    hf = types.SimpleNamespace(model_type="mpt", d_model=32, n_heads=4,
                               n_layers=2, vocab_size=64, attn_config=attn)
    with pytest.raises(ValueError) as ref:
        jconfig.from_hf_config(hf)
    with pytest.raises(ValueError) as got:
        tconfig.from_hf_config(hf)
    assert str(got.value) == str(ref.value)


def test_case_configs_match_reference():
    for case in CASES:
        _, jcfg, tcfg, _, _ = models(case)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), case
    assert models("gptj")[2].head_dim == 8 and models("gptj")[2].rotary_pct == 0.5
    assert models("mpt")[2].flash_refusal().startswith("ALiBi")


# -- trees, logits -----------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_converted_tree_matches_reference(case):
    _, _, _, params, weights = models(case)
    ref = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {path: t.numpy() for path, t in tdec._flatten(weights.tree())}
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    if case == "gptj":
        assert ("lm_head_bias",) in got


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_match_reference_and_hf(case):
    """float32 logits of a right-padded batch within 2e-5 of JAX's and 2e-3
    of the HF model's (ChatGLM's: the GLM-4 oracle on its tensors).

    GLM-4: the JAX package's ``rotary_style="glm"`` (rotate-half pairs
    (i, i + rd/2) at frequencies repeated across dims), which the port
    copies, is not this ``transformers``' ``GlmForCausalLM``, which rotates
    the pairs (2i, 2i + 1): the port is held to JAX with the reference's
    style, and to HF with the pairs HF rotates (``"interleaved"``), so the
    rest of the block (fused ``gate_up_proj``, GQA, QKV biases, the partial
    rotary) is held to HF all the same."""
    _, jcfg, tcfg, params, weights = models(case)
    ids, mask = _encode(base_strings()[:3] + instruct_strings()[:2])
    args = (torch.from_numpy(ids), torch.from_numpy(mask))
    got = tdec.forward(weights, tcfg, *args).numpy()
    ref = np.asarray(jdec.forward(params, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], atol=ATOL, rtol=1e-5)
    if case == "glm":
        got = tdec.forward(weights, dataclasses.replace(
            tcfg, rotary_style="interleaved"), *args).numpy()
    model = hf_case(case)[1] if case != "chatglm" else chatglm_oracle()
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids),
                   attention_mask=torch.from_numpy(mask)).logits
    np.testing.assert_allclose(got[real], hf.numpy()[real], atol=HF_ATOL,
                               rtol=1e-3)


@pytest.mark.parametrize("case", [c for c in CASES if c != "mpt"])
def test_flash_forward_matches_reference(case):
    """``attention_impl="flash"``: the causal kernel's plain version on the
    CPU against JAX's interpret-mode kernel route."""
    _, jcfg, tcfg, params, weights = models(case)
    ids, mask = _encode(base_strings()[:3] + instruct_strings()[:2])
    got = tdec.forward(weights, dataclasses.replace(tcfg, attention_impl="flash"),
                       torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jdec.forward(
        params, dataclasses.replace(jcfg, attention_impl="flash"),
        jnp.asarray(ids), jnp.asarray(mask)))
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], atol=ATOL, rtol=1e-5)


# -- engine rows ------------------------------------------------------------------------

@pytest.mark.parametrize("case,impl", [
    (c, impl) for c in CASES for impl in ("xla", "flash")
    if not (c == "mpt" and impl == "flash")])
def test_engine_rows_match_reference(case, impl):
    """``EngineConfig()``: base prompts as strings and as (prefix, suffix)
    pairs, on the dense route and the causal kernel's plain version."""
    jeng, teng = engines(case, impl)
    for prompts in (base_strings(), pairs(True)):
        got = teng.score_prompts(prompts)
        assert_rows_match(got, jeng.score_prompts(prompts))


# -- snapshots through the loader ----------------------------------------------------------

def _config_json(case):
    hf_cfg = hf_case(case)[0]
    if isinstance(hf_cfg, types.SimpleNamespace):
        return dict(vars(hf_cfg))
    return hf_cfg.to_dict()


@pytest.mark.parametrize("case", list(CASES))
def test_load_model_reads_snapshot(tmp_path, case):
    """A snapshot of each new type (its ``config.json`` as ``transformers``
    writes it, MPT's ``attn_config`` a dict; the tensors in a safetensors
    file) loads through ``load_model`` to the converter's tree."""
    _, _, sd = hf_case(case)
    (tmp_path / "config.json").write_text(json.dumps(_config_json(case)))
    chip_smoke._write_safetensors(str(tmp_path / "model.safetensors"), sd)
    family, cfg, weights = loader.load_model(str(tmp_path), dtype="fp32",
                                             device="cpu")
    want = models(case)
    assert family == want[0]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want[2])
    got = dict(tdec._flatten(weights.tree()))
    ref = dict(tdec._flatten(want[4].tree()))
    assert got.keys() == ref.keys()
    for k in got:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("model_type", ["chatglm", "xgen"])
def test_remote_code_tokenizers_refused(tmp_path, model_type):
    """ChatGLM's and XGen's tokenizers exist only as remote code: loading
    either raises ``NotImplementedError`` naming the tokenizer item."""
    (tmp_path / "config.json").write_text(json.dumps({"model_type": model_type}))
    files = chip_smoke._format_tokenizer_files("falcon", ["a b c"])
    chip_smoke._write_tokenizer_files(str(tmp_path), files)
    with pytest.raises(NotImplementedError, match="Snapshot tokenizers"):
        ttok.load_tokenizer(str(tmp_path))


# -- the kernels at head dim 256 --------------------------------------------------------------

D256 = 256


def _kernel_inputs(seed, b, s, n, g, d, layout):
    rng = np.random.default_rng(seed)
    qs, ks = ((b, s, n, d), (b, s, g, d)) if layout == "bsnd" else \
        ((b, n, s, d), (b, g, s, d))
    q = rng.standard_normal(qs).astype(np.float32)
    k = rng.standard_normal(ks).astype(np.float32)
    v = rng.standard_normal(ks).astype(np.float32)
    # a mid-tile row and a length-0 row
    return q, k, v, np.array([s - s // 3, 0], np.int32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,g", [(4, 4), (8, 2)])
@pytest.mark.parametrize("s", [48, 65])
def test_causal_grouped_d256_matches_reference(s, n, g, causal):
    """The causal kernel's plain version at D=256 against the interpret-mode
    Pallas kernel where its wrapper takes S (``pick_block_pos``), else
    against the reference's dense path; all rows, length-0 rows zero."""
    q, k, v, lengths = _kernel_inputs(70 + s, 2, s, n, g, D256, "bsnd")
    if jattn.pick_block_pos(s, n // g) is not None:
        ref = np.asarray(jattn.causal_grouped_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths,
            causal=causal, interpret=True))
    else:
        tr = (0, 2, 1, 3)
        kh, vh = (np.repeat(t.transpose(tr), n // g, axis=1) for t in (k, v))
        ref = np.asarray(jattn._dense_attention(
            jnp.asarray(q.transpose(tr)), jnp.asarray(kh), jnp.asarray(vh),
            jnp.asarray(lengths), causal)).transpose(tr)
    got = tattn.causal_grouped_attention(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)), causal).numpy()
    np.testing.assert_allclose(got, ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    np.testing.assert_array_equal(got[1], 0.0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,g", [(4, 4), (8, 2)])
@pytest.mark.parametrize("s", [48, 65])
@pytest.mark.parametrize("kernel", ["grouped", "flash"])
def test_head_major_d256_matches_reference(kernel, s, n, g, causal):
    """The head-major grouped (K/V unrepeated) and flash (K/V repeated)
    kernels' plain versions at D=256 against the interpret-mode Pallas
    kernels (flash where ``pick_block`` takes S, else the dense path)."""
    q, k, v, lengths = _kernel_inputs(90 + s, 2, s, n, g, D256, "bnsd")
    if kernel == "flash":
        k, v = (np.repeat(t, n // g, axis=1) for t in (k, v))
    args = [jnp.asarray(a) for a in (q, k, v)]
    if kernel == "grouped":
        ref = jattn.grouped_attention(*args, lengths, causal=causal,
                                      interpret=True)
    elif jattn.pick_block(s, jattn.DEFAULT_BLOCK_Q) is not None:
        ref = jattn.flash_attention(*args, lengths, causal=causal,
                                    interpret=True)
    else:
        ref = jattn._dense_attention(*args, jnp.asarray(lengths), causal)
    fn = getattr(tattn, f"{kernel}_attention")
    got = fn(*(torch.from_numpy(a) for a in (q, k, v, lengths)), causal).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=KERNEL_ATOL,
                               rtol=KERNEL_RTOL)
    np.testing.assert_array_equal(got[1], 0.0)


@pytest.mark.parametrize("head_axis", [2, 1])
@pytest.mark.parametrize("d,ok", [(256, True), (264, False)])
def test_kernel_check_takes_d256(d, ok, head_axis):
    """The wrapper's check before a launch takes D=256 (GPT-J) and refuses
    D=264 in both layouts."""
    b, s, n, g = 2, 16, 4, 2
    shape_q = (b, s, n, d) if head_axis == 2 else (b, n, s, d)
    shape_k = (b, s, g, d) if head_axis == 2 else (b, g, s, d)
    q = torch.zeros(shape_q, dtype=torch.bfloat16)
    k = torch.zeros(shape_k, dtype=torch.bfloat16)
    lengths = torch.full((b,), s, dtype=torch.int32)
    if ok:
        tattn._check_kernel_inputs(q, k, k.clone(), lengths, head_axis)
    else:
        with pytest.raises(ValueError, match="D <= 256"):
            tattn._check_kernel_inputs(q, k, k.clone(), lengths, head_axis)
