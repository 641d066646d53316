"""The GPT-NeoX, BLOOM, LLaMA/Mistral, Qwen (first generation), Baichuan(2)
and OPT decoder families in the port against the JAX package (and the
Hugging Face models themselves, where ``transformers`` has them).

Five tiny cases, each a ``transformers`` model whose parameters are redrawn
from a numpy seed (norm scales near 1, biases and weights non-zero), so the
same HF-named state dict goes through the JAX converter and the port's:

- ``neox_parallel``: GPT-NeoX with parallel residual and ``rotary_pct`` 0.25;
- ``neox_sequential``: GPT-NeoX with sequential residual, ``rotary_pct`` 1.0;
- ``bloom``: ALiBi, embedding LayerNorm, tied head;
- ``llama_gqa``: RMSNorm, SwiGLU, 4 query heads on 2 K/V heads;
- ``mistral_window``: the same with ``sliding_window`` 8, on prompts longer
  than 8 tokens.

Classes (ROADMAP.md): converted trees identical; float32 forward logits
atol 2e-5 against JAX and 2e-3 against the HF model; engine rows at
``EngineConfig()`` (50-token completions), on strings and on ``(prefix,
suffix)`` pairs, with verdicts and completions identical and probabilities
rtol 2e-5; int8 KV within 0.05 of JAX's int8 KV rows.  The prompts are the
100-question sweep's formats of its first questions under a word-level
tokenizer both engines take.

The Qwen-7B and Baichuan(2) architectures ship as remote code, so their
cases are HF-named state dicts drawn from a numpy seed (``NEW_CASES``):
``qwen`` (fused ``c_attn`` with a bias, the halved MLP), ``baichuan_7b``
(fused ``W_pack``, rotary) and ``baichuan_13b`` (40 layers: ALiBi), both
with a vocabulary over 100k so NormHead applies; ``opt`` is a
``transformers`` OPT (learned positions stored with the +2 offset, ReLU,
biases), held to the HF model too.
"""

import dataclasses
import functools
import json
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
from llm_interpretation_replication_tpu.runtime import loader as jloader
from llm_interpretation_replication_tpu_torch.config import ordinary_meaning_questions
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import loader
from llm_interpretation_replication_tpu_torch.scoring import prompts as tprompts
from llm_interpretation_replication_tpu_torch.utils.tokenizer import WordTokenizer
from test_torch_slots import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-5, 2e-5
HF_ATOL = 2e-3
INT8_KV_DREL = 0.05
QUESTIONS = ordinary_meaning_questions()[:6]
PROB_FIELDS = ("yes_prob", "no_prob", "relative_prob", "odds_ratio",
               "first_token_yes_prob", "first_token_no_prob",
               "first_token_relative_prob")
_SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=256)
CASES = {
    "neox_parallel": ("GPTNeoX", dict(
        _SMALL, rotary_pct=0.25, use_parallel_residual=True,
        tie_word_embeddings=False, hidden_act="gelu")),
    "neox_sequential": ("GPTNeoX", dict(
        _SMALL, rotary_pct=1.0, use_parallel_residual=False,
        tie_word_embeddings=False, hidden_act="gelu")),
    "bloom": ("Bloom", dict(hidden_size=32, n_layer=2, n_head=4)),
    "llama_gqa": ("Llama", dict(
        _SMALL, num_key_value_heads=2, hidden_act="silu",
        tie_word_embeddings=False)),
    "mistral_window": ("Mistral", dict(
        _SMALL, num_key_value_heads=2, hidden_act="silu",
        tie_word_embeddings=False, sliding_window=8)),
}
FAMILIES = {"neox_parallel": "neox", "neox_sequential": "neox",
            "bloom": "bloom", "llama_gqa": "llama", "mistral_window": "llama"}


@functools.lru_cache(maxsize=None)
def tok():
    words = (tprompts.FEW_SHOT_PREFIX + " " + tprompts.ANSWER_INSTRUCTION
             + " " + " ".join(QUESTIONS)).split()
    return WordTokenizer(words + ["Yes", "No"] + [f"w{i}" for i in range(120)])


def base_strings():
    return [tprompts.format_prompt(q, True) for q in QUESTIONS]


def instruct_strings():
    return [tprompts.format_prompt(q, False) for q in QUESTIONS]


def pairs(is_base=True):
    return [tuple(tprompts.format_prompt_parts(q, is_base)) for q in QUESTIONS]


@functools.lru_cache(maxsize=None)
def hf_model(case, seed=3):
    """The case's HF model with every parameter redrawn from a numpy seed;
    the " Yes" and " No" rows of its output projection scaled by 4, so that
    some rows find a target in the top 5 and others do not."""
    import transformers

    arch, kw = CASES[case]
    hf_cfg = getattr(transformers, f"{arch}Config")(vocab_size=len(tok()), **kw)
    model = getattr(transformers, f"{arch}ForCausalLM")(hf_cfg).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = rng.standard_normal(p.shape).astype(np.float32)
            if "norm" in name and name.endswith("weight"):
                x = 1.0 + 0.1 * x
            elif name.endswith("bias"):
                x = 0.1 * x
            elif "embed" in name:
                x = 0.5 * x
            else:
                x = 0.15 * x
            p.copy_(torch.from_numpy(x))
        head = model.get_output_embeddings().weight
        for word in ("Yes", "No"):
            head[tok().ids[" " + word]] *= 4.0
    return model


def state_dict(case):
    return {k: v for k, v in hf_model(case).state_dict().items()
            if v.is_floating_point()}


@functools.lru_cache(maxsize=None)
def models(case):
    """(family, jax cfg, port cfg, jax params, port weights) converted from
    the same state dict by each package's converter."""
    if case in NEW_CASES:
        hf_cfg, sd = new_case(case)
    else:
        sd = state_dict(case)
        hf_cfg = hf_model(case).config
    family, jcfg = jconfig.from_hf_config(hf_cfg)
    tfamily, tcfg = tconfig.from_hf_config(hf_cfg)
    assert tfamily == family == FAMILIES.get(case, NEW_CASES.get(case, ("",))[0])
    jtree = jconvert.CONVERTERS[family](
        jconvert.getter_from_torch_state_dict(sd), jcfg)
    ttree = convert.CONVERTERS[family](lambda name: sd[name], tcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jtree)
    return family, jcfg, tcfg, params, tdec.DecoderWeights(tcfg, ttree)


def _with(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def _encode(strings):
    enc = [tok()(s)["input_ids"] for s in strings]
    width = max(map(len, enc))
    ids = np.zeros((len(enc), width), np.int64)
    mask = np.zeros((len(enc), width), np.int32)
    for i, e in enumerate(enc):
        ids[i, :len(e)], mask[i, :len(e)] = e, 1
    return ids, mask


def engines(case, impl="xla", **ecfg):
    family, jcfg, tcfg, params, weights = models(case)
    jeng = jengine.ScoringEngine(
        family, _with(jcfg, attention_impl=impl), params, tok(),
        engine_config=jengine.EngineConfig(**ecfg))
    teng = tengine.ScoringEngine(
        family, _with(tcfg, attention_impl=impl), weights, tok(),
        engine_config=tengine.EngineConfig(**ecfg), device="cpu")
    return jeng, teng


def assert_rows_match(got, ref, rtol=RTOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"]
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=rtol, atol=1e-9,
                                       err_msg=f)


# -- config translators ------------------------------------------------------

HF_JSON = {
    "gpt_neox": dict(model_type="gpt_neox", vocab_size=50432, hidden_size=4096,
                     num_hidden_layers=32, num_attention_heads=32,
                     intermediate_size=16384, rotary_pct=0.25,
                     rotary_emb_base=10000, max_position_embeddings=2048,
                     use_parallel_residual=True, layer_norm_eps=1e-5,
                     hidden_act="gelu", tie_word_embeddings=False),
    # BLOOM's own short keys (bigscience/bloom-7b1 config.json)
    "bloom": dict(model_type="bloom", vocab_size=250880, hidden_size=4096,
                  n_layer=30, n_head=32, layer_norm_epsilon=1e-5,
                  seq_length=2048),
    "llama": dict(model_type="llama", vocab_size=32000, hidden_size=4096,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=32, intermediate_size=11008,
                  max_position_embeddings=4096, rms_norm_eps=1e-5,
                  hidden_act="silu", tie_word_embeddings=False),
    "mistral": dict(model_type="mistral", vocab_size=32000, hidden_size=4096,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, intermediate_size=14336,
                    max_position_embeddings=32768, rms_norm_eps=1e-5,
                    rope_theta=10000.0, sliding_window=4096,
                    hidden_act="silu", tie_word_embeddings=False),
    # Qwen/Qwen-7B-Chat (the MLP is half of intermediate_size)
    "qwen": dict(model_type="qwen", vocab_size=151936, hidden_size=4096,
                 num_hidden_layers=32, num_attention_heads=32,
                 intermediate_size=22016, kv_channels=128,
                 layer_norm_epsilon=1e-6, max_position_embeddings=8192,
                 seq_length=8192, rotary_emb_base=10000, rotary_pct=1.0,
                 tie_word_embeddings=False),
    # baichuan-inc/Baichuan2-7B-Chat (rotary, NormHead)
    "baichuan": dict(model_type="baichuan", vocab_size=125696,
                     hidden_size=4096, num_hidden_layers=32,
                     num_attention_heads=32, intermediate_size=11008,
                     max_position_embeddings=4096, model_max_length=4096,
                     rms_norm_eps=1e-6, hidden_act="silu",
                     tie_word_embeddings=False),
    # baichuan-inc/Baichuan2-13B-Chat (ALiBi, NormHead, no
    # max_position_embeddings)
    "baichuan_13b": dict(model_type="baichuan", vocab_size=125696,
                         hidden_size=5120, num_hidden_layers=40,
                         num_attention_heads=40, intermediate_size=13696,
                         model_max_length=4096, rms_norm_eps=1e-6,
                         hidden_act="silu", tie_word_embeddings=False),
    # facebook/opt-iml-1.3b
    "opt": dict(model_type="opt", vocab_size=50272, hidden_size=2048,
                num_hidden_layers=24, num_attention_heads=32, ffn_dim=8192,
                max_position_embeddings=2048, activation_function="relu",
                do_layer_norm_before=True, word_embed_proj_dim=2048),
}


@pytest.mark.parametrize("model_type", list(HF_JSON))
def test_from_hf_config_matches_reference(tmp_path, model_type):
    """A ``config.json`` of each model type, read by each package's
    ``load_hf_config`` (BLOOM's ``n_layer``/``n_head`` aliased) and
    translated: equal configs, also straight from the namespace."""
    (tmp_path / "config.json").write_text(json.dumps(HF_JSON[model_type]))
    family, got = tconfig.from_hf_config(loader.load_hf_config(str(tmp_path)))
    jfamily, ref = jconfig.from_hf_config(jloader.load_hf_config(str(tmp_path)))
    assert family == jfamily
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    ns = types.SimpleNamespace(**HF_JSON[model_type])
    assert dataclasses.asdict(tconfig.from_hf_config(ns)[1]) == \
        dataclasses.asdict(jconfig.from_hf_config(ns)[1])
    if model_type == "bloom":
        assert (got.num_layers, got.num_heads) == (30, 32)
        assert got.position_embedding == "alibi" and got.embedding_layernorm
    if model_type == "mistral":
        assert (got.num_kv_heads, got.sliding_window) == (8, 4096)
    if model_type == "qwen":
        assert (got.intermediate_size, got.qkv_bias, got.out_bias) == \
            (11008, True, False)
    if model_type.startswith("baichuan"):
        assert got.norm_head and got.position_embedding == (
            "alibi" if model_type == "baichuan_13b" else "rotary")
    if model_type == "opt":
        assert (got.position_embedding, got.learned_pos_offset,
                got.tie_word_embeddings) == ("learned", 2, True)


@pytest.mark.parametrize("model_type,item", [
    ("mpt", "Other decoder families"), ("glm", "Other decoder families"),
    ("qwen2", "Other decoder families"), ("gptj", "Other decoder families")])
def test_other_model_types_raise(model_type, item):
    with pytest.raises(NotImplementedError, match=item):
        tconfig.from_hf_config(types.SimpleNamespace(model_type=model_type))


# -- converters and forward ---------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_converted_tree_matches_reference(case):
    _, _, _, params, weights = models(case)
    ref = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {path: t.numpy() for path, t in tdec._flatten(weights.tree())}
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_match_reference_and_hf(case):
    _, jcfg, tcfg, params, weights = models(case)
    ids, mask = _encode(base_strings()[:3] + instruct_strings()[:2])
    got = tdec.forward(weights, tcfg, torch.from_numpy(ids),
                       torch.from_numpy(mask)).numpy()
    ref = np.asarray(jdec.forward(params, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], atol=ATOL, rtol=1e-5)
    with torch.no_grad():
        hf = hf_model(case)(input_ids=torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask)).logits
    np.testing.assert_allclose(got[real], hf.numpy()[real], atol=HF_ATOL,
                               rtol=1e-3)


@pytest.mark.parametrize("case", ["neox_parallel", "llama_gqa"])
def test_flash_forward_matches_dense(case):
    """``attention_impl="flash"``: the causal kernel's plain version on the
    CPU, against JAX's interpret-mode kernel route and the dense path."""
    _, jcfg, tcfg, params, weights = models(case)
    ids, mask = _encode(base_strings()[:3] + instruct_strings()[:2])
    args = (torch.from_numpy(ids), torch.from_numpy(mask))
    got = tdec.forward(weights, _with(tcfg, attention_impl="flash"), *args)
    dense = tdec.forward(weights, tcfg, *args)
    ref = np.asarray(jdec.forward(params, _with(jcfg, attention_impl="flash"),
                                  jnp.asarray(ids), jnp.asarray(mask)))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], ref[real], atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy()[real], dense.numpy()[real],
                               atol=ATOL, rtol=1e-5)


def test_flash_refused_for_alibi_and_window():
    for case, why in (("bloom", "ALiBi"), ("mistral_window", "sliding window")):
        cfg = models(case)[2]
        assert cfg.flash_refusal().startswith(why)
        with pytest.raises(ValueError, match="flash"):
            _with(cfg, attention_impl="flash")
        auto = _with(cfg, attention_impl="auto")
        assert not auto.use_flash_attention(auto.auto_flash_seq + 1)
    assert models("llama_gqa")[2].flash_refusal() is None


# -- engine rows ---------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_engine_rows_match_reference(case):
    """``EngineConfig()``: base prompts as strings and as (prefix, suffix)
    pairs (``score_prefixed``), instruct prompts as pairs."""
    jeng, teng = engines(case)
    for prompts in (base_strings(), pairs(True), pairs(False)):
        ref = jeng.score_prompts(prompts)
        got = teng.score_prompts(prompts)
        assert_rows_match(got, ref)
    assert any(r["scan_found"] for r in got)


@pytest.mark.parametrize("case", ["neox_sequential", "llama_gqa"])
def test_engine_flash_rows_match_reference(case):
    jeng, teng = engines(case, impl="flash")
    assert_rows_match(teng.score_prompts(pairs(True)),
                      jeng.score_prompts(pairs(True)))


@pytest.mark.parametrize("case", ["bloom", "mistral_window"])
def test_engine_int8_kv_rows_match_reference(case):
    jeng, teng = engines(case, kv_dtype="int8")
    got = teng.score_prompts(pairs(True))
    ref = jeng.score_prompts(pairs(True))
    _, exact = engines(case)
    fp = exact.score_prompts(pairs(True))
    assert_rows_match(got, ref)
    for g, f in zip(got, fp):
        assert abs(g["relative_prob"] - f["relative_prob"]) <= INT8_KV_DREL


@pytest.mark.parametrize("case", ["bloom", "mistral_window"])
def test_engine_chunked_prefill_rows_match_reference(case):
    """``prefill_chunk=32``: the base prompts (one batch, bucket 64) prefill
    in two chunks, the second through ``extend_prefill``, ALiBi and the
    window included."""
    jeng, teng = engines(case, prefill_chunk=32)
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    telemetry.clear_counters()
    assert_rows_match(teng.score_prompts(base_strings()),
                      jeng.score_prompts(base_strings()))
    assert telemetry.counters().get("prefill_chunks", 0) == 2


ROLE_STEPS = (range(0, 1), range(1, 5), range(5, 10), range(0))


@functools.lru_cache(maxsize=None)
def ring_targets(case, steps=10, top_k=5):
    """Per-prompt (yes, no) targets from a greedy pass of the port's
    decoder over the instruct prompts: row i's yes target first enters the
    top ``top_k`` at a step of ``ROLE_STEPS[i % 4]`` (another role when no
    nameable id does), its no target never within the steps."""
    _, _, tcfg, _, weights = models(case)
    ids, mask = _encode(ring_prompts())
    tmask = torch.from_numpy(mask)
    last, cache = tdec.prefill(weights, tcfg, torch.from_numpy(ids), tmask,
                               cache_len=ids.shape[1])
    _, sc, *_ = tdec.decode_steps(weights, tcfg, cache, last, tmask.sum(-1),
                                  0, steps, None, None, with_scores=True)
    top = torch.topk(sc, top_k, dim=-1).indices.numpy()
    names = {tok().ids[" " + w]: w for w in (f"w{i}" for i in range(120))}
    out = []
    for i in range(len(ring_prompts())):
        seen = [set(top[i, :k].ravel()) for k in range(steps + 1)]
        never = [t for t in names if t not in seen[steps]]
        yes = next((t for k in ROLE_STEPS[i % 4] for t in top[i, k]
                    if t in names and t not in seen[k]), never[1])
        out.append((names[yes], names[never[0]]))
    return tuple(out)


def ring_prompts():
    return instruct_strings() + [f"{q} w{i} w{i + 7}"
                                 for i, q in enumerate(QUESTIONS)]


@pytest.mark.parametrize("case", ["bloom", "mistral_window"])
def test_slot_ring_rows_match_reference(case):
    """The binary pool's slot ring (``decode_completions=False``): rows
    resolve at chosen look-ahead steps, so lanes retire and refill; the
    refilled lanes' attention bias (ALiBi, the window) is built from the
    positions the repacked cache stores."""
    jeng, teng = engines(case, decode_completions=False, batch_size=4,
                         phase2_pool_target=2)
    targets = list(ring_targets(case))
    assert_rows_match(teng.score_prompts(ring_prompts(), targets),
                      jeng.score_prompts(ring_prompts(), targets))
    occ = teng.occupancy_report()
    assert occ == jeng.occupancy_report()
    assert occ["refills"] > 0


W8A8_ATOL, W8A8_RTOL = 5e-2, 2e-2      # PERF.md's w8a8 class (activation rounding)


def test_w8a8_gated_projections_match_reference():
    """w8a8 on the gated MLP (``wg``): the port's quantization of its own
    converted tree gives the JAX codes and scales bit for bit, and forward
    logits and binary-pool rows (int8 KV) match the JAX engine's at the
    w8a8 class."""
    from llm_interpretation_replication_tpu.ops import quant as jquant
    from llm_interpretation_replication_tpu_torch.ops import quant as tquant

    family, jcfg, tcfg, params, weights = models("mistral_window")
    jq = jquant.quantize_decoder_params_np(
        jax.tree_util.tree_map(np.asarray, params))
    tq = tquant.quantize_decoder_params(weights.tree())
    for key in ("wg", "wi", "wo"):
        np.testing.assert_array_equal(tq["layers"]["mlp"][key].numpy(),
                                      jq["layers"]["mlp"][key])
        np.testing.assert_array_equal(
            tq["layers"]["mlp"][key + "_qscale"].numpy(),
            jq["layers"]["mlp"][key + "_qscale"])
    tweights = tdec.DecoderWeights(tcfg, tq)
    ids, mask = _encode(base_strings()[:3])
    got = tdec.forward(tweights, tcfg, torch.from_numpy(ids),
                       torch.from_numpy(mask)).numpy()
    jparams = jax.tree_util.tree_map(jnp.asarray, jq)
    ref = np.asarray(jdec.forward(jparams, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], atol=W8A8_ATOL,
                               rtol=W8A8_RTOL)
    kw = dict(decode_completions=False, kv_dtype="int8", batch_size=4)
    jeng = jengine.ScoringEngine(family, jcfg, jparams, tok(),
                                 engine_config=jengine.EngineConfig(**kw))
    teng = tengine.ScoringEngine(family, tcfg, tweights, tok(), device="cpu",
                                 engine_config=tengine.EngineConfig(**kw))
    got_rows = teng.score_prompts(instruct_strings())
    ref_rows = jeng.score_prompts(instruct_strings())
    assert [g["scan_found"] for g in got_rows] == \
        [r["scan_found"] for r in ref_rows]
    for g, r in zip(got_rows, ref_rows):
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=W8A8_RTOL,
                                       atol=1e-9, err_msg=f)


# -- Qwen (first generation), Baichuan(2) and OPT ---------------------------------

BIG_VOCAB = 100_352          # over 100k: Baichuan2's NormHead applies
NEW_CASES = {
    # case: (family, HF config keys past the shared small ones)
    "qwen": ("qwen", dict(model_type="qwen", hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=128, kv_channels=8,
                          layer_norm_epsilon=1e-6, seq_length=256,
                          rotary_emb_base=10000, tie_word_embeddings=False)),
    "baichuan_7b": ("baichuan", dict(
        model_type="baichuan", vocab_size=BIG_VOCAB, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=256, rms_norm_eps=1e-6)),
    "baichuan_13b": ("baichuan", dict(
        model_type="baichuan", vocab_size=BIG_VOCAB, hidden_size=32,
        num_hidden_layers=40, num_attention_heads=4, intermediate_size=64,
        model_max_length=256, rms_norm_eps=1e-6)),
    "opt": ("opt", dict(hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, ffn_dim=64,
                        max_position_embeddings=256, word_embed_proj_dim=32,
                        do_layer_norm_before=True, activation_function="relu")),
}


def _draw(rng, name, shape):
    """A parameter as ``hf_model`` redraws it: norm scales near 1, biases
    and weights non-zero."""
    x = rng.standard_normal(shape).astype(np.float32)
    if "norm" in name or name.split(".")[-2].startswith("ln"):
        return 1.0 + 0.1 * x if name.endswith("weight") else 0.1 * x
    if name.endswith("bias"):
        return 0.1 * x
    return (0.5 if "embed" in name or "wte" in name else 0.15) * x


def _remote_code_state_dict(case, cfg):
    """The HF tensor names Qwen-7B's and Baichuan's modeling files use."""
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    shapes = {}
    for i in range(cfg["num_hidden_layers"]):
        if case == "qwen":
            pre, f2 = f"transformer.h.{i}", f // 2
            shapes.update({f"{pre}.ln_1.weight": (h,), f"{pre}.ln_2.weight": (h,),
                           f"{pre}.attn.c_attn.weight": (3 * h, h),
                           f"{pre}.attn.c_attn.bias": (3 * h,),
                           f"{pre}.attn.c_proj.weight": (h, h),
                           f"{pre}.mlp.w1.weight": (f2, h),
                           f"{pre}.mlp.w2.weight": (f2, h),
                           f"{pre}.mlp.c_proj.weight": (h, f2)})
        else:
            pre = f"model.layers.{i}"
            shapes.update({f"{pre}.input_layernorm.weight": (h,),
                           f"{pre}.post_attention_layernorm.weight": (h,),
                           f"{pre}.self_attn.W_pack.weight": (3 * h, h),
                           f"{pre}.self_attn.o_proj.weight": (h, h),
                           f"{pre}.mlp.gate_proj.weight": (f, h),
                           f"{pre}.mlp.up_proj.weight": (f, h),
                           f"{pre}.mlp.down_proj.weight": (h, f)})
    if case == "qwen":
        shapes.update({"transformer.wte.weight": (v, h),
                       "transformer.ln_f.weight": (h,)})
    else:
        shapes.update({"model.embed_tokens.weight": (v, h),
                       "model.norm.weight": (h,)})
    shapes["lm_head.weight"] = (v, h)
    rng = np.random.default_rng(7)
    return {k: torch.from_numpy(_draw(rng, k, shp)) for k, shp in shapes.items()}


@functools.lru_cache(maxsize=None)
def new_case(case):
    """(HF config, float32 state dict) of a ``NEW_CASES`` case, the " Yes"
    and " No" head rows scaled by 4 as ``hf_model`` scales them (OPT's
    tied embedding rows)."""
    family, kw = NEW_CASES[case]
    kw = dict(kw)
    kw.setdefault("vocab_size", len(tok()))
    if family == "opt":
        import transformers

        model = transformers.OPTForCausalLM(transformers.OPTConfig(**kw)).eval()
        rng = np.random.default_rng(5)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(_draw(rng, name, tuple(p.shape))))
        hf_cfg = model.config
        sd = {k: v.clone() for k, v in model.state_dict().items()
              if v.is_floating_point()}
    else:
        hf_cfg = types.SimpleNamespace(**kw)
        sd = _remote_code_state_dict(case, kw)
    if family == "opt":                 # tied: the head is the embedding
        sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
    for word in ("Yes", "No"):
        sd["lm_head.weight"][tok().ids[" " + word]] *= 4.0
    return hf_cfg, sd


@functools.lru_cache(maxsize=None)
def opt_model():
    import transformers

    hf_cfg, sd = new_case("opt")
    model = transformers.OPTForCausalLM(hf_cfg).eval()
    model.load_state_dict(sd, strict=False)
    return model


@pytest.mark.parametrize("case", list(NEW_CASES))
def test_new_family_trees_match_reference(case):
    """The converted trees equal the JAX converter's, leaf for leaf
    (NormHead's normalized columns included)."""
    _, jcfg, tcfg, params, weights = models(case)
    ref = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {path: t.numpy() for path, t in tdec._flatten(weights.tree())}
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    if case.startswith("baichuan"):
        assert tcfg.norm_head
        np.testing.assert_allclose(
            np.linalg.norm(got[("lm_head",)], axis=0), 1.0, rtol=1e-5)
        assert tcfg.position_embedding == (
            "alibi" if case == "baichuan_13b" else "rotary")


@pytest.mark.parametrize("case", list(NEW_CASES))
def test_new_family_logits_match_reference(case):
    """float32 logits of a right-padded batch within 2e-5 of JAX's (OPT's
    positions with the stored offset among them), and OPT's within 2e-3
    of ``transformers``' OPT."""
    _, jcfg, tcfg, params, weights = models(case)
    ids, mask = _encode(base_strings()[:3] + instruct_strings()[:2])
    got = tdec.forward(weights, tcfg, torch.from_numpy(ids),
                       torch.from_numpy(mask)).numpy()
    ref = np.asarray(jdec.forward(params, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], atol=ATOL, rtol=1e-5)
    if case == "opt":
        with torch.no_grad():
            hf = opt_model()(input_ids=torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask)).logits
        np.testing.assert_allclose(got[real], hf.numpy()[real], atol=HF_ATOL,
                                   rtol=1e-3)


@pytest.mark.parametrize("case,impl", [("qwen", "xla"), ("baichuan_7b", "xla"),
                                       ("opt", "xla"), ("opt", "flash")])
def test_new_family_engine_rows_match_reference(case, impl):
    """``EngineConfig()`` rows, base prompts as strings and as (prefix,
    suffix) pairs; OPT also with the causal kernel's plain version (head
    dim 8, one K/V head a query head)."""
    jeng, teng = engines(case, impl)
    for prompts in (base_strings(), pairs(True)):
        assert_rows_match(teng.score_prompts(prompts),
                          jeng.score_prompts(prompts))


def test_norm_head_survives_w8a8_and_the_cast():
    """Baichuan2's normalized head stays unquantized under w8a8 (as the
    reference keeps it) and the cast leaves it one rounding of the float32
    normalization; a bf16 checkpoint's head is normalized in float32 and
    rounded to bf16 once."""
    from llm_interpretation_replication_tpu_torch.ops import quant as tquant

    _, _, tcfg, _, weights = models("baichuan_7b")
    head = weights.tree()["lm_head"]
    q = tquant.quantize_decoder_params(weights.tree())
    assert q["lm_head"] is head and "lm_head_qscale" not in q
    assert "wq_qscale" in q["layers"]["attn"]
    cast = loader._cast(q, torch.bfloat16)
    torch.testing.assert_close(cast["lm_head"], head.to(torch.bfloat16),
                               rtol=0, atol=0)
    # a bf16 checkpoint: normalized in float32, then rounded to bf16 once
    hf_cfg, sd = new_case("baichuan_7b")
    bf = convert.convert_baichuan(
        lambda n: sd[n].to(torch.bfloat16), tcfg)["lm_head"]
    h32 = sd["lm_head.weight"].to(torch.bfloat16).float().numpy().T
    want = h32 / np.maximum(np.linalg.norm(h32, axis=0, keepdims=True), 1e-12)
    assert bf.dtype == torch.bfloat16
    # within half a bf16 step of the float32 normalization
    torch.testing.assert_close(bf.float(), torch.from_numpy(want),
                               rtol=2 ** -8, atol=0)
