"""The port's T5 encoder-decoder (``models/t5``, ``convert_t5``, the T5
config) and its engine route against the JAX package and ``transformers``.

Classes: relative-position buckets identical at every distance up to 512 in
both directions; float32 ``forward`` logits within atol 2e-5 of JAX's
(gated-GELU and ReLU, tied and untied, a right-padded batch with a fully
padded row); ``greedy_decode`` tokens identical and scores within 2e-5,
with an EOS stop and ``score_steps < num_steps``; logits and generated
tokens within 2e-3 of ``transformers``' ``T5ForConditionalGeneration``
(``tests/test_t5_parity.py``'s class).  Engine rows (``_score_encdec``)
against the JAX engine's on the same weights and tokenizer: verdicts,
completions and tokens identical, probabilities within rtol 2e-5.  The
tokenizer is ``chip_smoke``'s T5-style Unigram ``tokenizer.json`` read by
``utils.tokenizer`` (``</s>`` appended, ``"Yes"`` -> ``▁Yes``), shared by
both engines.
"""

import dataclasses
import functools
import json
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.models import convert as jconvert
from llm_interpretation_replication_tpu.models import t5 as jt5
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu.runtime import loader as jloader
from llm_interpretation_replication_tpu_torch.config import ordinary_meaning_questions
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.models import t5 as tt5
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import loader
from llm_interpretation_replication_tpu_torch.scoring import prompts as tprompts
from llm_interpretation_replication_tpu_torch.utils import tokenizer as ttok
import chip_smoke
from test_torch_slots import one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-5, 2e-5
HF_ATOL = 2e-3
QUESTIONS = ordinary_meaning_questions()[:6]
PROB_FIELDS = ("yes_prob", "no_prob", "relative_prob", "odds_ratio",
               "first_token_yes_prob", "first_token_no_prob",
               "first_token_relative_prob")
VARIANTS = {"gated_untied": (True, False), "gated_tied": (True, True),
            "relu_untied": (False, False), "relu_tied": (False, True)}


@functools.lru_cache(maxsize=None)
def tok():
    """The port's reader of a T5-style Unigram tokenizer over the
    questions' words and both prompt formats."""
    texts = QUESTIONS + [tprompts.FEW_SHOT_PREFIX, tprompts.ANSWER_INSTRUCTION,
                         "Yes", "No"] + [f"w{i}" for i in range(40)]
    spec, config, special = chip_smoke._unigram_tokenizer_files(texts)
    path = tempfile.mkdtemp(prefix="t5tok_")
    for name, obj in (("tokenizer.json", spec), ("tokenizer_config.json", config),
                      ("special_tokens_map.json", special)):
        with open(f"{path}/{name}", "w", encoding="utf-8") as f:
            json.dump(obj, f)
    return ttok.load_tokenizer(path)


@functools.lru_cache(maxsize=None)
def hf_model(variant, layers=2):
    """A ``transformers`` T5 whose parameters are redrawn from a numpy seed,
    the embedding and head at 0.1, so that logits stay within a few units
    (the probability class, rtol 2e-5, doubles the logits' float32 noise
    of ~3e-6 relative); the ``▁Yes`` and EOS rows of the output projection
    scaled up so that some rows find the target and some stop early."""
    from transformers import T5Config, T5ForConditionalGeneration

    gated, tied = VARIANTS[variant]
    cfg = T5Config(
        vocab_size=len(tok()) + 5, d_model=32, d_kv=8, d_ff=64,
        num_layers=layers, num_decoder_layers=layers, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=32,
        feed_forward_proj="gated-gelu" if gated else "relu",
        tie_word_embeddings=tied, decoder_start_token_id=0, eos_token_id=1,
        pad_token_id=0)
    model = T5ForConditionalGeneration(cfg).eval()
    rng = np.random.default_rng(11 + 2 * gated + tied)
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = rng.standard_normal(p.shape).astype(np.float32)
            if "layer_norm" in name:
                x = 1.0 + 0.1 * x
            elif name in ("shared.weight", "lm_head.weight"):
                x = 0.1 * x
            else:
                x = 0.2 * x
            p.copy_(torch.from_numpy(x))
        head = model.get_output_embeddings().weight
        yes = tok()("Yes").input_ids[0]
        head[yes] *= 3.0
        head[1] *= 4.0
    return model


def state_dict(variant):
    return {k: v for k, v in hf_model(variant).state_dict().items()
            if v.is_floating_point()}


@functools.lru_cache(maxsize=None)
def models(variant):
    """(jax cfg, port cfg, jax params, port weights) from one state dict."""
    sd = state_dict(variant)
    hf_cfg = hf_model(variant).config
    family, jcfg = jconfig.from_hf_config(hf_cfg)
    tfamily, tcfg = tconfig.from_hf_config(hf_cfg)
    assert family == tfamily == "t5"
    params = jax.tree_util.tree_map(jnp.asarray, jconvert.convert(
        "t5", jconvert.getter_from_torch_state_dict(sd), jcfg,
        dtype=jnp.float32))
    weights = tt5.T5Weights(tcfg, convert.CONVERTERS["t5"](sd.__getitem__, tcfg))
    return jcfg, tcfg, params, weights


def padded_batch():
    """Right-padded encoder ids (a fully padded row among them) and
    decoder ids from the start token."""
    rng = np.random.default_rng(3)
    v = len(tok())
    enc = rng.integers(3, v, size=(4, 11)).astype(np.int64)
    mask = np.ones_like(enc)
    mask[1, 7:] = 0
    mask[2, 1:] = 0
    mask[3, :] = 0
    enc[mask == 0] = 0
    dec = np.concatenate([np.zeros((4, 1), np.int64),
                          rng.integers(3, v, size=(4, 5))], axis=1)
    return enc, mask, dec


# -- configs, trees ----------------------------------------------------------------

T0_3B = {   # bigscience/T0_3B config.json (tk-instruct-3b-def: the same)
    "model_type": "t5", "vocab_size": 32128, "d_model": 2048, "d_kv": 64,
    "d_ff": 5120, "num_layers": 24, "num_decoder_layers": 24, "num_heads": 32,
    "relative_attention_num_buckets": 32, "layer_norm_epsilon": 1e-6,
    "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False,
    "decoder_start_token_id": 0, "eos_token_id": 1, "pad_token_id": 0}
T5_BASE = {   # google/t5-base: ReLU, tied
    "model_type": "t5", "vocab_size": 32128, "d_model": 768, "d_kv": 64,
    "d_ff": 3072, "num_layers": 12, "num_heads": 12,
    "relative_attention_num_buckets": 32, "layer_norm_epsilon": 1e-6,
    "feed_forward_proj": "relu", "decoder_start_token_id": 0}


@pytest.mark.parametrize("raw", [T0_3B, T5_BASE], ids=["t0_3b", "t5_base"])
def test_t5_config_matches_reference(tmp_path, raw):
    (tmp_path / "config.json").write_text(json.dumps(raw))
    family, got = tconfig.from_hf_config(loader.load_hf_config(str(tmp_path)))
    jfamily, ref = jconfig.from_hf_config(jloader.load_hf_config(str(tmp_path)))
    assert family == jfamily == "t5"
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.flash_refusal().startswith("T5")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_converted_t5_tree_matches_reference(variant):
    jcfg, tcfg, params, weights = models(variant)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    ref = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {path: t.numpy() for path, t in tdec._flatten(weights.tree())}
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    # the JAX tree carried across by params_from_jax is the same weights
    back = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                   tcfg, device="cpu", dtype="fp32")
    assert isinstance(back, tt5.T5Weights)
    for path, t in tdec._flatten(back.tree()):
        np.testing.assert_array_equal(t.numpy(), got[path])


# -- the model against JAX and transformers --------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 32), (16, 64)])
def test_relative_position_buckets_match_reference(bidirectional, buckets,
                                                   distance):
    rel = np.arange(-512, 513)
    ref = np.asarray(jt5._relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bidirectional, buckets, distance))
    got = tt5._relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                        buckets, distance)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_reference_and_hf(variant):
    jcfg, tcfg, params, weights = models(variant)
    enc, mask, dec = padded_batch()
    got = tt5.forward(weights, tcfg, torch.from_numpy(enc),
                      torch.from_numpy(mask), torch.from_numpy(dec)).numpy()
    assert np.isfinite(got).all()           # the fully padded row too
    ref = np.asarray(jt5.forward(params, jcfg, jnp.asarray(enc, jnp.int32),
                                 jnp.asarray(mask, jnp.int32),
                                 jnp.asarray(dec, jnp.int32)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-5)
    with torch.no_grad():
        hf = hf_model(variant)(input_ids=torch.from_numpy(enc[:3]),
                               attention_mask=torch.from_numpy(mask[:3]),
                               decoder_input_ids=torch.from_numpy(dec[:3])).logits
    np.testing.assert_allclose(got[:3], hf.numpy(), atol=HF_ATOL, rtol=1e-3)


@pytest.mark.parametrize("variant", ["gated_untied", "gated_tied"])
def test_greedy_decode_matches_reference(variant):
    """An EOS stop (rows keep emitting EOS after it) and scores only for
    the first ``score_steps`` of ``num_steps``."""
    jcfg, tcfg, params, weights = models(variant)
    enc, mask, _ = padded_batch()
    tokens, scores = tt5.greedy_decode(
        weights, tcfg, torch.from_numpy(enc), torch.from_numpy(mask),
        num_steps=9, eos_token_id=1, score_steps=4)
    jtokens, jscores = jt5.greedy_decode(
        params, jcfg, jnp.asarray(enc, jnp.int32), jnp.asarray(mask, jnp.int32),
        num_steps=9, eos_token_id=1, score_steps=4)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    assert scores.shape == (4, 4, jcfg.vocab_size)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=ATOL,
                               rtol=1e-5)
    t = tokens.numpy()
    stopped = [r for r in range(4) if (t[r] == 1).any()]
    assert stopped, "no row emitted EOS"
    for r in stopped:
        first = int(np.argmax(t[r] == 1))
        assert (t[r, first:] == 1).all()


def test_greedy_decode_matches_hf_generate():
    """Tokens and scores up to each row's EOS (``generate`` pads after
    it)."""
    jcfg, tcfg, params, weights = models("gated_untied")
    enc, mask, _ = padded_batch()
    with torch.no_grad():
        out = hf_model("gated_untied").generate(
            torch.from_numpy(enc[:3]), attention_mask=torch.from_numpy(mask[:3]),
            max_new_tokens=6, do_sample=False, output_scores=True,
            return_dict_in_generate=True)
    tokens, scores = tt5.greedy_decode(weights, tcfg, torch.from_numpy(enc[:3]),
                                       torch.from_numpy(mask[:3]), num_steps=6,
                                       eos_token_id=1)
    hf_tokens = out.sequences[:, 1:].numpy()
    hf_scores = torch.stack(out.scores, dim=1).numpy()
    for r, row in enumerate(tokens.numpy()):
        n = int(np.argmax(row == 1)) + 1 if (row == 1).any() else len(row)
        np.testing.assert_array_equal(row[:n], hf_tokens[r, :n])
        np.testing.assert_allclose(scores.numpy()[r, :n], hf_scores[r, :n],
                                   atol=HF_ATOL, rtol=1e-3)


def test_random_t5_params_stay_finite_in_bf16_at_depth():
    """T5's own initialization scales keep a 24-layer bf16 forward finite
    (no attention scale: unit-normal projections would overflow)."""
    cfg = tconfig.T5Config(vocab_size=256, d_model=64, num_layers=24,
                           num_decoder_layers=24, num_heads=4, d_kv=16,
                           d_ff=128)
    w = convert.random_params(cfg, seed=0, device="cpu", dtype="bf16")
    assert isinstance(w, tt5.T5Weights)
    assert w.tree()["shared"].dtype == torch.bfloat16
    enc = torch.randint(3, 256, (2, 12), generator=torch.Generator().manual_seed(0))
    logits = tt5.forward(w, cfg, enc, torch.ones_like(enc),
                         torch.zeros((2, 3), dtype=torch.int64))
    assert torch.isfinite(logits).all() and logits.abs().max() < 1e3
    sd = convert.random_t5_state_dict(cfg, seed=0, device="cpu", dtype="fp32")
    assert abs(float(sd["encoder.block.0.layer.0.SelfAttention.q.weight"].std())
               - (64 * 16) ** -0.5) < 0.005


# -- engine rows against the JAX engine -----------------------------------------

def engines(variant="gated_untied", **ecfg):
    jcfg, tcfg, params, weights = models(variant)
    jeng = jengine.ScoringEngine("t5", jcfg, params, tok(),
                                 engine_config=jengine.EngineConfig(**ecfg))
    teng = tengine.ScoringEngine("t5", tcfg, weights, tok(), device="cpu",
                                 engine_config=tengine.EngineConfig(**ecfg))
    return jeng, teng


def assert_rows_match(got, ref, rtol=RTOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"]
        for f in PROB_FIELDS + (("weighted_confidence",)
                                if "weighted_confidence" in r else ()):
            if r[f] is None:                 # no digit candidate
                assert g[f] is None, f
                continue
            np.testing.assert_allclose(g[f], r[f], rtol=rtol, atol=1e-9,
                                       err_msg=f)


def prompts():
    return ([tprompts.format_prompt(q, False) for q in QUESTIONS]
            + [tprompts.format_prompt(q, True) for q in QUESTIONS[:3]])


@pytest.mark.parametrize("variant,kw", [
    ("gated_untied", {}), ("relu_tied", {}),
    ("gated_untied", dict(decode_completions=False, batch_size=4)),
    ("gated_tied", dict(max_new_tokens=12, batch_size=4)),
])
def test_engine_rows_match_reference(variant, kw):
    """The binary leg (``EngineConfig()``: 50-token completions, the scan
    over the first 10 steps, stopped at a row's EOS)."""
    jeng, teng = engines(variant, **kw)
    got, ref = teng.score_prompts(prompts()), jeng.score_prompts(prompts())
    assert_rows_match(got, ref)
    assert any(r["scan_found"] for r in ref)
    if kw.get("decode_completions", True):
        assert any(r["completion"] for r in ref)


def test_engine_confidence_and_max_new_tokens_match_reference():
    jeng, teng = engines(batch_size=4)
    for kw in (dict(with_confidence=True),
               dict(with_confidence=True, max_new_tokens=10),
               dict(max_new_tokens=3)):
        assert_rows_match(teng.score_prompts(prompts(), **kw),
                          jeng.score_prompts(prompts(), **kw))


def test_engine_score_prefixed_matches_reference():
    """Two legs over (prefix, suffixes) pairs: each leg scores the joined
    token streams; ``(prefix, suffix)`` prompts take the same route."""
    jeng, teng = engines(batch_size=4)
    pairs = [tuple(tprompts.format_prompt_parts(q, True)) for q in QUESTIONS]
    legs = [tengine.LegSpec("binary"),
            tengine.LegSpec("confidence", with_confidence=True,
                            max_new_tokens=10)]
    jlegs = [jengine.LegSpec("binary"),
             jengine.LegSpec("confidence", with_confidence=True,
                             max_new_tokens=10)]
    both = [(p, (s, s)) for p, s in pairs]
    for g, r in zip(teng.score_prefixed(both, legs=legs),
                    jeng.score_prefixed(both, legs=jlegs)):
        assert_rows_match(g, r)
    assert_rows_match(teng.score_prompts(pairs), jeng.score_prompts(pairs))


def test_engine_first_token_relative_prob_matches_reference():
    jeng, teng = engines(batch_size=4)
    for top in (0, 20):
        np.testing.assert_allclose(
            teng.first_token_relative_prob(prompts(), top_filter=top),
            jeng.first_token_relative_prob(prompts(), top_filter=top),
            rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("call", ["slotted", "export", "decode_slabs"])
def test_decoder_only_entries_refuse_t5(call):
    """As in the reference: a ``ValueError`` naming the decoder-only
    route."""
    jeng, teng = engines()
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="decoder-only"):
            if call == "slotted":
                eng.score_prompts_slotted(prompts()[:2])
            elif call == "export":
                eng.export_kv_slab(prompts()[:2])
            else:
                eng.decode_kv_slabs([])
    assert teng.is_encoder_decoder and teng.target_ids(["Yes"]) == \
        [tok()("Yes").input_ids[0]]


def test_load_model_reads_a_t5_snapshot(tmp_path):
    """A saved HF T5 through the port's loader: the converted weights; the
    attention impl ignored, and ``quant='int8'`` warns and loads float
    weights, as the reference loader does."""
    hf_model("gated_untied").save_pretrained(str(tmp_path), safe_serialization=True)
    family, cfg, weights = loader.load_model(str(tmp_path), dtype="fp32",
                                             device="cpu",
                                             attention_impl="flash")
    assert family == "t5" and isinstance(weights, tt5.T5Weights)
    ref = models("gated_untied")[3]
    for (pa, a), (pb, b) in zip(tdec._flatten(weights.tree()),
                                tdec._flatten(ref.tree())):
        assert pa == pb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.warns(UserWarning, match="int8 quantization unsupported"):
        _, _, w8 = loader.load_model(str(tmp_path), dtype="fp32", quant="int8",
                                     device="cpu")
    assert all(t.dtype == torch.float32 for _, t in tdec._flatten(w8.tree()))


@pytest.mark.parametrize("variant", ["gated_untied", "relu_tied"])
def test_random_t5_state_dict_has_the_hf_names(variant):
    """``convert.random_t5_state_dict`` writes the names and shapes of
    ``T5ForConditionalGeneration``'s checkpoint (its embedding aliases
    aside), and ``convert_t5`` reads every tensor of it."""
    model = hf_model(variant)
    _, tcfg = tconfig.from_hf_config(model.config)
    sd = convert.random_t5_state_dict(tcfg, seed=0, device="cpu", dtype="fp32")
    ref = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("embed_tokens.weight")
           and not (k == "lm_head.weight" and tcfg.tie_word_embeddings)}
    assert {k: tuple(v.shape) for k, v in sd.items()} == ref
    read = set()
    convert.convert_t5(lambda n: read.add(n) or sd[n], tcfg)
    assert read == set(sd)
