"""The port's budget model (``runtime/plan.py``) against the JAX package's.

With the reference's coefficients set into the port's module (and the
port's departing rules, the suffix-extension transient and the chunk
replays on the kernel route, the K-head's distillation and the load on
the card, set back to the reference's), every byte
function, both ``resolve_*`` functions and their reason strings equal the
JAX ones exactly, over the geometries of the model types the port loads
(Falcon's MQA, Mistral's and Qwen2's GQA, GPT-J's head dim 256, MPT,
GLM-4), both quants, both KV dtypes and a grid of batches, sequences and
chunks drawn from a seeded numpy generator.  The departures are held to
the peaks ``scripts/calibrate_plan_torch.py`` measured on the card.
"""

import dataclasses

import numpy as np
import pytest

from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.runtime import plan as jplan
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.runtime import plan
from test_torch_slots import one_torch_thread  # noqa: F401

#: published geometries of the model types the port loads
GEOMETRIES = {
    "falcon-7b": tconfig.FALCON_7B_GEOMETRY,
    "mistral-7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                       num_heads=32, num_kv_heads=8, intermediate_size=14336),
    "qwen2-7b": dict(vocab_size=152064, hidden_size=3584, num_layers=28,
                     num_heads=28, num_kv_heads=4, intermediate_size=18944),
    "gpt-j-6b": dict(vocab_size=50400, hidden_size=4096, num_layers=28,
                     num_heads=16, head_dim=256, intermediate_size=16384),
    "mpt-7b": dict(vocab_size=50432, hidden_size=4096, num_layers=32,
                   num_heads=32, intermediate_size=16384,
                   tie_word_embeddings=True),
    "glm-4-9b": dict(vocab_size=151552, hidden_size=4096, num_layers=40,
                     num_heads=32, num_kv_heads=2, head_dim=128,
                     intermediate_size=13696),
}

#: the reference's coefficients, in the port's names
REFERENCE_COEFFICIENTS = dict(
    RESERVE_BYTES=jplan.RESERVE_BYTES,
    THRASH_HEADROOM_BYTES=jplan.THRASH_HEADROOM_BYTES,
    SCORE_BYTES_PER_ELEMENT=2, EXTEND_SCORE_BYTES_PER_ELEMENT=2,
    FLASH_BYTES_PER_ELEMENT=4, ACT_HIDDEN_BYTES=1, ACT_MLP_BYTES=2,
    ACT_MLP_BYTES_INT8=2, INT8_EMBEDDING_BYTES=1.01)


def reference_prefill_attention_bytes(cfg, attention_impl, batch, seq,
                                      prefill_chunk=0):
    """The reference's rule: the kernel's workspace alone on its route."""
    if attention_impl == "flash":
        return plan.flash_workspace_bytes(cfg, batch, seq)
    return plan.dense_attention_bytes(cfg, batch, seq, prefill_chunk)


def set_reference_plan(monkeypatch):
    """The reference's coefficients and rules into the port's plan.py."""
    for name, value in REFERENCE_COEFFICIENTS.items():
        monkeypatch.setattr(plan, name, value)
    monkeypatch.setattr(plan, "suffix_extend_bytes", lambda *a, **k: 0)
    monkeypatch.setattr(plan, "k_distill_bytes", lambda *a, **k: 0)
    monkeypatch.setattr(plan, "load_bytes", lambda *a, **k: 0)
    monkeypatch.setattr(plan, "prefill_attention_bytes",
                        reference_prefill_attention_bytes)


@pytest.fixture
def reference_plan(monkeypatch):
    set_reference_plan(monkeypatch)


def configs(name):
    return (tconfig.DecoderConfig(**GEOMETRIES[name]),
            jconfig.DecoderConfig(**GEOMETRIES[name]))


def grid(seed, n=12):
    """(batch, seq, chunk) points from a seeded generator."""
    rng = np.random.default_rng(seed)
    return [(int(rng.choice([1, 8, 32, 96, 224, 512])),
             int(rng.choice([64, 128, 256, 448, 1024])),
             int(rng.choice([0, 64, 128, 256]))) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_byte_functions_equal_reference(reference_plan, name):
    t, j = configs(name)
    assert plan.param_count(t) == jplan.param_count(j)
    for quant in ("none", "int8"):
        assert plan.weight_bytes(t, quant) == jplan.weight_bytes(j, quant)
    for k in (1, 2, 4, 8):
        assert plan.k_head_bytes(t, k) == jplan.k_head_bytes(j, k)
    for b, s, c in grid(len(name)):
        assert (plan.dense_attention_bytes(t, b, s, c)
                == jplan.dense_attention_bytes(j, b, s, c))
        for quant in ("none", "int8"):
            assert (plan.activation_bytes(t, b, s, c, quant)
                    == jplan.activation_bytes(j, b, s, c))
        assert (plan.flash_workspace_bytes(t, b, s)
                == jplan.flash_workspace_bytes(j, b, s))
        for kv in ("bf16", "int8"):
            assert (plan.kv_cache_bytes(t, b, s, kv)
                    == jplan.kv_cache_bytes(j, b, s, kv))
            assert (plan.pooled_confidence_extra_bytes(t, b, s, kv_dtype=kv)
                    == jplan.pooled_confidence_extra_bytes(j, b, s,
                                                           kv_dtype=kv))
            assert (plan.slot_refill_pool_bytes(t, 2 * b, b, s, kv_dtype=kv)
                    == jplan.slot_refill_pool_bytes(j, 2 * b, b, s,
                                                    kv_dtype=kv))
            for reduced in (True, False):
                assert (plan.completions_extra_bytes(
                    t, b, s, 50, 10, 2, reduced, kv)
                    == jplan.completions_extra_bytes(
                        j, b, s, 50, 10, 2, reduced, kv))
        assert (plan.prefix_cache_extra_bytes(t, b, s)
                == jplan.prefix_cache_extra_bytes(j, b, s))
        for impl in ("xla", "flash"):
            for kv in ("bf16", "int8"):
                for pooled, repack, dk in ((False, False, 1),
                                           (True, False, 1),
                                           (True, True, 4)):
                    got = plan.full_study_need_terms(
                        t, 7 << 30, impl, b, s, kv_dtype=kv,
                        prefill_chunk=c, pooled_confidence=pooled,
                        slot_repack=repack, decode_k=dk)
                    ref = jplan.full_study_need_terms(
                        j, 7 << 30, impl, b, s, kv_dtype=kv,
                        prefill_chunk=c, pooled_confidence=pooled,
                        slot_repack=repack, decode_k=dk)
                    assert got == ref
            for q in (1, 4):
                assert (plan.packed_need_terms(t, 7 << 30, impl, b, s, q)
                        == jplan.packed_need_terms(j, 7 << 30, impl, b, s,
                                                   q))


def test_budget_strings_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        need, budget = (int(x) for x in rng.integers(1, 90 << 30, 2))
        assert plan.budget_audit(need, budget) == jplan.budget_audit(
            need, budget)
        assert plan.budget_reject(need, budget) == jplan.budget_reject(
            need, budget)
        rows = int(rng.integers(1, 512))
        assert plan.pooled_conf_tag(need, rows) == jplan.pooled_conf_tag(
            need, rows)
        for chunk in (0, 128):
            args = (rows, "int8", chunk, " tag", need, budget, "base")
            assert (plan.full_study_fit_reason(*args)
                    == jplan.full_study_fit_reason(*args))
            args = (512, rows, need, "bf16", 2, chunk, "", budget)
            assert (plan.full_study_clamp_reason(*args)
                    == jplan.full_study_clamp_reason(*args))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_resolve_plans_equal_reference(reference_plan, name):
    t, j = configs(name)
    for hbm in (16 << 30, 80 << 30):
        for b, s, c in grid(10 + len(name), 6):
            for quant in ("none", "int8"):
                for impl in (None, "flash"):
                    got = plan.resolve_scoring_plan(t, quant, b, s, hbm,
                                                    impl, c)
                    ref = jplan.resolve_scoring_plan(j, quant, b, s, hbm,
                                                     impl, c)
                    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
                    for kv in ("bf16", "int8"):
                        for pooled, repack, top_k in ((False, False, None),
                                                      (True, True, 5),
                                                      (True, False, 40)):
                            kw = dict(hbm_bytes=hbm, requested_impl=impl,
                                      top_k=top_k, kv_dtype=kv,
                                      prefill_chunk=c,
                                      pooled_confidence=pooled,
                                      slot_repack=repack)
                            got = plan.resolve_full_sweep_plan(t, quant, b,
                                                               s, **kw)
                            ref = jplan.resolve_full_sweep_plan(j, quant, b,
                                                                s, **kw)
                            assert (dataclasses.asdict(got)
                                    == dataclasses.asdict(ref))


def test_budget_needs_the_card_or_an_explicit_memory(monkeypatch):
    """Without a card and without an explicit memory the model raises; it
    never falls back to a built-in size."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY)
    with pytest.raises(RuntimeError, match="memory"):
        plan.resolve_scoring_plan(cfg, "int8", 32, 256)
    with pytest.raises(RuntimeError, match="memory"):
        plan.resolve_full_sweep_plan(cfg, "int8", 32, 256)
    assert plan.resolve_scoring_plan(cfg, "int8", 32, 256,
                                     hbm_bytes=80 << 30).batch == 32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {"total_memory": 85 << 30}))
    assert plan.device_memory_bytes() == 85 << 30


# -- the departures, held to the card ------------------------------------------
# Measured by scripts/calibrate_plan_torch.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W (Falcon-7B, random weights; PERF.md section 6).

#: (quant, batch, seq, MLP, dense attention, kernel attention, extension
#: chunk, extension attention): one layer's sub-blocks' peak bytes above
#: their inputs
BLOCK_PEAKS = [
    ('none', 8, 128, 74448896, 102629376, 28180480, 128, 337989632),
    ('none', 16, 256, 297795584, 782761984, 112721920, 128, 902897664),
    ('none', 32, 256, 595591168, 1565523968, 225443840, 128, 1803517952),
    ('int8', 8, 128, 260579328, 102629376, 79368192, 128, 337989632),
    ('int8', 16, 256, 1042317312, 782761984, 317472768, 128, 902094848),
    ('int8', 32, 256, 2084634624, 1565523968, 634945536, 128, 1803517952),
]
#: the w8a8 weights' bytes on the card
INT8_WEIGHT_BYTES = 7221577728
#: (workload, route, quant, KV dtype, chunk, batch, longest prompt tokens,
#: peak bytes): whole engine calls, each peak the call's increment over what
#: was resident plus its quant's weights (pipeline depth 2)
ENGINE_PEAKS = [
    ('binary', 'xla', 'none', 'bf16', 0, 64, 256, 17501460480),
    ('binary', 'xla', 'none', 'bf16', 0, 256, 256, 28461283328),
    ('binary', 'xla', 'none', 'bf16', 0, 512, 256, 43075386368),
    ('binary', 'flash', 'none', 'bf16', 0, 64, 256, 15846808064),
    ('binary', 'flash', 'none', 'bf16', 0, 256, 256, 21842672640),
    ('binary', 'flash', 'none', 'bf16', 0, 512, 256, 29839213568),
    ('binary', 'xla', 'int8', 'bf16', 0, 64, 256, 12216842240),
    ('binary', 'xla', 'int8', 'bf16', 0, 256, 256, 27197184000),
    ('binary', 'xla', 'int8', 'bf16', 0, 512, 256, 47172131840),
    ('binary', 'flash', 'int8', 'bf16', 0, 64, 256, 12200065536),
    ('binary', 'flash', 'int8', 'bf16', 0, 256, 256, 27130600448),
    ('binary', 'flash', 'int8', 'bf16', 0, 512, 256, 47038964736),
    ('binary', 'flash', 'int8', 'int8', 0, 64, 256, 12110772736),
    ('binary', 'flash', 'int8', 'int8', 0, 256, 256, 26777754624),
    ('binary', 'flash', 'int8', 'int8', 0, 512, 256, 46332552192),
    ('full', 'xla', 'none', 'bf16', 0, 64, 256, 17757713920),
    ('full', 'xla', 'none', 'bf16', 0, 256, 256, 29484596224),
    ('full', 'xla', 'none', 'bf16', 0, 512, 256, 45124273152),
    ('full', 'flash', 'none', 'bf16', 0, 64, 256, 16102995968),
    ('full', 'flash', 'none', 'bf16', 0, 256, 256, 22867034112),
    ('full', 'flash', 'none', 'bf16', 0, 512, 256, 31886527488),
    ('full', 'xla', 'int8', 'bf16', 0, 64, 256, 12472817152),
    ('full', 'xla', 'int8', 'bf16', 0, 256, 256, 28220496896),
    ('full', 'xla', 'int8', 'bf16', 0, 512, 256, 49220494336),
    ('full', 'flash', 'int8', 'bf16', 0, 64, 256, 12456384512),
    ('full', 'flash', 'int8', 'bf16', 0, 256, 256, 28154437632),
    ('full', 'flash', 'int8', 'bf16', 0, 512, 256, 49086278656),
    ('full', 'flash', 'int8', 'int8', 0, 64, 256, 12258859008),
    ('full', 'flash', 'int8', 'int8', 0, 256, 256, 27368333312),
    ('full', 'flash', 'int8', 'int8', 0, 512, 256, 47515511808),
    ('full', 'flash', 'int8', 'bf16', 128, 64, 256, 10640987648),
    ('full', 'flash', 'int8', 'bf16', 128, 256, 256, 20900323840),
    ('full', 'flash', 'int8', 'bf16', 128, 512, 256, 34577920512),
    ('full', 'xla', 'none', 'int8', 128, 64, 256, 17068602880),
    ('full', 'xla', 'none', 'int8', 128, 256, 256, 26738590208),
    ('full', 'xla', 'none', 'int8', 128, 512, 256, 39626658304),
    ('packed', 'xla', 'none', 'bf16', 0, 16, 424, 16232580608),
    ('packed', 'xla', 'none', 'bf16', 0, 64, 464, 27029913600),
    ('packed', 'xla', 'none', 'bf16', 0, 128, 464, 40213305344),
    ('packed', 'flash', 'none', 'bf16', 0, 16, 424, 14664165376),
    ('packed', 'flash', 'none', 'bf16', 0, 64, 464, 17722753536),
    ('packed', 'flash', 'none', 'bf16', 0, 128, 464, 21598984704),
    ('packed', 'xla', 'int8', 'bf16', 0, 16, 424, 9607636480),
    ('packed', 'xla', 'int8', 'bf16', 0, 64, 464, 20404969472),
    ('packed', 'xla', 'int8', 'bf16', 0, 128, 464, 33588361216),
    ('packed', 'flash', 'int8', 'bf16', 0, 16, 424, 9296388096),
    ('packed', 'flash', 'int8', 'bf16', 0, 64, 464, 17053983232),
    ('packed', 'flash', 'int8', 'bf16', 0, 128, 464, 26886388224),
]


@pytest.mark.parametrize("quant,b,s,mlp,dense,kernel,chunk,extend",
                         BLOCK_PEAKS)
def test_departing_terms_cover_the_cards_sub_blocks(quant, b, s, mlp, dense,
                                                    kernel, chunk, extend):
    """The eager terms (the MLP's bytes by quant, the dense score tensor,
    the kernel route, the float64 extension attention) are at least each
    sub-block's measured peak, and within 3.1x of it (the kernel route
    takes the w8a8 projections' bytes at both quants: 2.8x the bf16
    sub-block)."""
    cfg = tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY)
    for got, peak in (
            (plan.activation_bytes(cfg, b, s, quant=quant), mlp),
            (plan.dense_attention_bytes(cfg, b, s), dense),
            (plan.flash_workspace_bytes(cfg, b, s), kernel),
            (plan.suffix_extend_bytes(cfg, b, s, chunk), extend)):
        assert peak <= got <= 3.1 * peak


def test_int8_weights_cover_the_cards():
    cfg = tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY)
    assert INT8_WEIGHT_BYTES <= plan.weight_bytes(cfg, "int8") \
        <= 1.01 * INT8_WEIGHT_BYTES


@pytest.mark.parametrize("workload,impl,quant,kv,chunk,b,tokens,peak",
                         ENGINE_PEAKS)
def test_budget_model_covers_the_cards_engine_peaks(workload, impl, quant,
                                                    kv, chunk, b, tokens,
                                                    peak):
    """At every operating point of the calibration ladder the budget
    model's need is at least the card's peak, and within 1.8x of it."""
    from llm_interpretation_replication_tpu_torch.runtime import plan_search
    from llm_interpretation_replication_tpu_torch.runtime.batching import (
        bucket_for)

    cfg = tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY)
    wb = plan.weight_bytes(cfg, quant)
    if workload == "binary":
        terms = plan_search.binary_need_terms(cfg, wb, b, tokens, 2, impl,
                                              quant=quant)
    elif workload == "full":
        terms = plan.full_study_need_terms(
            cfg, wb, impl, b, tokens, kv_dtype=kv, prefill_chunk=chunk,
            pooled_confidence=True, slot_repack=True, quant=quant)
    else:
        terms = plan.packed_need_terms(cfg, wb, impl, b, bucket_for(tokens),
                                       4, 2, quant=quant)
    need = sum(terms.values())
    assert peak <= need <= 1.8 * peak
