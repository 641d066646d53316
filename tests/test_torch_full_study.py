"""The full-study row on the port's engine against the JAX engine:
completions, the confidence leg on its three routes, and ``score_prefixed``
over one shared prefix cache.

Setup: ``FLAGSHIP_SMALL_GEOMETRY`` in float32, the seed-5 weights of
``tests/test_torch_slots.py`` with the embedding rows past the tokenizer's
ids set to zero (tied embeddings: those ids then never win the greedy
argmax, so every generated token has a text), ``build_test_tokenizer``'s
byte-level BPE (its digits make some completions carry a terminated
integer, so rows retire on the real predicate, and some end inside a
character, which the U+FFFD rule holds back).  Per-prompt targets from a
greedy pre-pass decide a third of the rows at position 0, resolve a third
in the look-ahead and leave a third unresolved.  The same weights,
tokenizer, prompts and config go to both engines.

Classes: ``scan_found``, completions and their first-integer parses
identical; probabilities and ``weighted_confidence`` rtol 2e-5 (atol 1e-9);
the pools' counters equal to the JAX engine's.  Inside the port: the pooled
confidence leg against the per-batch one (first-integer parse identical,
completion a prefix, weighted confidence and probabilities rtol 2e-5),
fused against unfused over the same token streams (the same classes as
against JAX), and an int8 KV cache within |d relative_prob| <= 0.05 of the
unquantized one.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_test_tokenizer, random_decoder_params
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import batching
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.scoring import yes_no
from llm_interpretation_replication_tpu_torch.scoring.confidence import (
    extract_first_int)
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from test_torch_slots import models, one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-5, 1e-9
INT8_KV_ATOL = 0.05
PROB_FIELDS = ("yes_prob", "no_prob", "relative_prob", "odds_ratio",
               "first_token_yes_prob", "first_token_no_prob",
               "first_token_relative_prob")
PROMPTS = ([f"How confident are you about rule {i}, 0-100?" for i in range(6)]
           + [f"Is soup a beverage? Answer {i}:" for i in range(4)]
           + [f"The quick brown fox jumps over the lazy dog {i} times."
              for i in range(2)])
PAIRS = [(f"Scenario {i}: the bylaw covers bicycles in the park.",
          (" Answer Yes or No.", " How confident, 0-100?")) for i in range(6)]
COUNTERS = ("decode_steps_saved", "pooled_conf_rows",
            "pooled_conf_retired_rows", "conf_steps_saved",
            "completion_cache_bytes_freed", "prefix_hit", "prefix_miss")
SMALL = dict(batch_size=4, buckets=(32, 64))


@functools.lru_cache(maxsize=None)
def tok():
    return build_test_tokenizer()


class EosTokenizer:
    """The test tokenizer with an EOS id (it has none of its own)."""

    def __init__(self, inner, eos_token_id):
        self._inner = inner
        self.eos_token_id = eos_token_id

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, *args, **kwargs):
        return self._inner(*args, **kwargs)

    def __len__(self):
        return len(self._inner)


@functools.lru_cache(maxsize=None)
def text_models(w8a8=False):
    """(jax cfg, port cfg, jax params, port weights) of the seed-5 model
    with the embedding rows past the tokenizer's ids zeroed."""
    jcfg, tcfg, _, _ = models()
    params_np = jax.tree_util.tree_map(np.array,
                                       random_decoder_params(jcfg, seed=5))
    params_np["embed"]["tokens"][len(tok()):] = 0
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    weights = convert.params_from_jax(params_np, tcfg, device="cpu",
                                      dtype="fp32")
    return jcfg, tcfg, params, weights


@functools.lru_cache(maxsize=None)
def names():
    """id -> target string naming it (the first id of ``" " + string``)."""
    out = {}
    for i in range(len(tok())):
        s = tok().decode([i])
        if (len(s) > 1 and s.startswith(" ")
                and yes_no.target_token_ids(tok(), [s[1:]])[0] == i):
            out[i] = s[1:]
    return out


@functools.lru_cache(maxsize=None)
def targets(prompts=tuple(PROMPTS), steps=10, top_k=5):
    """Per-prompt (yes, no) strings from one greedy pass of the port's
    decoder: by row i % 3, yes enters the top ``top_k`` at position 0, at a
    look-ahead step 1-9, or never (another role when no nameable id
    fits); no never does."""
    _, tcfg, _, weights = text_models()
    enc = batching.encode_prompts(tok(), list(prompts))
    s = max(map(len, enc))
    ids = np.zeros((len(enc), s), np.int64)
    mask = np.zeros((len(enc), s), np.int32)
    for i, e in enumerate(enc):
        ids[i, :len(e)], mask[i, :len(e)] = e, 1
    tmask = torch.from_numpy(mask)
    last, cache = tdec.prefill(weights, tcfg, torch.from_numpy(ids), tmask,
                               cache_len=s)
    _, sc, *_ = tdec.decode_steps(weights, tcfg, cache, last, tmask.sum(-1),
                                  0, steps, None, None, with_scores=True)
    top = torch.topk(sc, top_k, dim=-1).indices.numpy()       # [N, P, k]
    out = []
    for i in range(len(prompts)):
        seen = set(top[i].ravel())
        never = [t for t in names() if t not in seen]
        roles = [range(0, 1), range(1, steps), range(0)]
        yes = next((t for k in roles[i % 3] for t in top[i, k]
                    if t in names() and t not in top[i, :k].ravel()),
                   never[1])
        out.append((names()[yes], names()[never[0]]))
    return out


def engines(tokenizer=None, w8a8=False, **kw):
    """The JAX and the port engine on the same weights and config."""
    jcfg, tcfg, params, weights = text_models(w8a8)
    tokenizer = tokenizer or tok()
    jeng = jengine.ScoringEngine("falcon", jcfg, params, tokenizer,
                                 engine_config=jengine.EngineConfig(**kw))
    teng = tengine.ScoringEngine("falcon", tcfg, weights, tokenizer,
                                 engine_config=tengine.EngineConfig(**kw),
                                 device="cpu")
    return jeng, teng


def run_both(jcall, tcall):
    """Each call on cleared counters: (ref rows, rows, ref counters,
    counters), the counters restricted to ``COUNTERS``."""
    jtel.clear_counters()
    ref = jcall()
    jc = {k: v for k, v in jtel.counters().items() if k in COUNTERS}
    ttel.clear_counters()
    got = tcall()
    tc = {k: v for k, v in ttel.counters().items() if k in COUNTERS}
    return ref, got, jc, tc


def assert_rows_match(got, ref, rtol=RTOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"]
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=rtol, atol=ATOL,
                                       err_msg=f)
        assert ("weighted_confidence" in g) == ("weighted_confidence" in r)
        wg, wr = g.get("weighted_confidence"), r.get("weighted_confidence")
        assert (wg is None) == (wr is None)
        if wg is not None:
            np.testing.assert_allclose(wg, wr, rtol=rtol, atol=ATOL)


def assert_pooled_agrees(pooled, per_batch):
    """The pooled confidence contract: first-integer parse identical,
    completion a prefix of the full decode's, weighted confidence and the
    position-0 fields as the full decode's."""
    for a, b in zip(pooled, per_batch):
        assert extract_first_int(a["completion"]) == \
            extract_first_int(b["completion"])
        assert b["completion"].startswith(a["completion"])
        wa, wb = a["weighted_confidence"], b["weighted_confidence"]
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_allclose(wa, wb, rtol=RTOL, atol=ATOL)
        for f in PROB_FIELDS[4:]:
            np.testing.assert_allclose(a[f], b[f], rtol=RTOL, atol=ATOL)


# -- completions -------------------------------------------------------------

@pytest.mark.parametrize("ecfg", [
    dict(SMALL),
    dict(SMALL, max_new_tokens=13),
    # full [m, P, V] scores (top_k past the 19 kept candidates)
    dict(batch_size=16, buckets=(32, 64), top_k=600),
], ids=["defaults", "cap-13", "full-scores"])
def test_completion_rows_match_reference(ecfg):
    """``decode_completions=True`` (the default): every row's completion
    text, verdicts and probabilities as the JAX engine's."""
    jeng, teng = engines(**ecfg)
    tg = targets()
    ref, got, jc, tc = run_both(lambda: jeng.score_prompts(PROMPTS, tg),
                                lambda: teng.score_prompts(PROMPTS, tg))
    assert_rows_match(got, ref)
    assert tc == jc
    assert any(r["completion"] for r in got)
    assert 0 < sum(r["scan_found"] for r in got) < len(PROMPTS)


def test_eos_stop_matches_reference():
    """Token 46 ("O") as EOS: every row of these prompts emits it within
    the first chunk, so the stop fires (one chunk late) and
    ``decode_steps_saved`` equals the JAX engine's."""
    prompts = [PROMPTS[6]] + PROMPTS[10:] + [
        f"The quick brown fox jumps over the lazy dog {i} times. Is a tweet "
        f"a publication? Yes or No. Answer:" for i in range(5)]
    eos = EosTokenizer(tok(), 46)
    jeng, teng = engines(tokenizer=eos, **SMALL)
    ref, got, jc, tc = run_both(lambda: jeng.score_prompts(prompts),
                                lambda: teng.score_prompts(prompts))
    assert_rows_match(got, ref)
    assert tc == jc
    assert tc["decode_steps_saved"] == 30 * len(prompts)


# -- the confidence leg --------------------------------------------------------

CONF_ROUTES = {
    "ring": dict(SMALL),
    "flush": dict(SMALL, slot_repack=False),
    "per-batch": dict(SMALL, pooled_confidence=False),
    "no-completions": dict(SMALL, decode_completions=False),
    # full scores: the pool needs ReducedScores, so this decodes per batch
    # and the candidates come from ``_confidence_topk``
    "full-scores": dict(batch_size=16, buckets=(32, 64), top_k=600),
}


@pytest.mark.parametrize("route", sorted(CONF_ROUTES))
def test_confidence_rows_match_reference(route):
    """``with_confidence=True, max_new_tokens=10`` on the ring (the
    defaults), whole flushes, per batch (also on full scores), and the ring
    without completions:
    rows and the pools' counters as the JAX engine's; rows retire on the
    real predicate on the pooled routes."""
    jeng, teng = engines(**CONF_ROUTES[route])
    tg = targets()
    ref, got, jc, tc = run_both(
        lambda: jeng.score_prompts(PROMPTS, tg, with_confidence=True,
                                   max_new_tokens=10),
        lambda: teng.score_prompts(PROMPTS, tg, with_confidence=True,
                                   max_new_tokens=10))
    assert_rows_match(got, ref)
    assert tc == jc
    assert any(extract_first_int(r["completion"]) is not None for r in got) \
        or route == "no-completions"
    if route not in ("per-batch", "full-scores"):
        assert tc["pooled_conf_rows"] == len(PROMPTS)
        assert tc["pooled_conf_retired_rows"] > 0
    else:
        assert "pooled_conf_rows" not in tc


@pytest.mark.parametrize("route", ["ring", "flush"])
def test_pooled_confidence_agrees_with_per_batch(route):
    _, teng = engines(**CONF_ROUTES[route])
    _, full = engines(**CONF_ROUTES["per-batch"])
    tg = targets()
    kw = dict(with_confidence=True, max_new_tokens=10)
    pooled = teng.score_prompts(PROMPTS, tg, **kw)
    per_batch = full.score_prompts(PROMPTS, tg, **kw)
    assert_pooled_agrees(pooled, per_batch)
    assert any(len(a["completion"]) < len(b["completion"])
               for a, b in zip(pooled, per_batch))       # rows cut at r*


def _clean_cut(pool, toks, k):
    """The window ends on a whole character (no U+FFFD tail)."""
    text = pool.engine.tokenizer.decode([int(t) for t in toks[:k]],
                                        skip_special_tokens=True)
    return not text.endswith("�")


RETIRE = {
    # every row at the first checked step
    "min": _clean_cut,
    # rows at step 3 or 6 by their first token's parity: a function of the
    # row's own tokens, as the real predicate is
    "staggered": lambda pool, toks, k: (k >= 3 + 3 * (int(toks[0]) % 2)
                                        and _clean_cut(pool, toks, k)),
}


@pytest.mark.parametrize("rule", sorted(RETIRE))
@pytest.mark.parametrize("route", ["ring", "flush"])
def test_forced_retirement_matches_reference(monkeypatch, route, rule):
    """``_conf_retired_at`` forced in both packages: rows and counters as
    the JAX engine's, steps saved (and, for whole flushes of 12 rows
    retiring at different steps, retired rows' K/V compacted away), and the
    rows agree with the port's full per-batch decode."""
    monkeypatch.setattr(jengine._Phase2Pool, "_conf_retired_at",
                        RETIRE[rule])
    monkeypatch.setattr(tengine._Phase2Pool, "_conf_retired_at",
                        RETIRE[rule])
    jeng, teng = engines(**dict(CONF_ROUTES[route], batch_size=16))
    tg = targets()
    kw = dict(with_confidence=True, max_new_tokens=10)
    ref, got, jc, tc = run_both(lambda: jeng.score_prompts(PROMPTS, tg, **kw),
                                lambda: teng.score_prompts(PROMPTS, tg, **kw))
    assert_rows_match(got, ref)
    assert tc == jc
    assert tc["conf_steps_saved"] > 0 and tc["pooled_conf_retired_rows"] > 0
    if route == "flush" and rule == "staggered":
        assert tc["completion_cache_bytes_freed"] > 0
    _, full = engines(**CONF_ROUTES["per-batch"])
    per_batch = full.score_prompts(PROMPTS, tg, **kw)
    for a, b in zip(got, per_batch):
        assert b["completion"].startswith(a["completion"])
        np.testing.assert_allclose(a["weighted_confidence"] or 0.0,
                                   b["weighted_confidence"] or 0.0,
                                   rtol=RTOL, atol=ATOL)


def test_confidence_int8_kv_within_tolerance():
    _, bf16 = engines(**SMALL)
    _, int8 = engines(**dict(SMALL, kv_dtype="int8"))
    tg = targets()
    kw = dict(with_confidence=True, max_new_tokens=10)
    rows_bf, rows_i8 = (e.score_prompts(PROMPTS, tg, **kw)
                        for e in (bf16, int8))
    assert int8.cfg.kv_cache_dtype == "int8"
    for a, b in zip(rows_i8, rows_bf):
        assert a["success"]
        for f in ("yes_prob", "no_prob", "relative_prob"):
            assert abs(a[f] - b[f]) <= INT8_KV_ATOL, (f, a[f], b[f])


# -- score_prefixed -----------------------------------------------------------

LEGS = [("binary", {}), ("confidence", dict(with_confidence=True,
                                            max_new_tokens=10))]


def _legs(mod):
    return [mod.LegSpec(name, **kw) for name, kw in LEGS]


@functools.lru_cache(maxsize=None)
def pair_targets():
    return targets(tuple(p + s[0] for p, s in PAIRS))


@pytest.mark.parametrize("ecfg", [dict(), dict(pooled_confidence=False)],
                         ids=["defaults", "per-batch-confidence"])
def test_score_prefixed_two_legs_match_reference(ecfg):
    """Both legs at ``EngineConfig()`` with every field at its default (and
    with the confidence leg per batch): rows, counters and the prefix
    pool's audit as the JAX engine's."""
    jeng, teng = engines(**ecfg)
    tg = pair_targets()
    ref, got, jc, tc = run_both(
        lambda: jeng.score_prefixed(PAIRS, tg, legs=_legs(jengine)),
        lambda: teng.score_prefixed(PAIRS, tg, legs=_legs(tengine)))
    for leg_got, leg_ref in zip(got, ref):
        assert_rows_match(leg_got, leg_ref)
    assert tc == jc
    assert tc["prefix_miss"] == tc["prefix_hit"] == len(PAIRS)
    assert teng.last_prefix_pool.consistent
    assert all(r["completion"] for r in got[0])


def test_fused_matches_unfused():
    """Inside the port: each leg's fused rows against ``score_prompts`` on
    the same token streams (prefix ids then suffix ids)."""
    _, teng = engines()
    tg = pair_targets()
    fused = teng.score_prefixed(PAIRS, tg, legs=_legs(tengine))
    pre, suf = batching.encode_prefix_pairs(tok(), PAIRS)
    for li, (_, kw) in enumerate(LEGS):
        unfused = teng.score_prompts([p + s for p, s in zip(pre, suf[li])],
                                     tg, **kw)
        assert_rows_match(fused[li], unfused)


def test_prefix_pairs_route_to_score_prefixed():
    _, teng = engines(**SMALL)
    pairs = [(p, s[1]) for p, s in PAIRS]
    rows = teng.score_prompts(pairs, with_confidence=True, max_new_tokens=10)
    assert rows == teng.score_prefixed(
        [(p, (s,)) for p, s in pairs],
        legs=[tengine.LegSpec(with_confidence=True, max_new_tokens=10)])[0]


def test_prefix_pool_consistent_after_oom_mid_suffix(monkeypatch):
    """An OOM at the first batch's second leg re-buckets that batch: its
    prefix entry is released once, the retried sub-batches take fresh
    entries, and the rows are those of a clean run."""
    _, teng = engines(batch_size=4, oom_batch_floor=1, oom_batch_ladder=())
    clean = teng.score_prefixed(PAIRS, legs=_legs(tengine))
    real_extend = tdec.extend_prefill
    calls = {"n": 0}

    def failing_extend(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real_extend(*args, **kwargs)

    monkeypatch.setattr(tengine.dmod, "extend_prefill", failing_extend)
    fused = teng.score_prefixed(PAIRS, legs=_legs(tengine))
    pool = teng.last_prefix_pool
    assert pool.consistent and pool.live_bytes == 0 and not pool.live
    assert pool.acquired == pool.released > 2      # the retry re-acquired
    assert [e["kind"] for e in teng.fault_events] == ["engine_oom_backoff"]
    for leg_clean, leg_fused in zip(clean, fused):
        assert_rows_match(leg_fused, leg_clean)


def test_prefix_pool_double_release_raises():
    pool = tengine.PrefixCachePool()
    entry = pool.acquire(128, 4)
    pool.release(entry)
    with pytest.raises(RuntimeError, match="released twice"):
        pool.release(entry)
    assert pool.consistent


def test_prefix_pool_abandoned_entry_counts_as_leak():
    pool = tengine.PrefixCachePool()
    pool.acquire(128, 4)
    pool.close()
    pool.close()                                   # idempotent
    assert pool.leaked == 1 and not pool.consistent
    assert pool.live_bytes == 0


# -- what stays refused ---------------------------------------------------------

@pytest.mark.parametrize("case,title", [
    ("prefill_chunk", "The full-study legs"),
    ("decode_k", "K-decode"),
    ("decode_k_4", "K-decode"),
    ("mesh", "Parallel and training"),
])
def test_unported_settings_still_raise(case, title):
    """A mesh raises naming its ROADMAP.md item.  The settings once refused
    here score at ``EngineConfig()``'s other defaults: ``prefill_chunk=1``
    ("The full-study legs"), and ``decode_k`` 2 and 4 ("K-decode"), which
    with no K-head run sequentially (``k_decode_head_missing`` noted once)
    and give the ``decode_k=1`` rows."""
    _, tcfg, _, weights = text_models()
    if case == "mesh":
        with pytest.raises(NotImplementedError, match=title):
            tengine.ScoringEngine("falcon", tcfg, weights, tok(),
                                  mesh=object(), device="cpu")
        return
    kw = ({"decode_k": 4 if case == "decode_k_4" else 2}
          if case.startswith("decode_k") else {"prefill_chunk": 1})
    eng = tengine.ScoringEngine(
        "falcon", tcfg, weights, tok(), device="cpu",
        engine_config=tengine.EngineConfig(**kw))
    ttel.clear_counters()
    rows = eng.score_prompts(PROMPTS[:3])
    assert all(r["success"] and r["completion"] for r in rows)
    if case.startswith("decode_k"):
        assert ttel.counter("k_decode_head_missing") == 1
        ref = tengine.ScoringEngine("falcon", tcfg, weights, tok(),
                                    device="cpu").score_prompts(PROMPTS[:3])
        assert rows == ref


def test_default_config_scores():
    """``EngineConfig()`` with every field at its default scores."""
    _, tcfg, _, weights = text_models()
    eng = tengine.ScoringEngine("falcon", tcfg, weights, tok(), device="cpu")
    assert dataclasses.asdict(eng.ecfg) == dataclasses.asdict(
        tengine.EngineConfig())
    rows = eng.score_prompts(PROMPTS[:3])
    assert all(r["success"] and r["completion"] for r in rows)
