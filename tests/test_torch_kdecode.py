"""Joint next-K-token decode on the port against the JAX package: the
decoder's ``k_verify_block`` and K-head (``init_k_head``, ``k_propose``,
``distill_k_head``), the engine's K path on its three call sites (the
completion chunks, the pooled confidence flush, the slot ring) and the
K-head file (``runtime.loader``).

Setup: ``FLAGSHIP_SMALL_GEOMETRY`` in float32, the full-study tests' seed-5
weights and tokenizer, the same inputs to both packages, the JAX side on
the CPU with its interpret-mode causal kernel.  Proposals come from a
distilled head, from a random ``init_k_head`` (which forces rejections),
or from ``chip_smoke.oracle_engine``, which replays the K=1 chain so every
block is accepted.

Classes: tokens, verdicts, completions, ``a_len`` and counters identical;
logits and probabilities rtol 2e-5 against the JAX package; K=4 against
K=1 probabilities within |d| <= 2e-6; single-query blocks and
forced-rejection rows bit-identical to the sequential decode.  The
distilled head is held to the reference's on the same inputs through its
logits on the distillation features (rtol 1e-4 relative Frobenius) and its
proposals (identical): its components along directions the features hardly
span follow float32 rounding (``decoder.ridge_probe``).
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu.runtime import loader as jloader
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import batching
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import loader as tloader
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from test_torch_full_study import (PAIRS, PROMPTS, EosTokenizer,
                                   text_models, tok)
from test_torch_full_study import targets as study_targets
from test_torch_slots import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

RTOL, ATOL = 2e-5, 1e-9
K_ATOL = 2e-6                      # K=4 against K=1 (PARITY.md "K-decode")
EXACT = ("scan_found", "completion", "success", "first_token_yes_prob",
         "first_token_no_prob", "first_token_relative_prob")
PROBS = ("yes_prob", "no_prob", "relative_prob")
SMALL = dict(batch_size=4, buckets=(32, 64))
K_COUNTERS = ("k_blocks_proposed", "k_blocks_rejected", "k_steps_saved",
              "k_steps_saved|leg=completion", "k_steps_saved|leg=confidence",
              "k_steps_saved|leg=binary", "decode_steps_saved")
CONF = dict(with_confidence=True, max_new_tokens=10)


def _k_rows_equal(got, ref, atol=K_ATOL):
    """Rows of two K settings: discrete and position-0 fields identical,
    the decode's probabilities within ``atol``."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for f in EXACT:
            assert a.get(f) == b.get(f), (f, a.get(f), b.get(f))
        for f in PROBS:
            np.testing.assert_allclose(a[f], b[f], rtol=0, atol=atol,
                                       err_msg=f)
        wa, wb = a.get("weighted_confidence"), b.get("weighted_confidence")
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_allclose(wa, wb, rtol=0, atol=1e-4)


def _rows_match(got, ref):
    """Rows of the port against the JAX package's."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a["scan_found"] == b["scan_found"]
        assert a["completion"] == b["completion"]
        for f in PROBS + EXACT[3:]:
            np.testing.assert_allclose(a[f], b[f], rtol=RTOL, atol=ATOL,
                                       err_msg=f)
        wa, wb = a.get("weighted_confidence"), b.get("weighted_confidence")
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_allclose(wa, wb, rtol=RTOL, atol=ATOL)


def _counters(tel):
    c = tel.counters()
    return {k: c.get(k, 0) for k in K_COUNTERS}


# -- the decoder: k_verify_block ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs(seed=0, b=3, s=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 290, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int32)
    mask[1, 6:] = 0
    ids[1, 6:] = 0
    return ids, mask


def _prefilled(kv_dtype="bf16"):
    """The port's (cfg, cache, last, lengths, targets) after one prefill of
    the seeded inputs."""
    _, tcfg, _, weights = text_models()
    cfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype)
    ids, mask = _inputs()
    tm = torch.from_numpy(mask)
    last, cache = tdec.prefill(weights, cfg, torch.from_numpy(ids), tm,
                               cache_len=ids.shape[1])
    tgt = torch.tensor([[5, 9]] * ids.shape[0])
    return cfg, cache, last, tm.sum(-1), tgt


def _verify_chunk(cfg, cache, last, lengths, tgt, n, blocks, proposals,
                  eos_id=None):
    """``k_verify_block`` over one chunk in ``blocks``-sized blocks sharing
    one tail; returns (tokens, ReducedScores, folded cache, last logits,
    the passes)."""
    _, _, _, weights = text_models()
    b = int(last.shape[0])
    cdt = torch.float32 if cache.k_scale is not None else cache.k.dtype
    shape = (cfg.num_layers, b, n, cfg.num_kv_heads, cfg.head_dim)
    tk, tv = torch.zeros(shape, dtype=cdt), torch.zeros(shape, dtype=cdt)
    prev, done, j, outs = last, None, 0, []
    for kb in blocks:
        out = tdec.k_verify_block(
            weights, cfg, cache, tk, tv, prev, lengths, 0, j,
            torch.as_tensor(proposals[:, j:j + kb]), eos_id, done, tgt,
            with_scores="reduced", fold=(j + kb == n))
        outs.append(out)
        prev, done = out.last_logits, out.done
        j += kb
    sc = tdec.ReducedScores(*(torch.cat([getattr(o.scores, f) for o in outs],
                                        dim=1)
                              for f in tdec.ReducedScores._fields))
    return (torch.cat([o.tokens for o in outs], dim=1), sc, outs[-1].cache,
            prev, outs)


class TestKVerifyBlock:
    @pytest.mark.parametrize("kv", ["bf16", "int8"])
    def test_single_query_blocks_bit_identical_to_sequential(self, kv):
        """A chunk verified in single-query blocks sharing the chunk's tail
        reproduces ``decode_steps`` bit for bit: tokens, every reduced
        score, the frontier logits and the folded cache (an int8 cache's
        codes and scales too: the fold points are the chunk's)."""
        _, _, _, weights = text_models()
        cfg, cache, last, lengths, tgt = _prefilled(kv)
        n = 6
        t6, s6, c6, l6, _ = tdec.decode_steps(
            weights, cfg, cache, last, lengths, 0, n, None, None,
            with_scores="reduced", target_ids=tgt)
        toks, sc, fc, prev, outs = _verify_chunk(
            cfg, cache, last, lengths, tgt, n, (1,) * n, t6.numpy())
        assert all(bool(o.accepted.all()) for o in outs)
        assert torch.equal(toks, t6) and torch.equal(prev, l6)
        for f in tdec.ReducedScores._fields:
            assert torch.equal(getattr(sc, f), getattr(s6, f)), f
        for f in ("k", "v", "positions", "valid", "k_scale", "v_scale"):
            a, b = getattr(fc, f), getattr(c6, f)
            assert (a is None and b is None) or torch.equal(a, b), f

    @pytest.mark.parametrize("blocks", [(1, 3, 2), (1, 4, 1), (2, 4)])
    def test_multi_query_blocks_token_exact_scores_within_noise(self, blocks):
        _, _, _, weights = text_models()
        cfg, cache, last, lengths, tgt = _prefilled()
        n = 6
        t6, s6, c6, l6, _ = tdec.decode_steps(
            weights, cfg, cache, last, lengths, 0, n, None, None,
            with_scores="reduced", target_ids=tgt)
        toks, sc, fc, prev, outs = _verify_chunk(
            cfg, cache, last, lengths, tgt, n, blocks, t6.numpy())
        assert all(bool(o.accepted.all()) for o in outs)
        assert torch.equal(toks, t6)
        assert torch.equal(sc.topk_ids, s6.topk_ids)
        for f in ("topk_vals", "logz", "target_logits"):
            np.testing.assert_allclose(getattr(sc, f), getattr(s6, f),
                                       rtol=1e-6, atol=1e-5, err_msg=f)
        np.testing.assert_allclose(prev, l6, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(fc.k, c6.k, rtol=1e-5, atol=1e-5)
        assert torch.equal(fc.valid, c6.valid)

    @pytest.mark.parametrize("kv,eos", [("bf16", False), ("int8", False),
                                        ("bf16", True)])
    def test_matches_reference(self, kv, eos):
        """One pass over a block of the sequential tokens with one wrong
        proposal, then the rest of the chunk with the fold, in both
        packages: true tokens, ``a_len``, ``accepted`` and ``done``
        identical, scores, logits, hidden and the folded cache rtol
        2e-5."""
        jcfg, _, params, weights = text_models()
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        cfg, cache, last, lengths, tgt = _prefilled(kv)
        ids, mask = _inputs()
        jlast, jcache = jdec.prefill(params, jcfg, jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(mask), cache_len=ids.shape[1])
        n = 5
        seq = tdec.decode_steps(weights, cfg, cache, last, lengths, 0, n,
                                None, None, with_scores=False)[0].numpy()
        eos_id = None
        if eos:     # the EOS-frozen chain, with row 0's second token as EOS
            eos_id = int(seq[0, 1])
            seq = tdec.decode_steps(weights, cfg, cache, last, lengths, 0, n,
                                    eos_id, None, with_scores=False)[0].numpy()
        props = seq.copy()
        props[2, 2] = (props[2, 2] + 1) % cfg.vocab_size
        b = ids.shape[0]
        shape = (cfg.num_layers, b, n, cfg.num_kv_heads, cfg.head_dim)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        jtk = jtv = jnp.zeros(shape, jnp.float32)
        prev, jprev, done, jdone = last, jlast, None, None
        first = None
        for j, kb in ((0, 3), (3, 2)):
            out = tdec.k_verify_block(
                weights, cfg, cache, tk, tv, prev, lengths, 0, j,
                torch.from_numpy(props[:, j:j + kb]), eos_id, done, tgt,
                with_scores="reduced", fold=j + kb == n)
            ref = jdec.k_verify_block(
                params, jcfg, jcache, jtk, jtv, jprev,
                jnp.asarray(mask.sum(-1)), jnp.int32(0), jnp.int32(j),
                jnp.asarray(props[:, j:j + kb], jnp.int32), eos_id, jdone,
                jnp.asarray(tgt.numpy(), jnp.int32), with_scores="reduced",
                fold=j + kb == n)
            for f in ("tokens", "a_len", "accepted", "done"):
                np.testing.assert_array_equal(getattr(out, f).numpy(),
                                              np.asarray(getattr(ref, f)),
                                              err_msg=f)
            for f in ("last_logits", "last_hidden", "tail_k", "tail_v"):
                np.testing.assert_allclose(getattr(out, f).numpy(),
                                           np.asarray(getattr(ref, f)),
                                           rtol=RTOL, atol=2e-5, err_msg=f)
            for f in tdec.ReducedScores._fields:
                np.testing.assert_allclose(
                    getattr(out.scores, f).numpy(),
                    np.asarray(getattr(ref.scores, f)), rtol=RTOL,
                    atol=2e-5, err_msg=f)
            first = out if first is None else first
            prev, done, tk, tv = out.last_logits, out.done, out.tail_k, out.tail_v
            jprev, jdone, jtk, jtv = ref.last_logits, ref.done, ref.tail_k, \
                ref.tail_v
        assert first.a_len.tolist() == [3, 3, 2]
        for f in ("k", "v", "positions", "valid", "k_scale", "v_scale"):
            a, b = getattr(out.cache, f), getattr(ref.cache, f)
            if a is None:
                assert b is None
            else:
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=RTOL, atol=2e-5, err_msg=f)

    def test_mismatch_reports_prefix_and_rejects(self):
        _, _, _, weights = text_models()
        cfg, cache, last, lengths, tgt = _prefilled()
        n = 4
        seq = tdec.decode_steps(weights, cfg, cache, last, lengths, 0, n,
                                None, None, with_scores=False)[0]
        props = seq.clone()
        props[0, 2] = (props[0, 2] + 1) % cfg.vocab_size
        shape = (cfg.num_layers, 3, n, cfg.num_kv_heads, cfg.head_dim)
        out = tdec.k_verify_block(weights, cfg, cache, torch.zeros(shape),
                                  torch.zeros(shape), last, lengths, 0, 0,
                                  props, None, None, tgt, fold=True)
        assert out.a_len.tolist() == [2, n, n]
        assert out.accepted.tolist() == [False, True, True]
        assert int(out.tokens[0, 2]) == int(seq[0, 2])
        with pytest.raises(ValueError, match="target_ids"):
            tdec.k_verify_block(weights, cfg, cache, torch.zeros(shape),
                                torch.zeros(shape), last, lengths, 0, 0,
                                props, with_scores="reduced")

    def test_eos_frozen_chain_matches_sequential(self):
        _, _, _, weights = text_models()
        cfg, cache, last, lengths, tgt = _prefilled()
        n = 6
        ref = tdec.decode_steps(weights, cfg, cache, last, lengths, 0, n,
                                None, None, with_scores=False)[0]
        eos_id = int(ref[0, 1])
        t_eos, _, _, _, d_eos = tdec.decode_steps(
            weights, cfg, cache, last, lengths, 0, n, eos_id, None,
            with_scores=False)
        toks, _, _, _, outs = _verify_chunk(cfg, cache, last, lengths, tgt,
                                            n, (1, 5), t_eos.numpy(), eos_id)
        assert all(bool(o.accepted.all()) for o in outs)
        assert torch.equal(toks, t_eos)
        assert torch.equal(outs[-1].done, d_eos)


# -- the K-head ------------------------------------------------------------------

def _encoded(prompts):
    enc = batching.encode_prompts(tok(), prompts)
    s = max(map(len, enc))
    ids = np.zeros((len(enc), s), np.int64)
    mask = np.zeros((len(enc), s), np.int32)
    for r, e in enumerate(enc):
        ids[r, :len(e)], mask[r, :len(e)] = e, 1
    return ids, mask


class TestKHead:
    @pytest.mark.parametrize("k,seed", [(4, 1), (2, 0), (1, 3)])
    def test_init_matches_reference(self, k, seed):
        jcfg, tcfg, _, _ = text_models()
        head = tdec.init_k_head(tcfg, k, seed=seed)
        ref = np.asarray(jdec.init_k_head(jcfg, k, seed=seed)["w"])
        assert head["w"].shape == (max(0, k - 1), tcfg.hidden_size,
                                   tcfg.vocab_size)
        np.testing.assert_array_equal(head["w"].numpy(), ref)
        assert tdec.k_head_num_heads(head) == max(0, k - 1)
        assert tdec.k_head_num_heads(None) == 0
        bf = tdec.init_k_head(tcfg, 2, seed=seed, dtype=torch.bfloat16)
        assert bf["w"].dtype == torch.bfloat16

    def test_propose_matches_reference_and_freezes_done_rows(self):
        jcfg, tcfg, _, _ = text_models()
        head = tdec.init_k_head(tcfg, 4, seed=2)
        rng = np.random.default_rng(5)
        hidden = rng.standard_normal((3, tcfg.hidden_size)).astype(np.float32)
        logits = rng.standard_normal((3, tcfg.vocab_size)).astype(np.float32)
        done = np.asarray([True, False, False])
        got = tdec.k_propose(head, torch.from_numpy(hidden),
                             torch.from_numpy(logits), 4,
                             torch.from_numpy(done), 7)
        ref = jdec.k_propose(jdec.init_k_head(jcfg, 4, seed=2),
                             jnp.asarray(hidden), jnp.asarray(logits), 4,
                             jnp.asarray(done), 7)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got[0] == 7).all() and got.shape == (3, 4)

    def test_ridge_probe_matches_the_normal_equations(self):
        """The probe against the reference's normal equations in float64
        numpy on the same features (well conditioned here)."""
        rng = np.random.default_rng(0)
        f = rng.standard_normal((40, 16)).astype(np.float32)
        t = rng.integers(0, 30, 40)
        y = np.zeros((40, 30))
        y[np.arange(40), t] = 1
        a = f.T.astype(np.float64) @ f + 1e-4 * 40 * np.eye(16)
        ref = np.linalg.solve(a, f.T.astype(np.float64) @ y)
        got = tdec.ridge_probe(torch.from_numpy(f), torch.from_numpy(t), 30)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)

    def test_distill_matches_reference(self, monkeypatch):
        """The distilled head against the reference's on the same prompts
        (the reference with dense attention, which masks the padding
        between a prompt and its continuation): its logits on the
        distillation features within 1e-4 relative Frobenius, the same
        proposals from them, and the weights' dtype."""
        jcfg, tcfg, params, weights = text_models()
        ids, mask = _encoded(PROMPTS[:6])
        feats = []
        real = tdec.ridge_probe

        def capture(f, t, v, ridge):
            feats.append(f.clone())
            return real(f, t, v, ridge)

        monkeypatch.setattr(tdec, "ridge_probe", capture)
        head = tdec.distill_k_head(weights, tcfg, torch.from_numpy(ids),
                                   torch.from_numpy(mask), k=4)
        ref = np.asarray(jdec.distill_k_head(
            params, dataclasses.replace(jcfg, attention_impl="xla"),
            ids.astype(np.int32), mask, k=4)["w"])
        assert head["w"].dtype == torch.float32 and len(feats) == 3
        for i, f in enumerate(feats):
            got = (f @ head["w"][i]).numpy()
            want = f.numpy() @ ref[i]
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        assert tdec.distill_k_head(weights, tcfg, torch.from_numpy(ids),
                                   torch.from_numpy(mask), k=1)["w"].shape \
            == (0, tcfg.hidden_size, tcfg.vocab_size)

    def test_distilled_head_proposes_the_greedy_continuation(self):
        """Distilled on the inputs it then decodes: after a bootstrap pass,
        a 3-token block of its proposals is the greedy continuation."""
        _, _, _, weights = text_models()
        cfg, cache, last, lengths, tgt = _prefilled()
        ids, mask = _inputs()
        head = tdec.distill_k_head(weights, cfg, torch.from_numpy(ids),
                                   torch.from_numpy(mask), k=4, gen_steps=8)
        n = 4
        seq = tdec.decode_steps(weights, cfg, cache, last, lengths, 0, n,
                                None, None, with_scores=False)[0]
        shape = (cfg.num_layers, 3, n, cfg.num_kv_heads, cfg.head_dim)
        boot = tdec.k_verify_block(
            weights, cfg, cache, torch.zeros(shape), torch.zeros(shape),
            last, lengths, 0, 0, torch.argmax(last, -1)[:, None],
            target_ids=tgt)
        props = tdec.k_propose(head, boot.last_hidden, boot.last_logits, 3)
        assert torch.equal(props, seq[:, 1:4])


# -- the engine -------------------------------------------------------------------

def _port(cls=tengine.ScoringEngine, tokenizer=None, **kw):
    _, tcfg, _, weights = text_models()
    return cls("falcon", tcfg, weights, tokenizer or tok(), device="cpu",
               engine_config=tengine.EngineConfig(**{**SMALL, **kw}))


def _jax(cls=jengine.ScoringEngine, tokenizer=None, **kw):
    jcfg, _, params, _ = text_models()
    return cls("falcon", jcfg, params, tokenizer or tok(),
               engine_config=jengine.EngineConfig(**{**SMALL, **kw}))


T_ORACLE = chip_smoke.oracle_engine(tengine, tdec)
J_ORACLE = chip_smoke.oracle_engine(jengine, jdec)

# each route on 8 of the full-study tests' prompts (two batches of 4)
ROUTES = {
    "completion": lambda e, tg: e.score_prompts(PROMPTS[:8], tg[:8]),
    "confidence": lambda e, tg: e.score_prompts(PROMPTS[:8], tg[:8], **CONF),
    "confidence-flush": lambda e, tg: e.score_prompts(PROMPTS[:8], tg[:8],
                                                      **CONF),
    "binary-ring": lambda e, tg: e.score_prompts(PROMPTS[:8], tg[:8]),
}
# the completion route generates 20 tokens (two chunks of the scan's 10),
# which keeps the JAX side's compiles few
ROUTE_KW = {"completion": dict(max_new_tokens=20), "confidence": {},
            "confidence-flush": dict(slot_repack=False),
            "binary-ring": dict(decode_completions=False)}


class TestEngineParity:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_oracle_rows_match_k1_and_reference(self, route):
        """Oracle proposals (every block accepted) on each call site: the
        K=1 rows within the K class, the JAX engine's oracle rows and K
        counters, and the K path really ran on the route's leg."""
        tg = study_targets()
        kw = ROUTE_KW[route]
        call = ROUTES[route]
        ref = call(_port(**kw), tg)
        jtel.clear_counters()
        jrows = call(_jax(J_ORACLE, decode_k=4, **kw), tg)
        jc = _counters(jtel)
        ttel.clear_counters()
        h0 = ttel.hist_count("accepted_k")
        got = call(_port(T_ORACLE, decode_k=4, **kw), tg)
        tc = _counters(ttel)
        _k_rows_equal(got, ref)
        _rows_match(got, jrows)
        assert tc == jc
        leg = {"completion": "completion", "binary-ring": "binary"}.get(
            route, "confidence")
        assert tc[f"k_steps_saved|leg={leg}"] > 0
        assert tc["k_blocks_proposed"] > 0 and tc["k_blocks_rejected"] == 0
        assert ttel.hist_count("accepted_k") - h0 == tc["k_blocks_proposed"]

    @pytest.mark.parametrize("route", ["completion", "confidence"])
    def test_forced_rejection_rows_bit_identical(self, route):
        """A random head: every speculative block rejects and the chunk
        re-runs sequentially, so the rows are the K=1 rows bit for bit and
        no step is claimed saved; the JAX engine with the same head counts
        the same."""
        tg = study_targets()
        call = ROUTES[route]
        kw = ROUTE_KW[route]
        ref = call(_port(**kw), tg)
        eng, jeng = _port(decode_k=4, **kw), _jax(decode_k=4, **kw)
        eng.k_head = tdec.init_k_head(eng.cfg, 4, seed=11)
        jeng.k_head = jdec.init_k_head(jeng.cfg, 4, seed=11)
        jtel.clear_counters()
        jrows = call(jeng, tg)
        jc = _counters(jtel)
        ttel.clear_counters()
        got = call(eng, tg)
        tc = _counters(ttel)
        assert got == ref
        _rows_match(got, jrows)
        assert tc == jc
        assert tc["k_blocks_rejected"] > 0 and tc["k_steps_saved"] == 0

    def test_distilled_rows_match_k1_and_reference(self):
        """A distilled head (the port's, given to both engines): the K=1
        rows within the K class and the JAX engine's rows, on the
        completion and confidence legs."""
        tg = study_targets()
        eng, jeng = _port(decode_k=4), _jax(decode_k=4)
        head = eng.distill_k_head_on(PROMPTS)
        assert ttel.counter("k_head_distilled") >= 1
        jeng.k_head = {"w": jnp.asarray(head["w"].numpy())}
        for route in ("completion", "confidence"):
            eng.ecfg = dataclasses.replace(eng.ecfg, **ROUTE_KW[route])
            jeng.ecfg = dataclasses.replace(jeng.ecfg, **ROUTE_KW[route])
            ref = ROUTES[route](_port(**ROUTE_KW[route]), tg)
            got = ROUTES[route](eng, tg)
            _k_rows_equal(got, ref)
            _rows_match(got, ROUTES[route](jeng, tg))

    def test_missing_head_runs_sequential(self):
        prompts = PROMPTS[:4]
        ref = _port().score_prompts(prompts)
        eng = _port(decode_k=4)
        snap = ttel.counters()
        got = eng.score_prompts(prompts)
        assert got == ref
        delta = ttel.counters_since(snap)
        assert delta.get("k_decode_head_missing", 0) == 1
        assert delta.get("k_blocks_proposed", 0) == 0
        eng.score_prompts(prompts)
        assert ttel.counters_since(snap).get("k_decode_head_missing", 0) == 1

    def test_k1_never_records_k_telemetry(self):
        snap = ttel.counters()
        _port().score_prompts(PROMPTS[:4], **CONF)
        assert not any(k.startswith("k_") for k in ttel.counters_since(snap))
        assert _port().distill_k_head_on(PROMPTS) is None

    def test_fused_two_leg_parity_across_pool_compositions(self):
        """``score_prefixed`` with both legs at K=4 (oracle) under two pool
        targets: the K=1 rows, leg by leg."""
        from llm_interpretation_replication_tpu_torch.runtime.engine import (
            LegSpec)

        legs = [LegSpec("binary"), LegSpec("confidence", **CONF)]
        ref = _port().score_prefixed(PAIRS, legs=legs)
        for target in (0, 3):
            got = _port(T_ORACLE, decode_k=4,
                        phase2_pool_target=target).score_prefixed(
                PAIRS, legs=legs)
            for leg_ref, leg_got in zip(ref, got):
                _k_rows_equal(leg_got, leg_ref)

    def test_packed_demos_through_the_k_path(self):
        """The packed demos' ring (no scores) at K=4: the K=1 demos."""
        qs = [f"Q{i}: is a tent a dwelling? Answer Yes or No."
              for i in range(6)]
        kw = dict(phase2_pool_target=2, buckets=(32, 64, 128))
        ref = _port(**kw).packed_autoregressive_demos(qs, 3,
                                                      max_demo_tokens=6)
        ttel.clear_counters()
        got = _port(T_ORACLE, decode_k=4, **kw).packed_autoregressive_demos(
            qs, 3, max_demo_tokens=6)
        assert got == ref
        assert ttel.counter("k_steps_saved|leg=packed") > 0


class TestEosComposition:
    def test_eos_saved_and_k_saved_are_disjoint(self):
        """Token 46 as EOS (every row emits it in its first chunk): at K=4
        the stop is exact, so ``decode_steps_saved`` counts the chunks never
        launched and ``k_steps_saved`` the positions decoded jointly; both
        fire, their sum stays within the decode's positions, and both
        equal the JAX engine's."""
        prompts = [PROMPTS[6]] + PROMPTS[10:] + [
            f"The quick brown fox jumps over the lazy dog {i} times. Is a "
            f"tweet a publication? Yes or No. Answer:" for i in range(5)]
        eos = EosTokenizer(tok(), 46)
        ref = _port(tokenizer=eos).score_prompts(prompts)
        jtel.clear_counters()
        jrows = _jax(J_ORACLE, tokenizer=eos, decode_k=4).score_prompts(
            prompts)
        jc = _counters(jtel)
        ttel.clear_counters()
        got = _port(T_ORACLE, tokenizer=eos, decode_k=4).score_prompts(
            prompts)
        tc = _counters(ttel)
        _k_rows_equal(got, ref)
        _rows_match(got, jrows)
        assert tc == jc
        assert tc["decode_steps_saved"] > 0 and tc["k_steps_saved"] > 0
        assert tc["decode_steps_saved"] + tc["k_steps_saved"] <= \
            50 * len(prompts)


# -- the K-head file ---------------------------------------------------------------

class TestKHeadFile:
    def _snapshot(self, tmp_path):
        snap = tmp_path / "snap"
        snap.mkdir()
        (snap / "config.json").write_text('{"model_type": "falcon"}')
        (snap / "model.safetensors").write_bytes(b"\0" * 64)
        return str(snap)

    def test_round_trip_and_misses(self, tmp_path):
        snap = self._snapshot(tmp_path)
        _, tcfg, _, _ = text_models()
        head = tdec.init_k_head(tcfg, 3, seed=4)
        assert tloader.snapshot_fingerprint(snap) == \
            jloader.snapshot_fingerprint(snap)
        path = tloader.save_k_head(snap, head, 3)
        assert os.path.basename(path) == tloader.K_HEAD_FILENAME
        got = tloader.load_k_head(snap, 3)
        assert torch.equal(got["w"], head["w"])
        assert tloader.load_k_head(snap, 3, dtype=torch.bfloat16)["w"].dtype \
            == torch.bfloat16
        assert tloader.load_k_head(snap, 4) is None          # decode_k
        assert tloader.load_k_head(snap, 3, fingerprint="x") is None
        (tmp_path / "snap" / "model.safetensors").write_bytes(b"\0" * 65)
        assert tloader.load_k_head(snap, 3) is None          # other weights
        with open(path, "wb") as f:
            f.write(b"torn")
        assert tloader.load_k_head(snap, 3) is None
        assert tloader.load_k_head(str(tmp_path), 3) is None  # no file

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_files_cross_load(self, tmp_path, writer):
        """A head written by either package loads in the other."""
        snap = self._snapshot(tmp_path)
        jcfg, tcfg, _, _ = text_models()
        if writer == "port":
            tloader.save_k_head(snap, tdec.init_k_head(tcfg, 3, seed=6), 3)
            got = jloader.load_k_head(snap, 3)["w"]
        else:
            jloader.save_k_head(snap, jdec.init_k_head(jcfg, 3, seed=6), 3)
            got = tloader.load_k_head(snap, 3)["w"].numpy()
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(jdec.init_k_head(jcfg, 3, seed=6)["w"]))

    def test_attach_k_head(self, tmp_path):
        snap = self._snapshot(tmp_path)
        eng = _port(decode_k=3)
        assert not tloader.attach_k_head(eng, snap)          # no file yet
        tloader.save_k_head(snap, tdec.init_k_head(eng.cfg, 3, seed=1), 3)
        assert not tloader.attach_k_head(_port(), snap)      # decode_k 1
        before = ttel.counter("k_head_loaded")
        assert tloader.attach_k_head(eng, snap)
        assert ttel.counter("k_head_loaded") == before + 1
        assert eng.k_head["w"].shape == (2, eng.cfg.hidden_size,
                                         eng.cfg.vocab_size)
        tloader.save_k_head(snap, {"w": torch.zeros((2, 8, 8))}, 3)
        eng.k_head = None
        assert not tloader.attach_k_head(eng, snap)          # other width
