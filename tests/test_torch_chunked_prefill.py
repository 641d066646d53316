"""Chunked prefill in the port against the JAX package:
``models.decoder.chunked_prefill`` and the engine's ``prefill_chunk``
setting on each route that prefills through ``ScoringEngine._prefill``.

Model and numbers: ``FLAGSHIP_SMALL_GEOMETRY`` in float32 with the seed-5
weights of ``tests/test_torch_slots.py``; the same numpy inputs go into
both packages.  Classes: last logits and the unquantized cache atol 2e-5,
positions, validity and ``n_chunks`` identical; an int8 cache's scales rtol
2e-5 and codes within one rounding step (``tests/test_torch_extend.py``).
Engine rows: ``scan_found``, completions and first-integer parses
identical, probabilities and weighted confidence rtol 2e-5 (atol 1e-9), the
``prefill_chunks`` counter equal to the JAX engine's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from test_torch_extend import _assert_int8_close
from test_torch_slots import (ATOL, PROMPTS, TOK, assert_caches_equal,
                              engines, models, one_torch_thread,  # noqa: F401
                              targets)

RTOL = 2e-5
S = 64
# ragged rows: full, ending inside chunk 0 of 16, in a later chunk, on a
# chunk boundary, and a single token
LENGTHS = (64, 7, 37, 48, 1)
PROB_FIELDS = ("yes_prob", "no_prob", "relative_prob", "odds_ratio",
               "first_token_yes_prob", "first_token_no_prob",
               "first_token_relative_prob")


def _stream(seed=21):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(LENGTHS), S), np.int64)
    mask = np.zeros((len(LENGTHS), S), np.int32)
    for i, n in enumerate(LENGTHS):
        ids[i, :n] = rng.integers(3, len(TOK), n)
        mask[i, :n] = 1
    return ids, mask


# chunks below a bucket, one that does not divide it, equal to it and above
@pytest.mark.parametrize("chunk", [16, 20, 64, 80])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_chunked_prefill_matches_reference(chunk, kv):
    jcfg, tcfg, params, weights = models()
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    ids, mask = _stream()
    jlast, jcache, jn = jdec.chunked_prefill(
        params, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask), chunk)
    tlast, tcache, tn = tdec.chunked_prefill(
        weights, tcfg, torch.from_numpy(ids), torch.from_numpy(mask), chunk)
    assert tn == jn == -(-S // chunk)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)
    assert tcache.k.shape[2] == S
    assert int(tcache.length) == int(jcache.length)
    if kv == "bf16":
        assert_caches_equal(tcache, jcache, atol=ATOL)
    else:
        _assert_int8_close(tcache, jcache)


@pytest.mark.parametrize("chunk", [16, 20])
def test_chunked_prefill_matches_monolithic(chunk):
    """Inside the port: the chunked replay gives the monolithic prefill's
    last logits, validity and valid slots' positions and K/V, and a greedy
    decode from either cache the same tokens."""
    _, tcfg, _, weights = models()
    ids, mask = _stream()
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    clast, ccache, _ = tdec.chunked_prefill(weights, tcfg, tids, tmask, chunk)
    mlast, mcache = tdec.prefill(weights, tcfg, tids, tmask, cache_len=S)
    np.testing.assert_allclose(clast.numpy(), mlast.numpy(), atol=ATOL)
    valid = mcache.valid.numpy()
    np.testing.assert_array_equal(ccache.valid.numpy(), valid)
    np.testing.assert_array_equal(ccache.positions.numpy()[valid],
                                  mcache.positions.numpy()[valid])
    for f in ("k", "v"):
        np.testing.assert_allclose(getattr(ccache, f).numpy()[:, valid],
                                   getattr(mcache, f).numpy()[:, valid],
                                   atol=ATOL)
    lengths = tmask.sum(-1)
    ctoks = tdec.decode_steps(weights, tcfg, ccache, clast, lengths, 0, 6,
                              None, None, with_scores=False)[0]
    mtoks = tdec.decode_steps(weights, tcfg, mcache, mlast, lengths, 0, 6,
                              None, None, with_scores=False)[0]
    np.testing.assert_array_equal(ctoks.numpy(), mtoks.numpy())


def _assert_rows_match(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"]
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=RTOL, atol=1e-9,
                                       err_msg=f)
        if "weighted_confidence" in r:
            assert (g["weighted_confidence"] is None) == \
                (r["weighted_confidence"] is None)
            if r["weighted_confidence"] is not None:
                np.testing.assert_allclose(g["weighted_confidence"],
                                           r["weighted_confidence"],
                                           rtol=RTOL)


PAIRS = [(p, (" w1 w2 w3 w4 w5", " w6 w7 w8")) for p in PROMPTS[:10]]
ROUTES = {
    # per batch, with completions: every row greedy-decodes from the cache
    "per_batch": (dict(batch_size=4, phase2_pool=False,
                       decode_completions=True, max_new_tokens=12),
                  lambda e, mod: e.score_prompts(PROMPTS, list(targets()))),
    # one prefix prefill a batch, both legs as suffix extensions
    "prefixed": (dict(batch_size=4, decode_completions=True,
                      max_new_tokens=12),
                 lambda e, mod: e.score_prefixed(
                     PAIRS, list(targets())[:len(PAIRS)],
                     legs=[mod.LegSpec("binary"),
                           mod.LegSpec("confidence", with_confidence=True,
                                       max_new_tokens=5)])),
    # the pooled route: a batch of 16 holds more undecided rows than the
    # 8-row slice and prefills again through the overflow route
    "pooled": (dict(batch_size=16, phase2_select_slice=8,
                    phase2_pool_target=4),
               lambda e, mod: e.score_prompts(PROMPTS, list(targets()))),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("chunk", [16, 48])
def test_engine_rows_with_prefill_chunk_match_reference(monkeypatch, route,
                                                        chunk):
    """``prefill_chunk`` below both buckets (32 and 64 replay in 2 and 4
    chunks) and between them (only bucket 64 replays, in 2)."""
    kw, call = ROUTES[route]
    jeng, teng = engines(prefill_chunk=chunk, **kw)
    chunked = []
    real = tdec.chunked_prefill
    monkeypatch.setattr(tdec, "chunked_prefill",
                        lambda *a: chunked.append(a[-1]) or real(*a))
    jtel.clear_counters()
    ref = call(jeng, jengine)
    ttel.clear_counters()
    got = call(teng, tengine)
    if route == "prefixed":
        for g, r in zip(got, ref):
            _assert_rows_match(g, r)
    else:
        _assert_rows_match(got, ref)
    n = ttel.counter("prefill_chunks")
    assert chunked and set(chunked) == {chunk}
    assert n == jtel.counters().get("prefill_chunks", 0) > 0
