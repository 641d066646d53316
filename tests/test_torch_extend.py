"""The fused prefix-reuse path's device half against the JAX package:
``ops.attention.cache_extend_attention``, ``models.decoder.extend_prefill``
and the suffix batching helpers.

Model and numbers: ``FLAGSHIP_SMALL_GEOMETRY`` in float32 with the seed-5
weights of ``tests/test_torch_slots.py`` (so "bf16" below names the
unquantized cache layout, held in the weights' float32); the same numpy
inputs go into both packages.  Logits, K/V and attention outputs agree to
atol 2e-5; positions, validity and lengths are identical; an int8 cache's
scales agree to rtol 2e-5 and its codes within one rounding step (a value
the two packages compute within float32 noise of a rounding boundary takes
neighbouring codes).  Inside the port, prefix prefill plus suffix extension
gives the full prompt's prefill: last logits atol 2e-5, greedy tokens after
it identical.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.runtime import batching as jbatching
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import batching
from test_torch_slots import (ATOL, TOK, assert_caches_equal, models,
                              one_torch_thread)  # noqa: F401

# each ``ops`` package also exports a function named ``attention``
jattn = importlib.import_module("llm_interpretation_replication_tpu.ops.attention")
tattn = importlib.import_module(
    "llm_interpretation_replication_tpu_torch.ops.attention")

RTOL = 2e-5
PREFIX_LEN, SUFFIX_LEN = 40, 16


def _kv_cfgs(kv):
    jcfg, tcfg, params, weights = models()
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv),
            dataclasses.replace(tcfg, kv_cache_dtype=kv), params, weights)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("heads", [(8, 1), (8, 2), (4, 4)])
def test_cache_extend_attention_matches_reference(kv, heads):
    """Random q, prefix and suffix K/V and a causal + padding bias over the
    concatenated keys; an int8 prefix goes in as codes and scales."""
    n, g = heads
    b, t, s, d = 3, 12, 5, 8
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, s, n, d)).astype(np.float32)
    kt = rng.standard_normal((b, s, g, d)).astype(np.float32)
    vt = rng.standard_normal((b, s, g, d)).astype(np.float32)
    if kv == "int8":
        kp = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
        ks = (rng.random((b, t, g)) / 127).astype(np.float32)
        vs = (rng.random((b, t, g)) / 127).astype(np.float32)
    else:
        kp = rng.standard_normal((b, t, g, d)).astype(np.float32)
        vp = rng.standard_normal((b, t, g, d)).astype(np.float32)
        ks = vs = None
    plen = np.array([t, 7, 1])
    kv_pos = np.concatenate([np.broadcast_to(np.arange(t), (b, t)),
                             plen[:, None] + np.arange(s)], axis=1)
    kv_valid = np.concatenate([np.arange(t)[None] < plen[:, None],
                               np.ones((b, s), bool)], axis=1)
    q_pos = plen[:, None] + np.arange(s)
    ok = (q_pos[:, :, None] >= kv_pos[:, None, :]) & kv_valid[:, None, :]
    bias = np.where(ok, 0.0, -1e9).astype(np.float32)[:, None]
    want = jattn.cache_extend_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, kt, vt, bias)),
        kp_scale=None if ks is None else jnp.asarray(ks),
        vp_scale=None if vs is None else jnp.asarray(vs))
    got = tattn.cache_extend_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, kt, vt, bias)),
        kp_scale=None if ks is None else torch.from_numpy(ks),
        vp_scale=None if vs is None else torch.from_numpy(vs))
    assert got.shape == (b, s, n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _streams(seed=11, b=5):
    """Right-padded prefix ([b, PREFIX_LEN]) and suffix ([b, SUFFIX_LEN])
    token ids and masks from a numpy seed, ragged on both sides."""
    rng = np.random.default_rng(seed)
    vocab = len(TOK)
    out = []
    for width, lo in ((PREFIX_LEN, 3), (SUFFIX_LEN, 1)):
        lens = rng.integers(lo, width + 1, b)
        lens[0] = width
        ids = np.zeros((b, width), np.int64)
        mask = np.zeros((b, width), np.int32)
        for i, n in enumerate(lens):
            ids[i, :n] = rng.integers(3, vocab, n)
            mask[i, :n] = 1
        out += [ids, mask]
    return out


def _assert_int8_close(tc, jc):
    """Codes within one rounding step, scales within rtol 2e-5, positions
    and validity identical."""
    for f in ("positions", "valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for f in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, f + "_scale").numpy(),
                                   np.asarray(getattr(jc, f + "_scale")),
                                   rtol=RTOL, err_msg=f)
        step = np.abs(getattr(tc, f).numpy().astype(np.int32)
                      - np.asarray(getattr(jc, f)).astype(np.int32))
        assert step.max() <= 1 and step.mean() < 1e-3, f


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_extend_prefill_matches_reference(kv):
    """Each package prefills the prefixes, then extends its own cache with
    the suffixes: last logits, the extended cache and total lengths."""
    jcfg, tcfg, params, weights = _kv_cfgs(kv)
    pids, pmask, sids, smask = _streams()
    jl, jc = jdec.prefill(params, jcfg, jnp.asarray(pids, jnp.int32),
                          jnp.asarray(pmask), cache_len=PREFIX_LEN)
    tl, tc = tdec.prefill(weights, tcfg, torch.from_numpy(pids),
                          torch.from_numpy(pmask), cache_len=PREFIX_LEN)
    jlast, jcache, jlen = jdec.extend_prefill(
        params, jcfg, jc, jnp.asarray(sids, jnp.int32), jnp.asarray(smask),
        jnp.sum(jnp.asarray(pmask), -1))
    tlast, tcache, tlen = tdec.extend_prefill(
        weights, tcfg, tc, torch.from_numpy(sids), torch.from_numpy(smask),
        torch.from_numpy(pmask).sum(-1))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tcache.k.shape[2] == PREFIX_LEN + SUFFIX_LEN
    assert int(tcache.length) == int(jcache.length)
    if kv == "bf16":
        assert_caches_equal(tcache, jcache, atol=ATOL)
    else:
        _assert_int8_close(tcache, jcache)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_extend_prefill_refuses_a_cache_of_the_other_storage(kv):
    _, tcfg, _, weights = _kv_cfgs(kv)
    other = dataclasses.replace(tcfg, kv_cache_dtype="int8" if kv == "bf16"
                                else "bf16")
    pids, pmask, sids, smask = _streams()
    _, cache = tdec.prefill(weights, other, torch.from_numpy(pids),
                            torch.from_numpy(pmask), cache_len=PREFIX_LEN)
    with pytest.raises(ValueError, match="cache quantization"):
        tdec.extend_prefill(weights, tcfg, cache, torch.from_numpy(sids),
                            torch.from_numpy(smask),
                            torch.from_numpy(pmask).sum(-1))


def test_fused_matches_full_prompt_prefill():
    """Prefix prefill + suffix extension against one prefill of the joined
    prompt, inside the port: the same last logits, and a greedy decode from
    either cache gives the same tokens."""
    _, tcfg, _, weights = models()
    pids, pmask, sids, smask = _streams(seed=12)
    b = pids.shape[0]
    plen, slen = pmask.sum(1), smask.sum(1)
    full = np.zeros((b, PREFIX_LEN + SUFFIX_LEN), np.int64)
    fmask = np.zeros_like(full, dtype=np.int32)
    for i in range(b):
        row = np.concatenate([pids[i, :plen[i]], sids[i, :slen[i]]])
        full[i, :len(row)] = row
        fmask[i, :len(row)] = 1
    _, pc = tdec.prefill(weights, tcfg, torch.from_numpy(pids),
                         torch.from_numpy(pmask), cache_len=PREFIX_LEN)
    flast, fcache, flen = tdec.extend_prefill(
        weights, tcfg, pc, torch.from_numpy(sids), torch.from_numpy(smask),
        torch.from_numpy(pmask).sum(-1))
    ulast, ucache = tdec.prefill(weights, tcfg, torch.from_numpy(full),
                                 torch.from_numpy(fmask),
                                 cache_len=full.shape[1])
    ulen = torch.from_numpy(fmask).sum(-1)
    np.testing.assert_array_equal(flen.numpy(), ulen.numpy())
    np.testing.assert_allclose(flast.numpy(), ulast.numpy(), atol=ATOL)
    ftoks = tdec.decode_steps(weights, tcfg, fcache, flast, flen, 0, 6,
                              None, None, with_scores=False)[0]
    utoks = tdec.decode_steps(weights, tcfg, ucache, ulast, ulen, 0, 6,
                              None, None, with_scores=False)[0]
    np.testing.assert_array_equal(ftoks.numpy(), utoks.numpy())


@pytest.mark.parametrize("length", [0, 1, 8, 9, 24, 25, 64, 65, 130])
def test_suffix_bucket_for_matches_reference(length):
    assert batching.SUFFIX_BUCKETS == jbatching.SUFFIX_BUCKETS
    assert batching.suffix_bucket_for(length) == \
        jbatching.suffix_bucket_for(length)


def test_encode_prefix_pairs_matches_reference():
    pairs = [("w1 w2 w3", (" w4", " w5 w6")), ("w7", (" w4", [9, 10])),
             ([3, 4, 5], ("w8 w9", " w5 w6"))]
    assert batching.encode_prefix_pairs(TOK, pairs) == \
        jbatching.encode_prefix_pairs(TOK, pairs)
    with pytest.raises(ValueError, match="suffixes"):
        batching.encode_prefix_pairs(TOK, pairs + [("w1", (" w2",))])
