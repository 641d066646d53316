"""The port's pooled route and slot ring against the JAX engine.

Setup as in ``tests/test_torch_engine.py`` (``FLAGSHIP_SMALL_GEOMETRY``,
float32, ``random_decoder_params`` carried across by ``params_from_jax``,
the JAX engine as the reference), except for the tokenizer: the port's
``WordTokenizer`` over 500 words, in which every " w<i>" id can be named as
a target.  24 prompts of 5-60 words span the buckets (32, 64).  Per-prompt
(yes, no) targets come from a greedy pre-pass of the port's decoder
(:func:`targets`): a quarter of the rows are decided at position 0, a
quarter resolve in the first look-ahead chunk, a quarter in the second and
a quarter never, so rows retire at different chunks and the ring refills
lanes.

Tolerances: ``scan_found`` identical; probability fields rtol 2e-5 / atol
1e-9 (PARITY.md's fp32 class), w8a8 at ``W8A8_RTOL``; ``occupancy_report()``
and every ``slot_*`` counter (labeled twins included) equal to the JAX
engine's on the same call.  The helpers get the same numpy inputs in both
packages: gathers, pads and blanks are exact, K/V and logits computed by
each package's prefill agree to atol 2e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import random_decoder_params
from test_torch_engine import PROB_FIELDS, RTOL, W8A8_RTOL
from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.ops import quant as jquant
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu.runtime import slots as jslots
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import slots as tslots
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
    WordTokenizer)

WORDS = [f"w{i}" for i in range(500)]
TOK = WordTokenizer(WORDS)
NAMES = {TOK.ids[" " + w]: w for w in WORDS}     # id -> target string
_RNG = np.random.default_rng(0)
PROMPTS = [" ".join(_RNG.choice(WORDS, int(n)))
           for n in _RNG.integers(5, 61, 24)]
BUCKETS = (32, 64)
# the look-ahead steps at which row i's yes target enters the top 5, by
# i % 4: position 0 (decided), the first 5-step chunk, the second, never
ROLE_STEPS = (range(0, 1), range(1, 5), range(5, 10), range(0))
ATOL = 2e-5          # logits and K/V of each package's own prefill


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the machine's cores: one torch thread each
    keeps their thread pools from oversubscribing them (the test model's
    ops gain nothing from more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def models(w8a8=False):
    """(jax cfg, port cfg, jax params, port weights) of the test model."""
    jcfg = jconfig.DecoderConfig(**{**jconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": "flash"})
    tcfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": "flash"})
    params_np = jax.tree_util.tree_map(np.asarray,
                                       random_decoder_params(jcfg, seed=5))
    if w8a8:
        params_np = jquant.quantize_decoder_params_np(params_np)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    weights = convert.params_from_jax(params_np, tcfg, device="cpu",
                                      dtype="fp32")
    return jcfg, tcfg, params, weights


def _encode(prompts):
    enc = [TOK(p)["input_ids"] for p in prompts]
    s = max(map(len, enc))
    ids = np.zeros((len(enc), s), np.int64)
    mask = np.zeros((len(enc), s), np.int32)
    for i, e in enumerate(enc):
        ids[i, :len(e)] = e
        mask[i, :len(e)] = 1
    return ids, mask


@functools.lru_cache(maxsize=None)
def targets(steps=10, top_k=5):
    """Per-prompt (yes, no) target strings from one greedy pass of the
    port's decoder: row i's yes target is a nameable id that first enters
    the top ``top_k`` at a step of ``ROLE_STEPS[i % 4]`` (another role when
    none does), its no target one that never does within the visible
    steps."""
    _, tcfg, _, weights = models()
    ids, mask = _encode(PROMPTS)
    tmask = torch.from_numpy(mask)
    last, cache = tdec.prefill(weights, tcfg, torch.from_numpy(ids), tmask,
                               cache_len=ids.shape[1])
    toks, sc, *_ = tdec.decode_steps(weights, tcfg, cache, last,
                                     tmask.sum(-1), 0, steps,
                                     TOK.eos_token_id, None, with_scores=True)
    top = torch.topk(sc, top_k, dim=-1).indices.numpy()     # [N, steps, k]
    toks = toks.numpy()
    out = []
    for i in range(len(PROMPTS)):
        eos = np.flatnonzero(toks[i] == TOK.eos_token_id)
        visible = steps if not eos.size else int(eos[0]) + 1
        seen = [set(top[i, :k].ravel()) for k in range(steps + 1)]
        never = [t for t in NAMES if t not in seen[visible]]
        yes = next((t for k in ROLE_STEPS[i % 4] if k < visible
                    for t in top[i, k] if t in NAMES and t not in seen[k]),
                   never[1])
        out.append((NAMES[yes], NAMES[never[0]]))
    return tuple(out)


def engines(w8a8=False, **kw):
    """The JAX and the port engine on the same weights and config."""
    jcfg, tcfg, params, weights = models(w8a8)
    kw = {"decode_completions": False, "buckets": BUCKETS, **kw}
    jeng = jengine.ScoringEngine("falcon", jcfg, params, TOK,
                                 engine_config=jengine.EngineConfig(**kw))
    teng = tengine.ScoringEngine("falcon", tcfg, weights, TOK,
                                 engine_config=tengine.EngineConfig(**kw),
                                 device="cpu")
    return jeng, teng


def _slot_counters(tel):
    return {k: v for k, v in tel.counters().items() if k.startswith("slot_")}


def run_both(jcall, tcall):
    """Each call on a cleared counter set: (ref rows, rows, ref slot_*
    counters, slot_* counters)."""
    jtel.clear_counters()
    ref = jcall()
    jc = _slot_counters(jtel)
    ttel.clear_counters()
    got = tcall()
    return ref, got, jc, _slot_counters(ttel)


def assert_rows_match(got, ref, rtol=RTOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"] == ""
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=rtol, atol=1e-9,
                                       err_msg=f)


# -- helpers ---------------------------------------------------------------

def _random_cache(kv, m=5, t=24, seed=0):
    """The same cache in both packages from one numpy draw: fragmented
    valid masks (each row keeps a few valid slots), float32 K/V or int8
    codes with float32 scales."""
    rng = np.random.default_rng(seed)
    L, G, D = 2, 1, 8
    valid = rng.random((m, t)) < 0.5
    valid[:, 0] = True
    positions = np.where(valid, np.cumsum(valid, 1) - 1, 0)
    if kv == "int8":
        k = rng.integers(-127, 128, (L, m, t, G, D)).astype(np.int8)
        v = rng.integers(-127, 128, (L, m, t, G, D)).astype(np.int8)
        ks = rng.random((L, m, t, G)).astype(np.float32)
        vs = rng.random((L, m, t, G)).astype(np.float32)
    else:
        k = rng.standard_normal((L, m, t, G, D)).astype(np.float32)
        v = rng.standard_normal((L, m, t, G, D)).astype(np.float32)
        ks = vs = None
    jc = jdec.KVCache(
        k=jnp.asarray(k), v=jnp.asarray(v),
        positions=jnp.asarray(positions, jnp.int32),
        valid=jnp.asarray(valid), length=jnp.asarray(t, jnp.int32),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    tc = tdec.KVCache(
        k=torch.from_numpy(k), v=torch.from_numpy(v),
        positions=torch.from_numpy(positions.astype(np.int64)),
        valid=torch.from_numpy(valid), length=torch.tensor(t),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs))
    return jc, tc


def assert_caches_equal(tc, jc, atol=None):
    """Same layout and contents: positions and valid identical, K/V
    identical (or within ``atol``), int8 codes and scales identical."""
    assert (tc.k_scale is None) == (jc.k_scale is None)
    for f in ("positions", "valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for f in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(tc, f), getattr(jc, f)
        if a is None:
            continue
        assert tuple(a.shape) == b.shape, f
        if atol is None or a.dtype == torch.int8:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                       err_msg=f)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_select_matches_reference(kv):
    """Prefill, position-0 scan and the undecided-first slice, padded to
    the pool length: ``sel``, positions, valid and lengths identical,
    K/V and logits within atol 2e-5; an int8 cache's scales within rtol
    2e-5 and its codes within one rounding step of each other."""
    jcfg, tcfg, params, weights = models()
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    ids, mask = _encode(PROMPTS[:7])
    ids = np.pad(ids, ((0, 0), (0, 64 - ids.shape[1])))
    mask = np.pad(mask, ((0, 0), (0, 64 - mask.shape[1])))
    valid = np.ones(7, bool)
    valid[-1] = False                                   # a batch pad row
    tgt = np.asarray([[TOK.ids[" " + a], TOK.ids[" " + b]]
                      for a, b in targets()[:7]], np.int64)
    kw = dict(cache_len=64, slice_m=4, top_k=5, top_filter=20, out_len=256)
    jout = jengine._prefill_select(
        params, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.asarray(valid), jnp.asarray(tgt[:, 0], jnp.int32),
        jnp.asarray(tgt[:, 1], jnp.int32), **kw)
    tout = tengine._prefill_select(
        weights, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(valid), torch.from_numpy(tgt[:, 0]),
        torch.from_numpy(tgt[:, 1]), **kw)
    (jscan, jfirst, jsel, jsub, jlast, jlen) = jout
    (tscan, tfirst, tsel, tsub, tlast, tlen) = tout
    np.testing.assert_array_equal(tscan[4].numpy(), np.asarray(jscan[4]))
    assert tscan[4].any() and not tscan[4].all()    # decided and undecided
    for a, b in zip(tscan[:4] + tuple(tfirst), jscan[:4] + tuple(jfirst)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-9)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)
    assert tsub.k.shape[2] == 256 and not tsub.valid[:, 64:].any()
    assert not tsub.k[:, :, 64:].any()
    if kv == "bf16":
        assert_caches_equal(tsub, jsub, atol=ATOL)
        return
    for f in ("positions", "valid"):
        np.testing.assert_array_equal(getattr(tsub, f).numpy(),
                                      np.asarray(getattr(jsub, f)), err_msg=f)
    for f in ("k", "v"):
        codes, scale = getattr(tsub, f).numpy(), getattr(tsub, f + "_scale")
        jcodes, jscale = np.asarray(getattr(jsub, f)), getattr(jsub, f + "_scale")
        np.testing.assert_allclose(scale.numpy(), np.asarray(jscale),
                                   rtol=RTOL, err_msg=f)
        # a K/V value the two packages compute within float32 noise of a
        # rounding boundary takes neighbouring codes ("a flip"): 2 of
        # 131,072 codes at this seed
        step = np.abs(codes.astype(np.int32) - jcodes.astype(np.int32))
        assert step.max() <= 1 and step.mean() < 1e-4, f
        same = step == 0
        np.testing.assert_allclose(
            (codes * scale.numpy()[..., None])[same],
            np.asarray(jquant.dequantize_kv(jcodes, jscale, jnp.float32))[same],
            atol=ATOL, err_msg=f)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("extra", [2, 40])
def test_compact_cache_slots_matches_reference(kv, extra):
    """Valid slots first, in order; ``out_len`` past the slot axis keeps
    the axis as it is."""
    jc, tc = _random_cache(kv)
    out_len = int(np.asarray(jc.valid).sum(1).max()) + extra
    assert_caches_equal(tslots._compact_cache_slots(tc, out_len),
                        jslots._compact_cache_slots(jc, out_len))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_pad_cache_to_matches_reference(kv):
    jc, tc = _random_cache(kv)
    got = tslots._pad_cache_to(tc, 40)
    assert got.k.shape[2] == 40 and not got.valid[:, 24:].any()
    assert_caches_equal(got, jslots._pad_cache_to(jc, 40))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_blank_rows_match_reference(kv):
    """One valid zero slot per blank lane (zero codes under unit scales for
    int8), zero logits, length 1."""
    jc, tc = _random_cache(kv)
    last = np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32)
    jb = jslots._blank_rows(jc, jnp.asarray(last), jnp.int32, 3, 30)
    tb = tslots._blank_rows(tc, torch.from_numpy(last), torch.int64, 3, 30)
    assert_caches_equal(tb[0], jb[0])
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
    np.testing.assert_array_equal(tb[2].numpy(), np.asarray(jb[2]))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_concat_caches_match_reference(kv):
    parts = [_random_cache(kv, m=m, seed=s) for s, m in enumerate((2, 3, 1))]
    assert_caches_equal(tslots._concat_caches([p[1] for p in parts]),
                        jslots._concat_caches([p[0] for p in parts]))


@pytest.mark.parametrize("row_steps,capacity", [
    ([10, 5, 5, 10, 5], 2),
    ([5] * 9, 4),
    ([10, 10, 5, 10, 5, 5, 10], 3),
    ([], 4),
])
def test_occupancy_stats_match_reference(row_steps, capacity):
    kw = dict(capacity=capacity, rows=len(row_steps),
              capacity_steps=capacity * 10 * max(1, len(row_steps)),
              live_steps=sum(row_steps), refills=2, repacks=3, compactions=1,
              repack_stalls=1)
    got = tslots.OccupancyStats(row_steps=list(row_steps), **kw)
    ref = jslots.OccupancyStats(row_steps=list(row_steps), **kw)
    assert got.report() == ref.report()
    assert got.no_repack_idle_fraction() == ref.no_repack_idle_fraction()
    merged = tslots.merge_occupancy([got, got])
    assert merged.report() == jslots.merge_occupancy([ref, ref]).report()


# -- engine rows -----------------------------------------------------------

@pytest.mark.parametrize("ecfg", [
    dict(batch_size=4),
    dict(batch_size=4, slot_repack=False),
    # a batch of 16 holds more undecided rows than the 8-row slice
    dict(batch_size=16, phase2_select_slice=8, phase2_pool_target=4),
    dict(batch_size=16, slot_repack=False),
    # full [m, P, V] scores on the whole-flush decode (the ring keeps only
    # ReducedScores: see test_ring_refuses_top_k_past_reduced_scores)
    dict(batch_size=16, top_k=600, slot_repack=False),
    dict(batch_size=4, phase2_pool_target=2),
    dict(batch_size=4, slot_repack=False, phase2_pool_max_bytes=1),
], ids=["ring-b4", "flush-b4", "ring-b16-overflow", "flush-b16",
        "flush-topk600", "refills", "early-flush"])
def test_pooled_rows_match_reference(monkeypatch, ecfg):
    """``phase2_pool=True``: rows, ``occupancy_report()`` and the
    ``slot_*`` counters equal to the JAX engine's, with the route's
    schedule shown to have run (refills, overflow batches, early
    flushes)."""
    jeng, teng = engines(**ecfg)
    calls = {"overflow": 0, "flush": 0}
    real_overflow = tengine.ScoringEngine._score_overflow_batch
    real_flush = tengine._Phase2Pool.flush

    def overflow(self, *a, **k):
        calls["overflow"] += 1
        return real_overflow(self, *a, **k)

    def flush(self, *a, **k):
        calls["flush"] += 1
        return real_flush(self, *a, **k)

    monkeypatch.setattr(tengine.ScoringEngine, "_score_overflow_batch",
                        overflow)
    monkeypatch.setattr(tengine._Phase2Pool, "flush", flush)
    ref, got, jc, tc = run_both(
        lambda: jeng.score_prompts(PROMPTS, list(targets())),
        lambda: teng.score_prompts(PROMPTS, list(targets())))
    assert_rows_match(got, ref)
    assert 0 < sum(r["scan_found"] for r in got) < len(PROMPTS)
    occ = teng.occupancy_report()
    assert occ == jeng.occupancy_report()
    assert tc == jc
    if ecfg.get("slot_repack", True):
        assert occ["rows"] > 0 and tc["slot_rows|leg=binary,workload=engine"]
    else:
        assert occ is None and not tc and calls["flush"] > 0
    if ecfg.get("phase2_pool_target") == 2:
        assert occ["refills"] > 0
    if ecfg["batch_size"] == 16 and "top_k" not in ecfg:
        assert calls["overflow"] > 0        # > 8 undecided rows in a batch
    if ecfg.get("phase2_pool_max_bytes") == 1:
        assert calls["flush"] >= 4           # one per batch, not per target


@pytest.mark.parametrize("kv,repack,n", [("bf16", False, 24),
                                         ("int8", True, 12)])
def test_pooled_w8a8_rows_match_reference(kv, repack, n):
    """w8a8 weights with a bf16 KV cache (whole flushes) or an int8 one
    (the ring, whose blanks, pads and gathers carry the scales): verdicts
    and the schedule identical, probabilities within the
    activation-rounding flip tolerance."""
    jeng, teng = engines(w8a8=True, batch_size=4, kv_dtype=kv,
                         slot_repack=repack)
    ref, got, jc, tc = run_both(
        lambda: jeng.score_prompts(PROMPTS[:n], list(targets()[:n])),
        lambda: teng.score_prompts(PROMPTS[:n], list(targets()[:n])))
    assert_rows_match(got, ref, rtol=W8A8_RTOL)
    assert teng.occupancy_report() == jeng.occupancy_report()
    assert tc == jc


def test_ring_refuses_top_k_past_reduced_scores():
    """The ring keeps only ReducedScores (19 candidates): ``top_k`` beyond
    them raises in both packages."""
    jeng, teng = engines(batch_size=4, top_k=600)
    with pytest.raises(ValueError, match="kept candidates"):
        jeng.score_prompts(PROMPTS[:6], list(targets()[:6]))
    with pytest.raises(ValueError, match="kept candidates"):
        teng.score_prompts(PROMPTS[:6], list(targets()[:6]))


# -- the serve-side ring entries --------------------------------------------

def _halves():
    half = len(PROMPTS) // 2
    tg = list(targets())
    return (PROMPTS[:half], tg[:half]), (PROMPTS[half:], tg[half:])


def _admit_once(more):
    """An ``admit_fn`` that hands over ``more`` at its first call."""
    pending = [more]
    return lambda: pending.pop() if pending else None


@pytest.mark.parametrize("admit", [False, True])
def test_slotted_rows_match_reference(admit):
    """``score_prompts_slotted``, with the second half of the prompts
    admitted mid-decode or not: rows, occupancy and counters equal to the
    JAX engine's."""
    jeng, teng = engines(batch_size=4)
    (p1, t1), (p2, t2) = _halves()
    if admit:
        ref, got, jc, tc = run_both(
            lambda: jeng.score_prompts_slotted(
                p1, t1, admit_fn=_admit_once((p2, t2))),
            lambda: teng.score_prompts_slotted(
                p1, t1, admit_fn=_admit_once((p2, t2))))
        assert tc["slot_admitted|leg=binary,workload=serve"] == len(p2)
    else:
        ref, got, jc, tc = run_both(
            lambda: jeng.score_prompts_slotted(PROMPTS, list(targets())),
            lambda: teng.score_prompts_slotted(PROMPTS, list(targets())))
    assert_rows_match(got, ref)
    assert teng.occupancy_report() == jeng.occupancy_report()
    assert tc == jc


def _merge(results, slabs, decoded, base=0):
    """Decode-side rows (flat feed order) back onto prompt indices."""
    merged = list(results)
    i = 0
    for slab in slabs:
        for m in slab.metas:
            merged[base + m["orig"]] = decoded[i]
            i += 1
    return merged


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_kv_slab_round_trip_bit_identical(kv):
    """Export then decode on the same engine: rows bit-identical to its own
    slotted rows.  A slab holds CPU tensors in the cache's dtypes (int8
    codes with their scales)."""
    _, teng = engines(batch_size=4, kv_dtype=kv)
    want = teng.score_prompts_slotted(PROMPTS, list(targets()))
    ttel.clear_counters()
    results, slabs = teng.export_kv_slab(PROMPTS, list(targets()))
    assert slabs and all(s.rows() > 0 and s.nbytes() > 0 for s in slabs)
    for s in slabs:
        assert s.k.device.type == "cpu"
        assert s.k.dtype == (torch.int8 if kv == "int8" else torch.float32)
        assert (s.k_scale is not None) == (kv == "int8")
    decoded = teng.decode_kv_slabs(slabs)
    n = sum(s.rows() for s in slabs)
    assert len(decoded) == n
    c = ttel.counters()
    assert c["slot_slab_export_rows"] == c["slot_slab_import_rows"] == n
    assert c["slab_export_bytes"] == sum(s.nbytes() for s in slabs)
    assert _merge(results, slabs, decoded) == want


def test_kv_slab_admission_matches_slotted_admission():
    """Slabs exported half by half and the second half admitted mid-decode
    give the rows of ``score_prompts_slotted`` admitting the second half's
    prompts at the same point, bit for bit (the card run's check of the
    two serve-side entries)."""
    _, teng = engines(batch_size=4)
    (p1, t1), (p2, t2) = _halves()
    want = teng.score_prompts_slotted(p1, t1, admit_fn=_admit_once((p2, t2)))
    r1, s1 = teng.export_kv_slab(p1, t1)
    r2, s2 = teng.export_kv_slab(p2, t2)
    decoded = teng.decode_kv_slabs(s1, admit_fn=_admit_once(s2))
    n1 = sum(s.rows() for s in s1)
    got = (_merge(r1, s1, decoded[:n1])
           + _merge(r2, s2, decoded[n1:]))
    assert got == want


def _ring_parts(jeng, teng, n=8):
    """One batch of ``n`` prompts through each package's
    ``_prefill_select`` (every row kept, undecided first): (jax parts, port
    parts, target ids, metas) to feed a ring with."""
    ids, mask = _encode(PROMPTS[:n])
    ids = np.pad(ids, ((0, 0), (0, 64 - ids.shape[1])))
    mask = np.pad(mask, ((0, 0), (0, 64 - mask.shape[1])))
    tgt = np.asarray([[TOK.ids[" " + a], TOK.ids[" " + b]]
                      for a, b in targets()[:n]], np.int64)
    kw = dict(cache_len=64, slice_m=n, top_k=5, top_filter=20)
    _, _, jsel, jsub, jlast, jlen = jengine._prefill_select(
        jeng.params, jeng.cfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.ones(n, bool), jnp.asarray(tgt[:, 0], jnp.int32),
        jnp.asarray(tgt[:, 1], jnp.int32), **kw)
    _, _, tsel, tsub, tlast, tlen = tengine._prefill_select(
        teng.params, teng.cfg, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.ones(n, dtype=torch.bool), torch.from_numpy(tgt[:, 0]),
        torch.from_numpy(tgt[:, 1]), **kw)
    sel = tsel.numpy()
    np.testing.assert_array_equal(sel, np.asarray(jsel))
    return (jsub, jlast, jlen), (tsub, tlast, tlen), tgt[sel], sel


def _drive_ring(mod, engine, parts, gather, row_ids, sel, **kw):
    """Feed the first three rows, crank, feed the rest, drain.  Rows retire
    at the first step past ``min_check`` whose token is even (a pure
    function of the row's own tokens).  Returns (retired rows as (prompt,
    retire step, tokens), occupancy report)."""
    out = []
    min_check = kw.get("min_check", 1)

    def retire(row):
        for k in range(max(row.checked + 1, min_check), row.decoded + 1):
            if row.toks[k - 1] % 2 == 0:
                return k
        return -1

    ring = mod.SlotRing(
        engine, steps=10, eos_id=TOK.eos_token_id, capacity=3, leg="binary",
        workload="engine", retire=retire, pad_slice=lambda m: m + 1,
        emit=lambda rows: out.extend(
            (int(r.meta["orig"]), r.retire_step, r.toks[:r.decoded].tolist())
            for r in rows), **kw)
    metas = [{"orig": int(s)} for s in sel]
    cache, last, lens = parts
    for lo, hi in ((0, 3), (3, len(sel))):
        idx = gather(np.arange(lo, hi))
        ring.feed(mod._gather_ring_rows(cache, idx), last[idx], lens[idx],
                  row_ids[lo:hi], metas[lo:hi])
        ring.pump(drain=False)
    ring.drain()
    return out, ring.stats.report()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(refill=False),
    dict(with_scores=False, min_check=3),
    dict(chunk=2, compact_slack=4),
], ids=["default", "no-refill", "no-scores", "compacting"])
def test_slot_ring_matches_reference(kw):
    """The ring driven directly, with the reference's constructor options:
    retired rows (retirement step and tokens), their order and the
    occupancy report equal the JAX ring's; one blank lane pads every
    repack (``pad_slice``)."""
    jeng, teng = engines(batch_size=8)
    jparts, tparts, row_ids, sel = _ring_parts(jeng, teng)
    ref = _drive_ring(jslots, jeng, jparts, jnp.asarray, row_ids, sel, **kw)
    got = _drive_ring(tslots, teng, tparts, torch.from_numpy, row_ids, sel,
                      **kw)
    assert got == ref
    assert len(got[0]) == len(sel)
    if "compact_slack" in kw:
        assert got[1]["compactions"] > 0
