"""The slice as a whole: the port's ScoringEngine against the JAX engine.

Both engines take the same tiny Falcon-architecture model (float32), the
same ``build_test_tokenizer`` and ``EngineConfig(decode_completions=False,
phase2_pool=False)``, with prompts of mixed lengths over two buckets.
``scan_found`` must be identical; the probability fields match to rtol 2e-5
(the fp32 class of PARITY.md) with an absolute floor of 1e-9 for
probabilities near zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from helpers import build_test_tokenizer, random_decoder_params
from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.ops import quant as jquant
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine

RTOL, ATOL = 2e-5, 1e-9
PROB_FIELDS = ("yes_prob", "no_prob", "relative_prob", "odds_ratio",
               "first_token_yes_prob", "first_token_no_prob",
               "first_token_relative_prob")

PROMPTS = (
    [f"Is soup a beverage? Answer {i}:" for i in range(5)]
    + [f"The quick brown fox jumps over the lazy dog {i} times. Is a tweet "
       f"a publication? Yes or No. Answer:" for i in range(6)]
)
ENGINE_KW = dict(decode_completions=False, phase2_pool=False, buckets=(32, 64))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's tests (as in
    ``tests/test_torch_slots.py``): the test workers share the machine's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    tok = build_test_tokenizer()
    lengths = {len(tok(p)["input_ids"]) for p in PROMPTS}
    assert min(lengths) <= 32 < max(lengths) <= 64     # two buckets
    return tok


def _engines(tok, impl, w8a8=False, **ecfg):
    jcfg = jconfig.DecoderConfig(**{**jconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": impl})
    tcfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": impl})
    params_np = jax.tree_util.tree_map(np.asarray,
                                       random_decoder_params(jcfg, seed=5))
    if w8a8:
        params_np = jquant.quantize_decoder_params_np(params_np)
    params = jax.tree_util.tree_map(jax.numpy.asarray, params_np)
    weights = convert.params_from_jax(params_np, tcfg, device="cpu",
                                      dtype="fp32")
    kw = {**ENGINE_KW, **ecfg}
    jeng = jengine.ScoringEngine("falcon", jcfg, params, tok,
                                 engine_config=jengine.EngineConfig(**kw))
    teng = tengine.ScoringEngine("falcon", tcfg, weights, tok,
                                 engine_config=tengine.EngineConfig(**kw),
                                 device="cpu")
    return jeng, teng


def _assert_rows_match(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"] == ""
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=RTOL, atol=ATOL,
                                       err_msg=f)


@pytest.mark.parametrize("impl,ecfg", [
    ("xla", dict(batch_size=4)),
    ("flash", dict(batch_size=4)),
    # a wide top-k decides most rows at position 0, so the look-ahead runs
    # on a gathered, menu-padded subset -- and on full scores (top_k > 19)
    ("flash", dict(batch_size=16, top_k=600, length_sorted_batches=False)),
])
def test_engine_rows_match_reference(setup, monkeypatch, impl, ecfg):
    tok = setup
    jeng, teng = _engines(tok, impl, **ecfg)
    gathered = []
    real_gather = tengine._gather_rows
    monkeypatch.setattr(tengine, "_gather_rows",
                        lambda *a: gathered.append(1) or real_gather(*a))
    ref = jeng.score_prompts(list(PROMPTS))
    got = teng.score_prompts(list(PROMPTS))
    _assert_rows_match(got, ref)
    found = [r["scan_found"] for r in got]
    if ecfg["batch_size"] == 16:
        assert gathered and any(found)
    else:
        assert not gathered


# w8a8 rows: PARITY.md's fp32 class (rtol 2e-5) does not hold at any seed
# tried (3 to 6).  The two packages' float32 LayerNorm, GELU and softmax
# differ in the last bit, so an activation within that bit of a rounding
# boundary takes neighbouring int8 codes ("a flip"; tests/test_torch_decoder.py
# says how it spreads).  Measured on these prompts: probabilities up to 1.45e-3
# apart, 5.8e-3 relative.  Scan verdicts stay identical; the probability
# fields are held to rtol 2e-2 (~3x the measured gap).
W8A8_RTOL = 2e-2


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ecfg", [
    dict(batch_size=4),
    dict(batch_size=16, top_k=600, length_sorted_batches=False),
])
def test_engine_w8a8_rows_match_reference(setup, monkeypatch, kv, ecfg):
    """w8a8 weights with a bf16 or an int8 KV cache: ``kv_dtype`` lands on
    the decoder config and the look-ahead decodes from a cache of that
    storage, as in the reference engine."""
    tok = setup
    jeng, teng = _engines(tok, "flash", w8a8=True, kv_dtype=kv, **ecfg)
    assert teng.cfg.kv_cache_dtype == jeng.cfg.kv_cache_dtype == kv
    seen = []
    real_decode = tengine.dmod.decode_steps
    monkeypatch.setattr(tengine.dmod, "decode_steps", lambda p, c, cache, *a, **k:
                        seen.append(cache.k.dtype) or real_decode(p, c, cache, *a, **k))
    ref = jeng.score_prompts(list(PROMPTS))
    got = teng.score_prompts(list(PROMPTS))
    assert seen and set(seen) == {torch.int8 if kv == "int8" else torch.float32}
    assert [g["scan_found"] for g in got] == [r["scan_found"] for r in ref]
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=W8A8_RTOL, atol=ATOL,
                                       err_msg=f)


def test_engine_per_prompt_targets_and_tokenized_prompts(setup):
    """Per-prompt (yes, no) pairs and pre-tokenized prompts, as the sweep
    shells pass them."""
    tok = setup
    jeng, teng = _engines(tok, "flash", batch_size=4)
    prompts = [tok(p)["input_ids"] for p in PROMPTS[:6]]
    targets = [("Yes", "No"), ("No", "Yes")] * 3
    _assert_rows_match(teng.score_prompts(prompts, targets),
                       jeng.score_prompts(prompts, targets))


@pytest.mark.parametrize("override", [
    dict(prefill_chunk=1),
    dict(prefill_chunk=32),
    dict(decode_k=2),
])
def test_unsupported_engine_settings_raise(setup, override):
    """Settings the port once refused, each run now: ``prefill_chunk`` since
    the chunked-prefill slice (set at construction or afterwards, the rows
    match the JAX engine's at the same setting: one-token chunks on the
    prompts of the 32 bucket, and 32 on all, below the 64 bucket), and
    ``decode_k > 1`` since the K-decode slice (with no K-head set, the
    decode runs sequentially and the rows match the JAX engine's at the
    same setting)."""
    tok = setup
    prompts = list(PROMPTS[:5] if override.get("prefill_chunk") == 1
                   else PROMPTS)
    jeng, teng = _engines(tok, "flash", batch_size=4, **override)
    ref = jeng.score_prompts(prompts)
    _assert_rows_match(teng.score_prompts(prompts), ref)
    _, eng = _engines(tok, "flash", batch_size=4)
    eng.ecfg = dataclasses.replace(eng.ecfg, **override)
    _assert_rows_match(eng.score_prompts(prompts), ref)


@pytest.mark.parametrize("case", ["confidence", "pooled_confidence",
                                  "prefix_pairs", "mesh", "decode_k"])
def test_unsupported_calls_raise(setup, case):
    """A mesh of one rank (a gloo world of one) scores the meshless rows
    bit for bit, with ``decode_k=1`` and with ``decode_k=2`` and a K-head
    distilled on the mesh, which is the meshless one
    (``tests/test_torch_mesh_serve.py`` runs ``decode_k=4`` on two ranks).
    The confidence leg (per batch
    and pooled) and ``(prefix, suffix)`` prompts score with ``decode_k=2``
    set after construction and no K-head: the rows of ``decode_k=1``.  T5
    with ``decode_k=4`` scores as with 1 (the K path is decoder-only)."""
    tok = setup
    if case == "decode_k":
        import test_torch_t5

        _, k1 = test_torch_t5.engines()
        _, k4 = test_torch_t5.engines(decode_k=4)
        assert not k4._k_enabled() and not k4._k_active()
        prompts = test_torch_t5.prompts()
        assert k4.score_prompts(prompts) == k1.score_prompts(prompts)
        return
    tcfg = tconfig.DecoderConfig(**tconfig.FLAGSHIP_SMALL_GEOMETRY)
    weights = convert.random_params(tcfg, seed=0, device="cpu", dtype="fp32")
    ecfg = tengine.EngineConfig(**{**ENGINE_KW, "phase2_pool": True}
                                if case == "pooled_confidence" else ENGINE_KW)
    kw = dict(engine_config=ecfg, device="cpu")
    if case == "mesh":
        import tempfile

        import torch.distributed as dist

        from llm_interpretation_replication_tpu_torch.parallel import mesh

        prompts = ["Is soup a beverage?", "Is a tomato a fruit?"]
        k2 = dict(kw, engine_config=dataclasses.replace(ecfg, decode_k=2))
        plain = tengine.ScoringEngine("falcon", tcfg, weights, tok, **kw)
        want = plain.score_prompts(prompts)
        kplain = tengine.ScoringEngine("falcon", tcfg, weights, tok, **k2)
        kplain.distill_k_head_on(prompts, gen_steps=4)
        kwant = kplain.score_prompts(prompts)
        with tempfile.TemporaryDirectory() as tmp:
            assert mesh.initialize_distributed(
                num_processes=1, process_id=0, device="cpu",
                init_method=f"file://{tmp}/store")
            try:
                eng = tengine.ScoringEngine("falcon", tcfg, weights, tok,
                                            **kw)
                eng.bind_mesh(mesh.make_mesh())
                assert eng.score_prompts(prompts) == want
                keng = tengine.ScoringEngine("falcon", tcfg, weights, tok,
                                             **k2)
                keng.bind_mesh(mesh.make_mesh())
                keng.distill_k_head_on(prompts, gen_steps=4)
                assert torch.equal(keng.k_head["w"], kplain.k_head["w"])
                assert keng.score_prompts(prompts) == kwant
            finally:
                dist.destroy_process_group()
        return
    rows = []
    for k in (1, 2):
        eng = tengine.ScoringEngine("falcon", tcfg, weights, tok, **kw)
        eng.ecfg = dataclasses.replace(eng.ecfg, decode_k=k)
        if case.endswith("confidence"):
            rows.append(eng.score_prompts(["Is soup a beverage?"],
                                          with_confidence=True))
        else:
            rows.append(eng.score_prompts([("Is soup a beverage?",
                                            " Answer:")]))
    assert rows[0] == rows[1] and rows[0][0]["success"]


def test_default_device_is_cuda(setup):
    """Entry points run on the card unless the caller asks for the CPU: on a
    machine without CUDA the defaults raise instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    tcfg = tconfig.DecoderConfig(**tconfig.FLAGSHIP_SMALL_GEOMETRY)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.random_params(tcfg)
    weights = convert.random_params(tcfg, device="cpu", dtype="fp32")
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.ScoringEngine("falcon", tcfg, weights, setup,
                              engine_config=tengine.EngineConfig(**ENGINE_KW))


def _closed_engine(setup, **close_kw):
    tcfg = tconfig.DecoderConfig(**tconfig.FLAGSHIP_SMALL_GEOMETRY)
    weights = convert.random_params(tcfg, seed=0, device="cpu", dtype="fp32")
    eng = tengine.ScoringEngine("falcon", tcfg, weights, setup, device="cpu",
                                engine_config=tengine.EngineConfig(**ENGINE_KW))
    assert eng.score_prompts(["Is soup a beverage?"])[0]["success"]
    eng.close(**close_kw)
    eng.close()                                          # idempotent
    assert eng.closed and eng.params is None
    with pytest.raises(tengine.EngineClosed):
        eng.score_prompts(["Is soup a beverage?"])
    return tcfg, weights


def test_close_releases_weights(setup):
    """The default ``close()`` frees the weights' storages in place, as the
    reference's ``close(release_params=True)`` deletes its buffers."""
    _, weights = _closed_engine(setup)
    assert all(b.untyped_storage().nbytes() == 0 for b in weights.buffers())


def test_close_keeps_weights_when_asked(setup):
    """``close(release_params=False)``: the caller's weights survive for
    another engine built on them."""
    tcfg, weights = _closed_engine(setup, release_params=False)
    assert all(b.numel() > 0 and b.untyped_storage().nbytes() > 0
               for b in weights.buffers())
    other = tengine.ScoringEngine("falcon", tcfg, weights, setup, device="cpu",
                                  engine_config=tengine.EngineConfig(**ENGINE_KW))
    assert other.score_prompts(["Is soup a beverage?"])[0]["success"]
