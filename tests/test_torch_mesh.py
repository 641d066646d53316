"""The port's scoring engine on a mesh of gloo ranks against the JAX engine
on the same meshes of the 8 virtual CPU devices.

Two spawns of ranks (``tests/torch_parallel_ranks.py``) run every case
while this process computes the JAX rows:

- 8 ranks: ``score_prompts`` on dp8 and dp2 x tp4 (a Falcon-shaped model:
  one K/V head, parallel residual over a shared norm, 5 query heads, which
  4 model ranks split 2/1/1/1), the two-phase gather on dp8 (5 prompts in
  a batch of 16), ``score_prefixed`` (both legs) on dp2 x tp2 (x seq2),
  w8a8 with an int8 KV cache on dp2 x tp4; the pooled ring, whole
  flushes, pipeline depth 1, chunked prefill, the pooled confidence leg and
  ``score_packed`` on dp2 x tp4 against the meshless port engine; and the
  row-parallel product's per-token absmax (local against the model axis's);
- 2 ranks: T5 on tp2, dp1 x seq2 against the meshless engine, an OOM on
  one rank of dp2, a dp2 decode's gathers (only the appended slots), and
  ``run-perturbation`` with ``--mesh-model 2`` and
  ``--mesh-seq 2`` against the single-process workbook, and a
  ``--mesh-model 2`` resume from state only rank 0's directory holds.

A third spawn of 2 ranks raises an OOM inside a tp2 forward on one rank:
every rank must end with an error within the group's timeout.

Classes (ROADMAP.md): verdicts, ``scan_found`` and tokens identical;
probabilities rtol 2e-5 in float32; w8a8 at ``W8A8_RTOL``, as the
single-device port test holds it.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.ops import quant as jquant
from llm_interpretation_replication_tpu.parallel import make_mesh as jmesh
from llm_interpretation_replication_tpu.parallel import \
    shard_params as jshard
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.utils.tokenizer import \
    WordTokenizer

import test_torch_t5
from test_torch_engine import ATOL, PROB_FIELDS, RTOL, W8A8_RTOL
from test_torch_slots import one_torch_thread  # noqa: F401
from torch_parallel_ranks import np_decoder_params, spawn

WORDS = [f"w{i}" for i in range(300)]
TOK = WordTokenizer(WORDS)
NAMES = {TOK.ids[" " + w]: w for w in WORDS}
FALCON = dict(vocab_size=640, hidden_size=60, num_layers=2, num_heads=5,
              num_kv_heads=1, intermediate_size=96, parallel_residual=True,
              shared_layernorm=True, qkv_bias=False, out_bias=False,
              mlp_bias=False, position_embedding="rotary",
              tie_word_embeddings=True, max_position_embeddings=256)
ECFG = dict(batch_size=8, buckets=(32, 64))
POOLED = dict(ECFG, decode_completions=False)


@functools.lru_cache(maxsize=None)
def falcon(w8a8=False):
    """The Falcon-shaped case: config, numpy params (w8a8-quantized or
    float32), prompts of 5-50 words over both buckets and per-prompt
    targets from a greedy pre-pass, so that rows resolve at position 0, in
    the look-ahead, or never."""
    cfg = tconfig.DecoderConfig(**FALCON)
    params = np_decoder_params(cfg, seed=7, scale=0.2)
    rng = np.random.default_rng(1)
    prompts = [" ".join(rng.choice(WORDS, int(n)))
               for n in rng.integers(5, 51, 12)]
    weights = convert.params_from_jax(params, cfg, device="cpu",
                                      dtype="fp32")
    enc = [TOK(p)["input_ids"] for p in prompts]
    width = max(map(len, enc))
    ids = np.zeros((len(enc), width), np.int64)
    mask = np.zeros((len(enc), width), np.int32)
    for i, e in enumerate(enc):
        ids[i, :len(e)], mask[i, :len(e)] = e, 1
    tmask = torch.from_numpy(mask)
    last, cache = tdec.prefill(weights, cfg, torch.from_numpy(ids), tmask,
                               cache_len=width)
    _, sc, *_ = tdec.decode_steps(weights, cfg, cache, last, tmask.sum(-1),
                                  0, 10, None, None, with_scores=True)
    top = torch.topk(sc, 5, dim=-1).indices.numpy()          # [N, 10, 5]
    targets = []
    for i in range(len(prompts)):
        seen = set(top[i].ravel().tolist())
        step = (0, 2, 7, None)[i % 4]
        yes = next((t for t in top[i, step] if int(t) in NAMES), None) \
            if step is not None else None
        never = [t for t in NAMES if t not in seen]
        yes = never[1] if yes is None else int(yes)
        targets.append((NAMES[yes], NAMES[never[0]]))
    if w8a8:
        params = jquant.quantize_decoder_params_np(params)
    pairs = [(p, (" Answer:", " Confidence:")) for p in prompts]
    return dict(cfg=FALCON, params=params, words=WORDS, prompts=prompts,
                targets=targets, pairs=pairs)


def t5_case(tmp_path):
    """The T5 test model of ``tests/test_torch_t5.py`` with its tokenizer
    written where the ranks read it."""
    import chip_smoke

    texts = (test_torch_t5.QUESTIONS
             + [test_torch_t5.tprompts.FEW_SHOT_PREFIX,
                test_torch_t5.tprompts.ANSWER_INSTRUCTION, "Yes", "No"]
             + [f"w{i}" for i in range(40)])
    spec, config, special = chip_smoke._unigram_tokenizer_files(texts)
    path = tmp_path / "t5tok"
    path.mkdir()
    for name, obj in (("tokenizer.json", spec),
                      ("tokenizer_config.json", config),
                      ("special_tokens_map.json", special)):
        (path / name).write_text(json.dumps(obj), encoding="utf-8")
    _, tcfg, _, _ = test_torch_t5.models("gated_untied")
    sd = {k: v.numpy() for k, v in
          test_torch_t5.state_dict("gated_untied").items()}
    return dict(t5=tcfg, state_dict=sd, tokenizer=str(path),
                prompts=test_torch_t5.prompts(), targets=("Yes", "No"))


def jax_rows(case, shape, call, w8a8=False, **ecfg):
    """The JAX engine's rows of a case on a mesh of the 8 virtual devices
    (``shape``: data, model)."""
    data, model = shape
    mesh = jmesh(data=data, model=model, devices=jax.devices()[:data * model])
    jcfg = jconfig.DecoderConfig(**case["cfg"])
    params = jshard(jax.tree_util.tree_map(jnp.asarray, case["params"]),
                    mesh)
    eng = jengine.ScoringEngine("falcon", jcfg, params, TOK, mesh=mesh,
                                engine_config=jengine.EngineConfig(**ecfg))
    if call == "prefixed":
        return eng.score_prefixed(
            case["pairs"], case["targets"],
            legs=[jengine.LegSpec("binary"),
                  jengine.LegSpec("confidence", with_confidence=True,
                                  max_new_tokens=4)])
    return eng.score_prompts(case["prompts"], case["targets"])


def assert_rows(got, ref, rtol=RTOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"]
        fields = PROB_FIELDS + (("weighted_confidence",)
                                if "weighted_confidence" in r else ())
        for f in fields:
            if r[f] is None:
                assert g[f] is None, f
                continue
            np.testing.assert_allclose(g[f], r[f], rtol=rtol, atol=ATOL,
                                       err_msg=f)


EIGHT = {
    "dp8": ("falcon", dict(data=8), ECFG, "prompts"),
    "dp2xtp4": ("falcon", dict(data=2, model=4), ECFG, "prompts"),
    "gather_dp8": ("falcon5", dict(data=8),
                   dict(batch_size=16, buckets=(32, 64),
                        decode_completions=False, phase2_pool=False),
                   "prompts"),
    "prefixed_dp2xtp2": ("falcon", dict(data=2, model=2, seq=2), ECFG,
                         "prefixed"),
    "w8a8_kv8_dp2xtp4": ("falcon_w8a8", dict(data=2, model=4),
                         dict(POOLED, kv_dtype="int8"), "prompts"),
    # schedules, against the meshless port engine
    "ring": ("falcon", dict(data=2, model=4), POOLED, "prompts"),
    "flush": ("falcon", dict(data=2, model=4),
              dict(POOLED, slot_repack=False), "prompts"),
    "depth1": ("falcon", dict(data=2, model=4),
               dict(POOLED, pipeline_depth=1, phase2_pool=False), "prompts"),
    "chunk": ("falcon", dict(data=2, model=4), dict(ECFG, prefill_chunk=16),
              "prompts"),
    "conf_pool": ("falcon", dict(data=4, model=2), ECFG, "confidence"),
    "packed": ("falcon", dict(data=2, model=4),
               dict(ECFG, buckets=(32, 64, 128)), "packed"),
}
MESHLESS = ("ring", "flush", "depth1", "chunk", "conf_pool", "packed")


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """Rank 0's results of the 8-rank spawn (started before the JAX
    rows are computed) and the inputs it ran."""
    case = falcon()
    inputs = {"falcon": case, "falcon_w8a8": falcon(w8a8=True),
              "falcon5": dict(case, prompts=case["prompts"][:5],
                              targets=case["targets"][:5]),
              "cases": EIGHT, "meshless": MESHLESS}
    rng = np.random.default_rng(3)
    inputs["falcon"] = dict(case, activation=rng.standard_normal(
        (3, 4, FALCON["intermediate_size"])).astype(np.float32))
    return inputs, functools.lru_cache(maxsize=None)(
        spawn("engine_eight", 8, tmp_path_factory.mktemp("e8"), inputs))


def test_engine_on_eight_ranks_matches_the_jax_engine(eight,
                                                      eight_cpu_devices):
    """dp8, dp2 x tp4, the dp8 two-phase gather, ``score_prefixed`` on
    dp2 x tp2 and w8a8 + int8 KV on dp2 x tp4 give the JAX engine's rows
    on the same meshes; the other schedules give the meshless port rows."""
    inputs, results = eight
    refs = {}
    for name in ("dp8", "dp2xtp4", "gather_dp8", "prefixed_dp2xtp2",
                 "w8a8_kv8_dp2xtp4"):
        key, mesh_kw, ecfg, call = EIGHT[name]
        refs[name] = jax_rows(inputs[key],
                              (mesh_kw.get("data", 1), mesh_kw.get("model", 1)),
                              call, **ecfg)
    got = results()
    for name in ("dp8", "dp2xtp4", "gather_dp8"):
        assert_rows(got[name], refs[name])
    assert any(r["scan_found"] for r in got["dp8"])
    assert not all(r["scan_found"] for r in got["dp8"])
    assert len(got["prefixed_dp2xtp2"]) == 2
    for leg, ref in zip(got["prefixed_dp2xtp2"], refs["prefixed_dp2xtp2"]):
        assert_rows(leg, ref)
    assert_rows(got["w8a8_kv8_dp2xtp4"], refs["w8a8_kv8_dp2xtp4"],
                rtol=W8A8_RTOL)
    for name in MESHLESS:
        assert_rows(got[name], got[name + "/meshless"])


def test_row_parallel_absmax_is_the_whole_rows(eight):
    """The w8a8 trap under tensor parallelism: a row-parallel product's
    input holds the rank's slice of the feature axis.  Codes from the
    rank's own per-token absmax differ from the reference's (the whole
    axis's absmax); the port's, all-reduced (MAX) over ``model``, equal
    them."""
    inputs, results = eight
    got = results()["absmax"]
    first, count = got["cols"]
    x = inputs["falcon"]["activation"]
    want = np.asarray(jquant.quantize_activations(jnp.asarray(x))[0])
    want = want[..., first:first + count]
    assert not np.array_equal(got["local"], want)
    np.testing.assert_array_equal(got["port"], want)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Rank 0's results of the 2-rank spawn, its directory, and the
    ``run-perturbation`` argv it ran (without the output directory)."""
    from transformers import FalconConfig, FalconForCausalLM

    from helpers import build_test_tokenizer
    from llm_interpretation_replication_tpu_torch.config import \
        legal_scenarios

    tmp = tmp_path_factory.mktemp("e2")
    snap = tmp / "falcon_snap"
    torch.manual_seed(7)
    FalconForCausalLM(FalconConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True, parallel_attn=True,
        new_decoder_architecture=False, bias=False, alibi=False)
    ).eval().save_pretrained(str(snap), safe_serialization=True)
    build_test_tokenizer(300).save_pretrained(str(snap))
    perturbations = tmp / "perturbations.json"
    perturbations.write_text(json.dumps([
        dict(s, rephrasings=[f"Variant one of: {s['original_main'][:60]}",
                             f"Variant two: {s['original_main'][20:70]}"])
        for s in legal_scenarios()]))
    argv = ["run-perturbation", "--device", "cpu", "--dtype", "float32",
            "--model", str(snap), "--perturbations", str(perturbations),
            "--batch-size", "4"]
    inputs = {"falcon": falcon(), "t5": t5_case(tmp), "argv": argv}
    return inputs, tmp, functools.lru_cache(maxsize=None)(
        spawn("engine_two", 2, tmp, inputs))


def test_engine_on_two_ranks(two, eight_cpu_devices):
    """T5 on tp2 gives the JAX T5 engine's rows on a tp2 mesh (the
    confidence leg included); dp1 x seq2 gives the meshless rows bit for
    bit; an OOM on rank 1 of dp2 steps both ranks down the ladder and the
    rows are the meshless engine's; a dp2 decode gathers only the slots
    it appends to the cache, in one all_gather with its other outputs."""
    inputs, _, results = two
    t5 = inputs["t5"]
    jcfg, _, params, _ = test_torch_t5.models("gated_untied")
    mesh = jmesh(model=2, devices=jax.devices()[:2])
    jeng = jengine.ScoringEngine("t5", jcfg, jshard(params, mesh, kind="t5"),
                                 test_torch_t5.tok(), mesh=mesh)
    ref = jeng.score_prompts(t5["prompts"], with_confidence=True,
                             max_new_tokens=4)
    got = results()
    assert_rows(got["t5_tp2"], ref)
    assert got["seq2"] == got["seq2/meshless"]
    assert got["oom_dp2/steps"] == [8]
    assert_rows(got["oom_dp2"], got["oom_dp2/meshless"])
    # a decode on dp2 gathers only the 4 slots it appended to each K/V
    # block, all its outputs in one all_gather; 3 rows (one padded) give
    # the meshless calls' results
    dg = got["decode_gather"]
    assert dg["slots"] and set(dg["slots"]) == {4}
    assert dg["all_gathers"] == 1
    assert dg["tokens_equal"] and dg["shape"] == dg["plain_shape"]
    assert dg["k_err"] <= 1e-5 and dg["last_err"] <= 1e-4


def test_run_perturbation_on_two_ranks(two, tmp_path, capsys):
    """``run-perturbation --mesh-model 2`` and ``--mesh-seq 2`` on two
    ranks write the single-process workbook once, from rank 0: rank 1's
    output directory holds nothing and rank 1 prints no row count.  A
    resume whose state only rank 0's directory holds (a node-local output
    directory) gives the same workbook."""
    from llm_interpretation_replication_tpu_torch.__main__ import \
        main as tmain
    from test_torch_sweep import assert_workbooks_equal

    inputs, tmp, results = two
    tmain(inputs["argv"] + ["--output-dir", str(tmp_path / "one")])
    got = results()
    for flag in ("--mesh-model", "--mesh-seq"):
        assert got[flag] == {0: ["perturbation_results.xlsx"], 1: []}
        assert_workbooks_equal(
            tmp / f"{flag[2:]}0" / "perturbation_results.xlsx",
            tmp_path / "one" / "perturbation_results.xlsx")
        assert got["printed_by_rank"][0][flag].strip().endswith("rows")
        assert got["printed_by_rank"][1][flag] == ""
    # the resume: rank 1's directory was empty, yet both ranks resumed
    # from rank 0's rows and the workbook is the single-process one
    assert got["resume/kept"] > 0
    assert got["resume"] == {0: ["perturbation_results.xlsx"], 1: []}
    assert_workbooks_equal(tmp / "resume0" / "perturbation_results.xlsx",
                           tmp_path / "one" / "perturbation_results.xlsx")


def test_oom_inside_a_tp_forward_ends_every_rank(tmp_path):
    """An OOM on rank 1 inside a tp2 forward, while rank 0 waits in the
    forward's collective: rank 1 raises it at once (no step down: a retry
    would pair with the other rank's pending collective), and rank 0 ends
    with an error within the group's timeout instead of hanging."""
    import pickle

    timeout = 10
    spawn("oom_inside_tp", 2, tmp_path, {"falcon": falcon()},
          timeout=timeout)()
    outcomes = [pickle.load(open(tmp_path / f"outcome{r}.pkl", "rb"))
                for r in (0, 1)]
    assert outcomes[1][0].startswith("OutOfMemoryError")
    assert outcomes[0][0] != "returned"
    assert all(seconds < timeout + 20 for _, seconds in outcomes)
