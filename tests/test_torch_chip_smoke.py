"""``chip_smoke.py``'s kernel tables stay true to the sources they name, and
its pooled phase keeps driving the engine's default schedule.

The card run reads two hand-kept tables: ``KERNELS`` (wrapper, CUDA source,
line of the TPU kernel it replaces) and ``TILE_KERNELS`` (the wrappers whose
kernels run ``attention_tile.cuh`` and so go through the edge phase).  A
wrapper whose entry point moves onto the tile core must join the edge
phase; a line number must name the TPU kernel.  These tests read the files
as text: no card, no ``nvcc``.
"""

import ast
import dataclasses
import inspect
import os
import re

import pytest

import chip_smoke
from test_torch_slots import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "llm_interpretation_replication_tpu_torch", "ops",
                    "csrc")
TPU_ATTENTION = os.path.join(ROOT, "llm_interpretation_replication_tpu", "ops",
                             "attention.py")


def _entry_body(source_text, entry):
    """The body of ``extern "C" int <entry>(...)`` in a CUDA source."""
    m = re.search(r'extern "C" int ' + re.escape(entry) + r"\(", source_text)
    assert m, f"no entry point {entry}"
    start = source_text.index("{", m.end())
    depth = 0
    for i in range(start, len(source_text)):
        depth += {"{": 1, "}": -1}.get(source_text[i], 0)
        if depth == 0:
            return source_text[start:i + 1]
    raise AssertionError(f"unbalanced braces in {entry}")


@pytest.mark.parametrize("wrapper,source", [k[:2] for k in chip_smoke.KERNELS])
def test_tile_core_kernels_are_in_the_edge_phase(wrapper, source):
    """A wrapper whose source includes ``attention_tile.cuh`` and whose
    entry point (``<wrapper>_bf16``) launches ``attn_tile::launch`` is in
    ``TILE_KERNELS``; one that does not is not."""
    with open(os.path.join(CSRC, source + ".cu"), encoding="utf-8") as f:
        text = f.read()
    on_core = ('#include "attention_tile.cuh"' in text
               and "attn_tile::launch" in _entry_body(text, wrapper + "_bf16"))
    assert on_core == (wrapper in chip_smoke.TILE_KERNELS)


def test_tile_kernels_are_known_wrappers():
    assert set(chip_smoke.TILE_KERNELS) <= set(chip_smoke.KERNEL_NAMES)
    assert len(set(chip_smoke.TILE_KERNELS)) == len(chip_smoke.TILE_KERNELS)


@pytest.mark.parametrize("wrapper,line", [(k[0], k[2])
                                          for k in chip_smoke.KERNELS])
def test_kernel_lines_name_the_tpu_kernel(wrapper, line):
    """Each ``KERNELS`` line number points at ``def <tpu kernel>(`` in the
    JAX package: ``_causal_grouped_kernel`` for ``causal_grouped_attention``
    and so on."""
    tpu_kernel = "_" + wrapper[:-len("_attention")] + "_kernel"
    with open(TPU_ATTENTION, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert lines[line - 1].startswith(f"def {tpu_kernel}(")


def _call_name(call):
    return getattr(call.func, "attr", getattr(call.func, "id", None))


def test_pooled_phase_runs_the_default_schedule_beside_the_per_batch_route():
    """The pooled phase builds its engines from one ``EngineConfig`` that
    leaves ``phase2_pool``, ``slot_repack``, ``pipeline_depth`` and the OOM
    settings at their defaults, and derives the per-batch route
    (``phase2_pool=False``), the whole-flush route and depth 1 from it."""
    tree = ast.parse(inspect.getsource(chip_smoke.pooled_phase))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    configs = [c for c in calls if _call_name(c) == "EngineConfig"]
    assert len(configs) == 1
    assert {k.arg for k in configs[0].keywords} == {
        "decode_completions", "batch_size", "phase2_pool_target"}
    replaced = [{k.arg: ast.literal_eval(k.value) for k in c.keywords}
                for c in calls if _call_name(c) == "replace"]
    for override in ({"phase2_pool": False}, {"slot_repack": False},
                     {"pipeline_depth": 1}):
        assert override in replaced
    runs = {elt.elts[0].value: elt.elts[1] for elt in ast.walk(tree)
            if isinstance(elt, ast.Tuple) and len(elt.elts) == 3
            and isinstance(elt.elts[0], ast.Constant)}
    assert isinstance(runs["ring"], ast.Name) and runs["ring"].id == "base"


# -- the full-study phase's host helpers ------------------------------------

SCENARIOS = os.path.join(ROOT, "llm_interpretation_replication_tpu",
                         "data_assets", "irrelevant_scenarios.json")


def test_suffix_word_counts_match_the_scenarios():
    """The binary and confidence suffixes take the word counts of each
    scenario's response_format and confidence_format."""
    import json

    with open(SCENARIOS, encoding="utf-8") as f:
        scenarios = json.load(f)
    assert chip_smoke.SCENARIO_SUFFIX_WORDS == tuple(
        (len(s["response_format"].split()), len(s["confidence_format"].split()))
        for s in scenarios)


def test_study_inputs():
    prefixes, suffixes = chip_smoke._study_inputs(0, 65024)
    assert len(prefixes) == len(suffixes) == chip_smoke.STUDY_PROMPTS
    assert 100 <= min(map(len, prefixes)) and max(map(len, prefixes)) <= 440
    words = chip_smoke.SCENARIO_SUFFIX_WORDS
    for i, (binary, conf) in enumerate(suffixes):
        assert (len(binary), len(conf)) == words[i % len(words)]
        assert min(binary + conf) >= 3 and max(binary + conf) < 65024


def _synthetic_prepass(seed=0, n=48, steps=10, vocab=400, k=19):
    """Greedy tokens drawn as a random model's are: a few tokens common to
    many rows, the rest rare; candidate ids by rank; logits of the first
    three positions in which every row but the first holds one id of its
    own high at position 0 and low everywhere else (ids past 300, which no
    window holds), the first row's lying next to the top-19 edge."""
    import numpy as np

    rng = np.random.default_rng(seed)
    common = rng.integers(3, 300, 6)
    tokens = np.where(rng.random((n, steps)) < 0.5,
                      rng.choice(common, (n, steps)),
                      rng.integers(3, 300, (n, steps)))
    logits3 = rng.standard_normal((n, 3, vocab)).astype(np.float32)
    logits3[:, :, 300:300 + n] = -4.0
    own = np.arange(n)
    logits3[own, 0, 300 + own] = 4.0
    logits3[0, 0, 300] = np.sort(logits3[0, 0])[-19] + 0.01
    top_ids = np.zeros((n, steps, k), np.int64)
    top_ids[:, :3] = np.argsort(-logits3, axis=-1)[..., :k]
    top_ids[:, 3:] = rng.integers(3, vocab, (n, steps - 3, k))
    batches = [np.arange(lo, min(n, lo + 16)) for lo in range(0, n, 16)]
    return tokens, top_ids, logits3, batches


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retirement_plan_retires_the_planned_rows_and_no_other(seed):
    """Under the plan's decode map, ``first_int_stable`` (checked from step
    3, as the pooled confidence leg checks it) first holds at each planned
    row's planned step, and at no step for any other row; no batch passes
    its cap."""
    import collections

    from llm_interpretation_replication_tpu_torch.scoring.confidence import (
        first_int_stable)

    tokens, top_ids, logits3, batches = _synthetic_prepass(seed)
    decode_map, plan = chip_smoke._retirement_plan(
        tokens, top_ids, batches, 400, logits3, margin=0.1, per_batch=6)
    assert plan and set(plan.values()) <= set(range(3, 11))
    per = collections.Counter(next(b for b, rows in enumerate(batches)
                                   if r in rows) for r in plan)
    assert max(per.values()) <= 6
    tok = chip_smoke._id_tokenizer(400, decode_map)
    for r, row in enumerate(tokens):
        frozen = [k for k in range(3, 11)
                  if first_int_stable(tok.decode(row[:k].tolist()))]
        assert (frozen[0] if frozen else None) == plan.get(r), r
    assert chip_smoke._retire_steps(tok, tokens) == [
        plan.get(r, -1) for r in range(len(tokens))]


def test_retirement_plan_digits_sit_clear_of_the_candidate_edge():
    """Digit candidates go to ids no window holds, at least the margin
    inside their row's top-19 at position 0, clear of the edge at its
    other positions and below it everywhere else."""
    import numpy as np

    tokens, top_ids, logits3, batches = _synthetic_prepass(3)
    decode_map, _ = chip_smoke._retirement_plan(
        tokens, top_ids, batches, 400, logits3, margin=0.1, per_batch=6)
    digits = [t for t, text in decode_map.items() if text in (" 4", " 8")]
    assert digits and not set(digits) & set(tokens.ravel().tolist())
    assert 300 not in digits                      # at its row's edge
    edge = np.sort(logits3, axis=-1)[..., -19]
    for c in digits:
        off = logits3[:, :, c] - edge
        owner = int(np.argmax(off[:, 0]))
        assert off[owner, 0] >= 0.1 and (np.abs(off[owner]) >= 0.1).all()
        assert (np.delete(off, owner, axis=0) <= -0.1).all()


@pytest.mark.parametrize("r_stars,want", [
    ([-1] * 32, (0, 0)),
    ([3] * 8 + [-1] * 24, (8, 8 * 7)),           # 24 live rows: compacted
    ([3] * 7 + [-1] * 25, (7, 0)),               # 25 live rows pad to 32
    ([3] * 8 + [6] * 8 + [-1] * 16, (16, 8 * 7 + 8 * 2)),
    ([9] * 32, (0, 0)),                          # read only after 3 and 8
    ([3] * 32, (32, 32 * 7)),                    # all retired: the flush ends
])
def test_flush_retirements(r_stars, want):
    assert chip_smoke._flush_retirements(r_stars) == want
    assert chip_smoke._flush_checkpoints() == [3, 8]


def test_ring_steps_saved():
    assert chip_smoke._ring_steps_saved([-1, 3, 5, 6, 10]) == 5 + 5


def test_observed_retirements_read_the_cut_completions():
    decode_map = {7: " 7.", 9: " 4"}
    tok = chip_smoke._id_tokenizer(20, decode_map)
    rows = [{"completion": tok.decode(t).strip()} for t in (
        [5, 7, 6], [5, 6, 6, 7, 6, 6, 6, 6, 6, 6], [5] * 10, [5, 6])]
    assert chip_smoke._observed_retirements(tok, decode_map, rows) == (
        [3, 4, -1, 3], [False, False, False, True])


def _row(completion, rel=0.5, found=False, wc=None):
    return {"completion": completion, "relative_prob": rel,
            "scan_found": found, "weighted_confidence": wc, "success": True,
            "yes_prob": 0.1, "no_prob": 0.1, "first_token_yes_prob": 0.0,
            "first_token_no_prob": 0.0, "first_token_relative_prob": 0.5}


def test_compare_rows_lets_rows_part_only_at_near_ties():
    import numpy as np

    ref = [_row("t1 t2 t3 t4"), _row("t1 t2 t3 t4"), _row("t1 t2 t3 t4"),
           _row("t1 t2 t3 t4", found=True)]
    got = [_row("t1 t2 t9 t4"), _row("t1 t9 t3 t4"), _row("t1 t2 t3"),
           _row("t1 t2 t3", found=False)]
    gaps = np.full((4, 4), 1.0, np.float32)
    gaps[0, 2] = 0.01                               # row 0 parts at a tie
    edge0 = np.ones(4, np.float32)
    stats, fails = chip_smoke._compare_rows("x", got, ref, gaps, edge0, 0.1,
                                            True, 0.01, cut={2, 3})
    assert stats["parted_rows"] == 2 and stats["cut_rows"] == 2
    assert len(fails) == 1 and "row 1 parts at step 1" in fails[0]


def test_full_study_phase_runs_the_defaults_and_their_routes():
    """The phase scores at ``EngineConfig()`` and derives the whole-flush
    (``slot_repack=False``) and per-batch confidence
    (``pooled_confidence=False``) routes from it."""
    tree = ast.parse(inspect.getsource(chip_smoke.full_study_phase))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    configs = [c for c in calls if _call_name(c) == "EngineConfig"]
    assert len(configs) == 1 and not configs[0].keywords
    replaced = [{k.arg: ast.literal_eval(k.value) for k in c.keywords}
                for c in calls if _call_name(c) == "replace"]
    for override in ({"slot_repack": False}, {"pooled_confidence": False}):
        assert override in replaced
    # the phase, and the packed phase that takes its near-tie, run at one
    # depth: views of the slice's first FULL_STUDY_LAYERS layers
    assert chip_smoke.FULL_STUDY_LAYERS == 8
    for phase in (chip_smoke.full_study_phase, chip_smoke.packed_phase):
        src = inspect.getsource(phase)
        assert "_first_layers(weights, FULL_STUDY_LAYERS)" in src
        assert '"num_layers": FULL_STUDY_LAYERS' in src


# -- the sweep and CLI phases ----------------------------------------------------

def test_rephrasings_stay_in_the_corpus_token_range():
    """24 distinct word-level edits a scenario, each 60-140 words (one
    token a word under the sweep's tokenizer), none the original."""
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios

    scenarios = legal_scenarios()
    for seed in (0, 1):
        reph = chip_smoke._rephrasings(scenarios, seed)
        tok = chip_smoke._sweep_tokenizer(
            [dict(s, rephrasings=r) for s, r in zip(scenarios, reph)])
        assert [len(r) for r in reph] == [chip_smoke.SWEEP_PER_SCENARIO] * 5
        for s, rs in zip(scenarios, reph):
            assert len(set(rs)) == len(rs) and s["original_main"] not in rs
            for r in rs:
                n = len(tok(r)["input_ids"])
                assert chip_smoke.SWEEP_TOKENS[0] <= n <= chip_smoke.SWEEP_TOKENS[1]
                assert tok.unk_token_id not in tok(r)["input_ids"]
    assert chip_smoke._rephrasings(scenarios, 0) == \
        chip_smoke._rephrasings(scenarios, 0)


def test_sweep_tokenizer_moves_targets_to_chosen_ids():
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    scenarios = legal_scenarios()
    plain = chip_smoke._sweep_tokenizer(scenarios)
    inside = plain.ids[" the"]
    tok = chip_smoke._sweep_tokenizer(scenarios, {" Covered": 900,
                                                  " Not": inside})
    assert yes_no.target_token_ids(tok, ["Covered", "Not"]) == [900, inside]
    assert len(tok) == 901 and tok.vocab[plain.ids[" Not"]] == " the"
    assert tok.vocab[plain.ids[" Covered"]].startswith("<filler")
    text = scenarios[0]["original_main"]
    assert len(tok(text)["input_ids"]) == len(plain(text)["input_ids"])


def test_sweep_tokenizer_decodes_one_word_a_token():
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios

    tok = chip_smoke._sweep_tokenizer(legal_scenarios())
    text = tok.decode([0, 1, 7, 65023], skip_special_tokens=True)
    assert text == " t0 t1 t7 t65023"
    assert chip_smoke._completion_ids(text.strip()) == [0, 1, 7, 65023]
    cut = (" t12345" * 20).strip()[:100]
    assert chip_smoke._completion_ids(cut) == [12345] * 14


@pytest.mark.parametrize("buckets,chunk,want", [
    ((64, 80, 144), 64, 2 + 3), ((64, 128, 448), 128, 4), ((448,), 64, 7),
    ((32, 48), 64, 0), ((65,), 64, 2), ((128,), 1, 128),
])
def test_expected_prefill_chunks(buckets, chunk, want):
    assert chip_smoke._expected_prefill_chunks(buckets, chunk) == want


def test_sweep_prefix_buckets_follow_the_engine_batches():
    """The fused route's prefix batches of the smoke's rows: chunks of 40
    rows, each batched by length; the chunked run replays the buckets
    above 64 in 2-3 chunks."""
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios

    scenarios = [dict(s, rephrasings=r) for s, r in zip(
        legal_scenarios(), chip_smoke._rephrasings(legal_scenarios(), 0))]
    tok = chip_smoke._sweep_tokenizer(scenarios)
    buckets = chip_smoke._sweep_prefix_buckets(scenarios, tok)
    assert len(buckets) == 6                     # 3 chunks of 32 + 8 rows
    assert all(64 <= b <= 144 for b in buckets)
    assert chip_smoke._expected_prefill_chunks(buckets, 64) == sum(
        -(-b // 64) for b in buckets if b > 64) > 0


def test_safetensors_writer_round_trips_through_the_port_reader(tmp_path):
    import torch

    from llm_interpretation_replication_tpu_torch.runtime import loader

    tensors = {"a": torch.randn(3, 5).to(torch.bfloat16),
               "b": torch.randn(7).to(torch.float16),
               "c.weight": torch.randn(2, 3, 4),
               "odd": torch.randn(1).to(torch.bfloat16),
               "after_odd": torch.randn(2, 2)}
    path = str(tmp_path / "model.safetensors")
    chip_smoke._write_safetensors(path, tensors)
    header, start = loader.read_safetensors_header(path)
    assert start % 8 == 0 and set(header) == set(tensors)
    ckpt = loader.CheckpointDir(str(tmp_path))
    for name, t in tensors.items():
        got = ckpt.get(name)
        assert got.dtype == t.dtype and torch.equal(got, t), name


def test_compare_workbooks_lets_completions_part_only_at_near_ties():
    import numpy as np

    def row(resp, conf="t1 t2", p=0.0):
        return {"Model": "m", "Original Main Part": "o",
                "Response Format": "r", "Confidence Format": "c",
                "Rephrased Main Part": "x", "Full Rephrased Prompt": "x r",
                "Full Confidence Prompt": "x c", "Log Probabilities": "l",
                "Model Response": resp, "Model Confidence Response": conf,
                "Token_1_Prob": p, "Token_2_Prob": 0.0,
                "Confidence Value": None, "Weighted Confidence": None}

    ref = [row("t1 t2 t3"), row("t1 t2 t3"), row("t1 t2"), row("t1", p=0.5)]
    got = [row("t1 t9 t3"), row("t9 t2 t3"), row("t1 t2", "t1 t8"),
           row("t1", p=0.4)]
    leads = np.ones((4, 4), np.float32)
    leads[0, 1] = 0.01                        # row 0 parts at a near-tie
    edge0 = np.ones(4, np.float32)
    stats, fails = chip_smoke._compare_workbooks("x", got, ref, leads, leads,
                                                 edge0, 0.1)
    assert stats["parted_completions"] == 3
    assert len(fails) == 3
    assert "row 1 Model Response parts at step 0" in fails[0]
    assert "row 2 Model Confidence Response" in fails[1]
    assert "row 3 Token_1_Prob" in fails[2]
    edge0[3] = 0.05                           # a target at the filter's edge
    assert len(chip_smoke._compare_workbooks("x", got, ref, leads, leads,
                                             edge0, 0.1)[1]) == 2


def test_sweep_phase_runs_the_five_routes():
    """Run (a) is the fused default, (b) the resumed crash, (c) the legacy
    route, (d) the fallback at a top filter other than 20 and (e) chunked
    prefill at SWEEP_PREFILL_CHUNK."""
    src = inspect.getsource(chip_smoke.sweep_phase)
    for call in ('sweep("fused")', 'sweep("resumed", crash=True)',
                 'sweep("legacy", fuse=False)',
                 "first_token_top_filter=5",
                 "prefill_chunk=SWEEP_PREFILL_CHUNK"):
        assert call in src, call


def test_sweep_phase_reruns_three_routes_on_boosted_targets():
    """(a), (c) and (e) run again on the scenarios' own target ids with
    boosted rows, held to the rounding measured on those weights, and the
    weights are restored afterwards."""
    src = inspect.getsource(chip_smoke.sweep_phase)
    for call in ('sweep("boosted_fused", tok=word_tok)',
                 'sweep("boosted_legacy", fuse=False, tok=word_tok)',
                 'sweep("boosted_chunked"', "_bf16_rounding(",
                 "emb.copy_(unboosted)"):
        assert call in src, call


def test_boost_targets_scales_only_the_target_rows():
    import torch

    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.models import config, convert

    scenarios = legal_scenarios()
    tok = chip_smoke._sweep_tokenizer(scenarios)
    cfg = config.DecoderConfig(**{**config.FLAGSHIP_SMALL_GEOMETRY,
                                  "num_layers": 1})
    weights = convert.random_params(cfg, seed=1, device="cpu", dtype="fp32")
    before = weights.tree()["embed"]["tokens"].clone()
    ids = chip_smoke._boost_targets(weights, tok, scenarios)
    after = weights.tree()["embed"]["tokens"]
    assert len(ids) == 8          # Covered/Not twice, three other pairs
    assert torch.equal(after[ids], before[ids] * chip_smoke.TARGET_BOOST)
    rest = [i for i in range(before.shape[0]) if i not in ids]
    assert torch.equal(after[rest], before[rest])


def _tiny_sweep(per=4, vocab_size=1024):
    """The legal scenarios with ``per`` seeded rephrasings each, their sweep
    tokenizer, and one-layer float32 weights on the CPU."""
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.models import config, convert

    scenarios = [dict(s, rephrasings=r[:per]) for s, r in zip(
        legal_scenarios(), chip_smoke._rephrasings(legal_scenarios(), 0))]
    cfg = config.DecoderConfig(**{**config.FLAGSHIP_SMALL_GEOMETRY,
                                  "num_layers": 1, "vocab_size": vocab_size})
    weights = convert.random_params(cfg, seed=1, device="cpu", dtype="fp32")
    return scenarios, chip_smoke._sweep_tokenizer(scenarios), cfg, weights


def test_padded_right_pads_ids_and_mask():
    import torch

    ids, mask = chip_smoke._padded([[5, 6, 7], [8], [9, 10]], "cpu")
    assert ids.dtype == torch.long and mask.dtype == torch.int32
    assert ids.tolist() == [[5, 6, 7], [8, 0, 0], [9, 10, 0]]
    assert mask.tolist() == [[1, 1, 1], [1, 0, 0], [1, 1, 0]]


def test_filtered_target_probs_read_as_the_workbook_reads_them():
    import torch

    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    torch.manual_seed(0)
    logits = torch.randn(3, 50)
    tgt = torch.stack([torch.topk(logits, 25).indices[:, 3],
                       torch.topk(logits, 25).indices[:, 22]], 1)
    got = chip_smoke._filtered_target_probs(logits, tgt)
    probs = torch.softmax(logits, -1)
    assert torch.equal(got[:, 0], probs.gather(1, tgt[:, :1])[:, 0])
    assert torch.equal(got[:, 1], torch.zeros(3))       # past the top 20
    for i in range(3):
        yes, no, _ = yes_no.relative_prob_first_token(
            logits[i:i + 1], int(tgt[i, 0]), int(tgt[i, 1]),
            top_filter=chip_smoke.TOP_FILTER)
        assert float(yes) == float(got[i, 0]) and float(no) == 0.0


def test_popular_targets_and_the_row_swap(one_torch_thread):
    """The chosen ids avoid ``taken`` and each other; swapping moves the
    chosen ids' rows to the targets' ids and back, and touches no other."""
    import torch

    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    scenarios, tok, cfg, weights = _tiny_sweep(per=2, vocab_size=8192)
    taken = range(len(tok))
    chosen = chip_smoke._popular_targets(weights, cfg, scenarios, tok, taken)
    words = {" " + t for s in scenarios for t in s["target_tokens"]}
    assert set(chosen) == words
    assert len(set(chosen.values())) == len(chosen)
    assert all(len(tok) <= i < cfg.vocab_size for i in chosen.values())
    before = weights.tree()["embed"]["tokens"].clone()
    pairs = chip_smoke._swap_embedding_rows(weights, tok, chosen)
    after = weights.tree()["embed"]["tokens"]
    moved = set()
    for word, tid in chosen.items():
        t = yes_no.target_token_ids(tok, [word[1:]])[0]
        assert (t, tid) in pairs
        assert torch.equal(after[t], before[tid])
        assert torch.equal(after[tid], before[t])
        moved |= {t, tid}
    rest = [i for i in range(before.shape[0]) if i not in moved]
    assert torch.equal(after[rest], before[rest])
    with pytest.raises(ValueError, match="free ids"):
        chip_smoke._popular_targets(weights, cfg, scenarios, tok,
                                    range(cfg.vocab_size))


def test_bf16_rounding_and_workbook_leads_on_the_cpu(one_torch_thread):
    """At float32 the pre-pass decode and the one forward agree to float32
    rounding, and the leads cover each row's completion steps."""
    import numpy as np

    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    scenarios, tok, cfg, weights = _tiny_sweep(per=2)
    ecfg = dataclasses.replace(emod.EngineConfig(), max_new_tokens=6,
                               max_look_ahead=3)
    r, p32, clear = chip_smoke._bf16_rounding(weights, cfg, scenarios, tok,
                                              ecfg)
    assert 0 <= r["top1_max_abs_diff"] < 1e-3
    assert r["tie"] == 2 * chip_smoke.NEAR_TIE_FACTOR * r["top1_max_abs_diff"]
    assert 0 <= r["prob_bf16_vs_fp32"] < 1e-6      # float32 weights both
    assert p32.shape == (10, 2) and ((p32 >= 0) & (p32 <= 1)).all()
    assert r["rows_clear_of_edge"] == clear.sum() and clear.shape == (10,)
    ref = [{"Model Response": " t5 t6 t7", "Model Confidence Response": " t8"}
           ] * 10
    bin_leads, conf_leads, edge0 = chip_smoke._workbook_leads(
        weights, cfg, scenarios, tok, ref)
    assert bin_leads.shape == (10, 4) and conf_leads.shape == (10, 2)
    assert np.isfinite(bin_leads).all() and (bin_leads >= 0).all()
    assert edge0.shape == (10,) and np.isfinite(edge0).all()


# -- the families and run-100q phases ----------------------------------------------

_HF_CLASSES = {"neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM"),
               "bloom": ("BloomConfig", "BloomForCausalLM"),
               "llama": ("MistralConfig", "MistralForCausalLM")}


@pytest.mark.parametrize("config", [chip_smoke.PYTHIA_6_9B,
                                    chip_smoke.REDPAJAMA_7B,
                                    chip_smoke.BLOOM_7B1,
                                    chip_smoke.MISTRAL_7B_V02],
                         ids=["pythia", "redpajama", "bloom", "mistral"])
def test_hf_state_dict_is_the_hf_models_and_converts(config, one_torch_thread):
    """The random checkpoint carries the names and shapes of the HF model
    of the same (narrowed) config, and the port's converter reads it."""
    import torch
    import transformers

    from llm_interpretation_replication_tpu_torch.models import convert

    small = {**config, "vocab_size": 96, "hidden_size": 32,
             "intermediate_size": 64}
    small.update({"n_head": 4} if "n_head" in small else
                 {"num_attention_heads": 4,
                  "num_key_value_heads": 2 if "num_key_value_heads" in small
                  else None})
    small = {k: v for k, v in small.items() if v is not None}
    family, cfg = chip_smoke._family_config(small, layers=2)
    assert cfg.num_layers == 2
    sd = chip_smoke._hf_state_dict(family, cfg, 0, "cpu", torch.float32)
    cfg_cls, model_cls = _HF_CLASSES[family]
    hf_kw = {k: v for k, v in chip_smoke._at_depth(small, 2).items()
             if k != "model_type"}
    model = getattr(transformers, model_cls)(
        getattr(transformers, cfg_cls)(**hf_kw))
    ref = {k: v.shape for k, v in model.state_dict().items()
           if v.is_floating_point() and k != "lm_head.weight"
           or (k == "lm_head.weight" and not cfg.tie_word_embeddings)}
    assert {k: v.shape for k, v in sd.items()} == ref
    tree = convert.CONVERTERS[family](sd.__getitem__, cfg)
    assert tree["layers"]["attn"]["wq"].shape == (
        2, cfg.hidden_size, cfg.num_heads * cfg.head_dim)
    assert tree["layers"]["attn"]["wk"].shape == (
        2, cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim)


def test_published_configs_translate():
    got = {label: chip_smoke._family_config(config)
           for label, _, config, _ in chip_smoke.FAMILY_MODELS}
    fam, cfg = got["pythia-6.9b"]
    assert (fam, cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.head_dim, cfg.rotary_pct, cfg.vocab_size) == (
        "neox", 32, 4096, 32, 128, 0.25, 50432)
    assert cfg.parallel_residual and not cfg.tie_word_embeddings
    fam, cfg = got["mistral-7b-instruct-v0.2"]
    assert (fam, cfg.num_kv_heads, cfg.intermediate_size, cfg.rope_theta,
            cfg.sliding_window, cfg.norm_type, cfg.mlp_type) == (
        "llama", 8, 14336, 1e6, None, "rmsnorm", "gated")
    fam, cfg = got["bloom-7b1"]
    assert (fam, cfg.num_layers, cfg.num_heads, cfg.vocab_size,
            cfg.position_embedding, cfg.embedding_layernorm,
            cfg.tie_word_embeddings) == ("bloom", 30, 32, 250880, "alibi",
                                          True, True)
    assert chip_smoke._family_config(chip_smoke.MISTRAL_7B_V01)[1] \
        .sliding_window == 4096
    _, stable = chip_smoke._family_config(chip_smoke.STABLELM_ALPHA_7B)
    assert (stable.num_heads, stable.head_dim) == (48, 128)


def test_cli_roster_covers_every_model_of_the_sweep():
    from llm_interpretation_replication_tpu_torch.config import model_pairs_100q

    names = {m for p in model_pairs_100q() for m in (p["base"], p["instruct"])}
    listed = {m for m, _, shared, _ in chip_smoke.CLI_SNAPSHOTS} | {
        m for _, _, shared, _ in chip_smoke.CLI_SNAPSHOTS for m in shared} | {
        "mistralai/Mistral-7B-v0.1"}
    assert listed == names and chip_smoke.CLI_DENSE <= names
    assert [f for *_, f in chip_smoke.CLI_SNAPSHOTS].count("bin") == 1


def test_bin_shards_round_trip_through_the_port_reader(tmp_path):
    import torch

    from llm_interpretation_replication_tpu_torch.runtime.loader import (
        CheckpointDir)

    sd = {f"w{i}": torch.randn(3, i + 1).bfloat16() for i in range(5)}
    chip_smoke._write_bin_shards(str(tmp_path), sd, shards=2)
    assert sorted(os.listdir(tmp_path)) == [
        "pytorch_model-00001-of-00002.bin", "pytorch_model-00002-of-00002.bin",
        "pytorch_model.bin.index.json"]
    ck = CheckpointDir(str(tmp_path))
    for k, v in sd.items():
        assert torch.equal(ck.get(k), v) and ck.get(k).dtype == v.dtype


def test_parting_and_the_family_row_gates():
    import numpy as np

    assert chip_smoke._parting(" t1 t2", " t1 t2") is None
    assert chip_smoke._parting(" t1 t2", " t1 t3") == 1
    assert chip_smoke._parting(" t1", " t1 t3") == 1

    def row(comp, found=True, yes=0.2, no=0.1, pos0=(0.2, 0.1)):
        return dict(success=True, completion=comp, scan_found=found,
                    yes_prob=yes, no_prob=no,
                    relative_prob=yes / (yes + no),
                    first_token_yes_prob=pos0[0], first_token_no_prob=pos0[1])

    steps = chip_smoke.SCAN_STEPS
    ref = [row(" t1 t2"), row(" t1 t2"), row(" t1 t2"), row(" t1 t2")]
    rows = [row(" t1 t2"), row(" t1 t9"), row(" t1 t2", yes=0.05),
            row(" t1 t2", pos0=(0.3, 0.1))]
    leads = np.full((4, 3), 1.0, np.float32)
    leads[1, 1] = 0.01                      # row 1 parts at a near-tie
    edge = np.full((4, steps), 1.0, np.float32)
    split = np.full((4, steps), 1.0, np.float32)
    p32 = np.array([[0.2, 0.1]] * 4)
    clear = np.array([True, True, True, True])
    stats, fails = chip_smoke._compare_family_rows(
        "x", rows, ref, leads, edge, split, 0.1, p32, clear, 0.05)
    assert stats["parted_rows"] == 1 and stats["verdict_flips"] == 1
    assert len(fails) == 2 and "row 2 verdict" in fails[0] \
        and "row 3 first_token_yes_prob" in fails[1]
    edge[2, 1] = 0.05                       # row 2's target sits at the edge
    clear[3] = False                        # row 3 lies near the filter edge
    _, fails = chip_smoke._compare_family_rows(
        "x", rows, ref, leads, edge, split, 0.1, p32, clear, 0.05)
    assert fails == []
    leads[1, 1] = 0.5
    _, fails = chip_smoke._compare_family_rows(
        "x", rows, ref, leads, edge, split, 0.1, p32, clear, 0.05)
    assert len(fails) == 1 and "row 1 parts at step 1" in fails[0]


def test_question_tokenizer_and_prompts():
    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    tok = chip_smoke._question_tokenizer()
    prompts, prefix_lens = chip_smoke._question_prompts(tok)
    assert len(prompts) == 200 and len(set(prefix_lens[:100])) == 1
    assert tok.unk_token_id not in {t for p in prompts for t in p}
    yes, no = yes_no.target_token_ids(tok, ["Yes", "No"])
    assert tok.vocab[yes] == " Yes" and tok.vocab[no] == " No"
    assert tok.decode([yes, 70000]) == f" t{yes} t70000"


def test_families_phase_runs_every_route_through_the_sweep_call():
    src = inspect.getsource(chip_smoke.families_phase)
    assert "run_model_on_prompts" in src and "EngineConfig(batch_size=BATCH)" in src
    routes = {label: r for label, _, _, r in chip_smoke.FAMILY_MODELS}
    assert routes == {"pythia-6.9b": ("flash", "xla"),
                      "mistral-7b-instruct-v0.2": ("flash", "xla", "int8kv",
                                                   "w8a8-int8kv"),
                      "bloom-7b1": ("xla",)}


def _tiny_w8a8(seed=0):
    """A 2-layer Mistral-shaped decoder in bf16 (GQA 4/2, SwiGLU) from a
    HF-named random checkpoint, its w8a8 tree with an int8 KV cache, and
    prompts split into a prefix and a suffix."""
    import dataclasses as dc

    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.ops import quant

    small = {**chip_smoke.MISTRAL_7B_V02, "vocab_size": 96, "hidden_size": 64,
             "intermediate_size": 128, "num_attention_heads": 4,
             "num_key_value_heads": 2}
    family, cfg = chip_smoke._family_config(small, layers=2)
    sd = chip_smoke._hf_state_dict(family, cfg, seed, "cpu", torch.bfloat16)
    sd = {k: v.mul(10.0) if k.endswith("proj.weight") else v
          for k, v in sd.items()}
    weights = decoder.DecoderWeights(
        cfg, convert.CONVERTERS[family](sd.__getitem__, cfg))
    kv8 = dc.replace(cfg, kv_cache_dtype="int8")
    qweights = decoder.DecoderWeights(
        kv8, quant.quantize_decoder_params(weights.tree()))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 96, int(n)).tolist()
               for n in rng.integers(10, 20, 12)]
    return weights, qweights, kv8, prompts, [6] * len(prompts), \
        [[3, 5]] * len(prompts)


def test_fake_quant_witness_holds_the_w8a8_route(one_torch_thread,
                                                 monkeypatch):
    """The w8a8 route passes its float32 fake-quant witness; a route whose
    activation steps are 2% or 10% off fails it, and a tree with a wrong
    weight scale fails its half-step check."""
    from llm_interpretation_replication_tpu_torch.ops import quant

    weights, qweights, kv8, prompts, pre, tgt = _tiny_w8a8()
    fails = []
    out = chip_smoke._fake_quant_witness("w8a8", weights, qweights, kv8,
                                         prompts, pre, tgt, fails)
    assert fails == [], fails
    assert out["max_code_offset_steps"] <= 0.5 + 1e-4
    assert out["int8_route_max_abs_d_log_prob"] <= out["log_prob_tol"]
    assert out["int8_route_vs_fake_quant_bf16_max_abs_d_log_prob"] <= \
        out["log_prob_tol"]
    assert out["projection_max_rel_d"] <= chip_smoke.PROJECTION_TOL

    real = quant.quantize_activations
    for off, caught in ((1.02, ["int8 projection"]),
                        (1.1, ["int8 projection", "fake-quant witness"])):
        monkeypatch.setattr(quant, "quantize_activations",
                            lambda x, off=off: (lambda q, s: (q, s * off))(
                                *real(x)))
        fails = []
        chip_smoke._fake_quant_witness("w8a8", weights, qweights, kv8,
                                       prompts, pre, tgt, fails)
        assert [c for c in caught if not any(c in f for f in fails)] == []
    monkeypatch.setattr(quant, "quantize_activations", real)

    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    tree = qweights.tree()
    tree["layers"]["mlp"]["wg_qscale"] = tree["layers"]["mlp"]["wg_qscale"] \
        * torch.linspace(0.9, 1.1, tree["layers"]["mlp"]["wg_qscale"].shape[-1])
    fails = []
    chip_smoke._quantized_tree_half_step(
        "w8a8", weights, decoder.DecoderWeights(kv8, tree), fails)
    assert fails and all("wg" in f or "steps" in f for f in fails)


# -- the instruct phases: T5, Qwen-1, Baichuan2, OPT --------------------------

_SMALL_NEW = {
    "qwen": dict(hidden_size=32, num_attention_heads=4, kv_channels=8,
                 intermediate_size=128, vocab_size=96),
    "baichuan": dict(hidden_size=32, num_attention_heads=4,
                     intermediate_size=64, vocab_size=96),
    "opt": dict(hidden_size=32, num_attention_heads=4, ffn_dim=64,
                word_embed_proj_dim=32, vocab_size=96,
                max_position_embeddings=64),
}


@pytest.mark.parametrize("config", [chip_smoke.QWEN_7B_CHAT,
                                    chip_smoke.BAICHUAN2_7B_CHAT,
                                    chip_smoke.OPT_IML_1_3B],
                         ids=["qwen", "baichuan", "opt"])
def test_new_family_state_dicts_convert(config, one_torch_thread):
    """The converter reads every tensor the random checkpoint holds and
    finds every one it asks for; OPT's names and shapes are the HF
    model's."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import convert

    small = dict(config, **_SMALL_NEW[config["model_type"]])
    family, cfg = chip_smoke._family_config(small, layers=2)
    sd = chip_smoke._hf_state_dict(family, cfg, 0, "cpu", torch.float32)
    read = set()

    def get(name):
        read.add(name)
        return sd[name]

    tree = convert.CONVERTERS[family](get, cfg)
    assert read == set(sd)
    assert tree["layers"]["mlp"]["wi"].shape == (2, 32, cfg.intermediate_size)
    if family == "opt":
        import transformers

        hf_kw = {k: v for k, v in chip_smoke._at_depth(small, 2).items()
                 if k != "model_type"}
        model = transformers.OPTForCausalLM(transformers.OPTConfig(**hf_kw))
        ref = {k: v.shape for k, v in model.state_dict().items()
               if k != "lm_head.weight"}
        assert {k: v.shape for k, v in sd.items()} == ref


def test_instruct_configs_translate():
    got = {label: chip_smoke._family_config(config)
           for label, _, config, _ in chip_smoke.INSTRUCT_DECODERS}
    fam, cfg = got["qwen-7b-chat"]
    assert (fam, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size, cfg.qkv_bias) == (
        "qwen", 32, 32, 128, 11008, 151936, True)
    fam, cfg = got["baichuan2-7b-chat"]
    assert (fam, cfg.norm_head, cfg.position_embedding, cfg.vocab_size) == (
        "baichuan", True, "rotary", 125696)
    fam, cfg = got["opt-iml-1.3b"]
    assert (fam, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.learned_pos_offset, cfg.activation) == (
        "opt", 24, 32, 64, 2, "relu")
    assert all(c.flash_refusal() is None for _, c in got.values())
    fam, t0 = chip_smoke._family_config(chip_smoke.T0_3B)
    assert (fam, t0.d_model, t0.num_layers, t0.num_decoder_layers, t0.d_ff,
            t0.feed_forward_proj, t0.tie_word_embeddings) == (
        "t5", 2048, 24, 24, 5120, "gated-gelu", False)
    _, base = chip_smoke._family_config(chip_smoke.T5_V1_1_BASE)
    assert (base.d_model, base.num_layers, base.num_heads) == (768, 12, 12)
    _, h2o = chip_smoke._family_config(chip_smoke.H2OGPT_12B)
    assert (h2o.num_heads, h2o.head_dim, h2o.num_layers) == (40, 128, 36)


def test_instruct_cli_roster_covers_every_model():
    from llm_interpretation_replication_tpu_torch.config import (
        instruct_sweep_models)

    names = set(instruct_sweep_models())
    written = {m for m, _, _, _ in chip_smoke.INSTRUCT_SNAPSHOTS} | {
        m for _, _, shared, _ in chip_smoke.INSTRUCT_SNAPSHOTS for m in shared}
    reused = {d.replace("--", "/", 1) for d in chip_smoke.INSTRUCT_REUSED}
    assert names <= written | reused and chip_smoke.INSTRUCT_DENSE <= names
    from_100q = {m.replace("/", "--") for m, _, shared, _ in
                 chip_smoke.CLI_SNAPSHOTS} | {
        s.replace("/", "--") for _, _, shared, _ in chip_smoke.CLI_SNAPSHOTS
        for s in shared}
    assert set(chip_smoke.INSTRUCT_REUSED) <= from_100q
    assert {f for *_, f in chip_smoke.INSTRUCT_SNAPSHOTS} == {
        "t5", "mistral_v03", "bpe", "gpt2", "tiktoken", "sp_bpe"}


def test_t5_helpers_on_the_cpu(one_torch_thread):
    """The teacher forward's top-1 logits at each step are those the
    greedy decode picked from (a float32 model), the target swap moves
    ``shared`` rows and head columns, and popular ids lie past the
    tokenizer."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import t5
    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    small = dict(chip_smoke.T5_V1_1_BASE, d_model=32, d_kv=8, d_ff=64,
                 num_heads=4, num_layers=2, num_decoder_layers=2,
                 vocab_size=1500)
    _, cfg = chip_smoke._family_config(small)
    from llm_interpretation_replication_tpu_torch.models import convert
    weights = convert.random_params(cfg, seed=1, device="cpu", dtype="fp32")
    tok = chip_smoke._question_tokenizer()
    prompts = [tok(q).input_ids for q in ("Is soup a beverage?",
                                          "Is a tweet a publication?")]
    ids, mask = chip_smoke._padded(prompts, "cpu")
    toks, sc = t5.greedy_decode(weights, cfg, ids, mask, 6)
    tgt = [yes_no.target_token_ids(tok, ["Yes", "No"], True)] * 2
    top1, leads, edge, split, edge0, p0 = chip_smoke._t5_teacher(
        weights, cfg, prompts, toks.tolist(), tgt, steps=4)
    np.testing.assert_allclose(top1[:, :6], sc.max(-1).values.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (leads[:, :6] >= 0).all() and np.isfinite(edge).all()
    popular = chip_smoke._t5_popular_ids(weights, cfg, prompts, tok)
    assert popular and all(i >= len(tok) for i in popular)
    before = weights.tree()["lm_head"].clone()
    pairs = chip_smoke._t5_swap_targets(weights, tok,
                                        dict(zip(("Yes", "No"), popular)))
    a, b = pairs[0]
    assert a == tok("Yes").input_ids[0]
    torch.testing.assert_close(weights.tree()["lm_head"][:, a], before[:, b])


def test_instruct_phase_drives_the_sweeps():
    src = inspect.getsource(chip_smoke.instruct_phase)
    assert "instruct_sweep._score_model" in src
    assert "run_base_vs_instruct_word_meaning" in src
    assert "families_phase(seed, attention, card, instruct=True)" in src
    fam_src = inspect.getsource(chip_smoke.families_phase)
    assert "FAMILY_LAYERS" in fam_src and "_score_model" in fam_src
    assert {r for *_, r in chip_smoke.INSTRUCT_DECODERS} == {("flash", "xla")}
    cli = inspect.getsource(chip_smoke._run_instruct)
    assert '"--attention-impl", "flash", "--quant", "int8"' in cli


# -- the packed and K-decode phases ---------------------------------------------

def test_sweep_packs_cover_the_corpus_in_order():
    """The packed phase's corpus: every sweep row's binary prompt and
    target pair in row order, packed PACK_Q at a time as
    ``scoring.packed.build_packs`` packs them (demonstrations between
    questions, none after a pack's last)."""
    from llm_interpretation_replication_tpu_torch.scoring import packed

    scenarios, _, _, _ = _tiny_sweep(per=6)
    prompts, targets, packs = chip_smoke.sweep_packs(scenarios,
                                                     chip_smoke.PACK_Q)
    assert len(prompts) == len(targets) == 30
    assert prompts[7] == (f"{scenarios[1]['rephrasings'][1]} "
                          f"{scenarios[1]['response_format']}")
    assert targets[7] == list(scenarios[1]["target_tokens"])
    assert packs == packed.build_packs(prompts, chip_smoke.PACK_Q)
    assert [len(p) for p in packs] == [4] * 7 + [2]
    assert [q for p in packs for q, _ in p] == prompts
    assert all(d is None for p in packs for _, d in p[-1:])
    demos = ["No"] * 30
    assert chip_smoke.sweep_packs(scenarios, 2, demos)[2][0][0][1] == \
        packed.format_demo("No")


def test_causal_launches_sum_every_run_once():
    slice_res = dict(kernel_launches=96, forced_routes={"launches": 32})
    runs = dict(runs=[dict(kernel_launches=32), dict(run="unfused"),
                      dict(kernel_launches=0)])
    assert chip_smoke.causal_launches(slice_res, runs, dict(runs=[]),
                                      dict(models=[])) == 128
    assert chip_smoke.causal_launches() == 0


def test_main_counts_the_new_phases_launches():
    """The ``kernels`` line's causal count takes the packed and K-decode
    phases' runs, which run on the slice's weights before they are freed."""
    src = inspect.getsource(chip_smoke.main)
    assert "causal_launches(sres, pres, fres, ires, wres, pkres, kres" in src
    assert src.index("packed_phase") < src.index("del weights")
    assert src.index("k_decode_phase") < src.index("del weights")


def test_oracle_engine_replays_the_k1_chain(one_torch_thread):
    """The oracle subclass on the CPU: every speculative block accepted,
    steps saved, and the K=1 rows (float32: bit for bit here)."""
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    scenarios, tok, cfg, weights = _tiny_sweep(per=2)
    prompts, targets, _ = chip_smoke.sweep_packs(scenarios, 1)
    ecfg = emod.EngineConfig(batch_size=4, max_new_tokens=12)
    ref = emod.ScoringEngine("falcon", cfg, weights, tok, device="cpu",
                             engine_config=ecfg).score_prompts(prompts,
                                                               targets)
    cls = chip_smoke.oracle_engine(emod, decoder, decode_k=3)
    eng = cls("falcon", cfg, weights, tok, device="cpu",
              engine_config=dataclasses.replace(ecfg, decode_k=3))
    assert decoder.k_head_num_heads(eng.k_head) == 2
    telemetry.clear_counters()
    got = eng.score_prompts(prompts, targets)
    c = telemetry.counters()
    assert got == ref
    assert c["k_blocks_proposed"] > 0 and c.get("k_blocks_rejected", 0) == 0
    assert c["k_steps_saved"] > 0


def test_position0_partings_gate():
    rows = [(0.2, 0.1, 2 / 3), (0.0, 0.1, 0.0), (0.3, 0.25, 0.545)]
    edge, split = [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]
    stats, fails = chip_smoke._position0_partings("t", rows, rows, edge,
                                                  split, 0.1)
    assert not fails and stats["exactly_equal"] == 3
    moved = [(0.2, 0.0, 1.0), (0.0, 0.1, 0.0), (0.25, 0.3, 0.455)]
    _, fails = chip_smoke._position0_partings("t", moved, rows, edge, split,
                                              0.1)
    assert len(fails) == 3          # a crossing, a flip, a move past 0.05
    _, fails = chip_smoke._position0_partings(
        "t", moved, rows, [0.05, 1.0, 0.05], [1.0, 1.0, 0.05], 0.1)
    assert not fails                # each inside the tie


def test_k_decode_phase_runs_its_routes():
    src = inspect.getsource(chip_smoke.k_decode_phase)
    for call in ('run("k1", engine())', 'run("distilled", distilled)',
                 'run("oracle", engine(oracle_cls, decode_k=K_DECODE))',
                 'run("forced_rejection", rejecting)',
                 'run("k1_int8kv", engine(kv_dtype="int8"))',
                 '"oracle_int8kv"', "distill_k_head_on(sample)",
                 "init_k_head("):
        assert call in src, call


def test_tokenizers_phase_runs_on_the_slice_weights():
    """Phase 19 runs after the obs phase, before the slice's weights are
    freed, and its prefills count in the ``kernels`` line."""
    src = inspect.getsource(chip_smoke.main)
    assert src.index("obs_phase") < src.index("tokenizers_phase") < \
        src.index("del weights")
    assert "ores,\n                             tres," in src
    assert "tokenizers=tres" in src
    phase = inspect.getsource(chip_smoke.tokenizers_phase)
    assert "run_model_perturbation_sweep" in phase
    assert 'toks["falcon"]' in phase and "FALCON_7B_GEOMETRY" in phase
    assert set(chip_smoke.TOKENIZER_DIGESTS) == set(chip_smoke.TOKENIZER_FORMATS)


def test_sweep_phase_runs_on_the_first_layers(one_torch_thread):
    """The sweep phase's weights are views of the slice's first
    SWEEP_LAYERS layers: nothing copied, the embedding shared (the boosted
    runs scale and restore it in place)."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import config, convert
    from llm_interpretation_replication_tpu_torch.models import decoder

    cfg = config.DecoderConfig(**config.FLAGSHIP_SMALL_GEOMETRY)
    full = convert.random_params(cfg, seed=0, device="cpu", dtype="fp32")
    cut = chip_smoke._first_layers(full, 2)
    assert cut.cfg.num_layers == 2 and chip_smoke.SWEEP_LAYERS == 2
    whole = dict(decoder._flatten(full.tree()))
    for path, t in decoder._flatten(cut.tree()):
        assert t.data_ptr() == whole[path].data_ptr(), path
        if path[0] == "layers":
            assert t.shape[0] == 2 and torch.equal(t, whole[path][:2])
        else:
            assert t.shape == whole[path].shape
    src = inspect.getsource(chip_smoke.sweep_phase)
    assert "_first_layers(full_weights, SWEEP_LAYERS)" in src
    assert "_top1_rounding(weights, cfg, scenarios, tok, base)" in src


def test_cli_snapshots_carry_the_published_formats():
    """The run-100q and run-instruct-sweep snapshots of Falcon, BLOOM and
    Mistral (v0.1/v0.2, v0.3), the T5 models and Baichuan2 (its
    SentencePiece ``tokenizer.model``) are written in their published
    counterparts' tokenizer formats; the CLI phase's Falcon snapshot
    too."""
    models = {m for m, *_ in chip_smoke.CLI_SNAPSHOTS}
    assert chip_smoke.CLI_TOKENIZERS == {
        "tiiuae/falcon-7b": "falcon", "bigscience/bloom-7b1": "bloom",
        "mistralai/Mistral-7B-Instruct-v0.2": "llama"}
    assert set(chip_smoke.CLI_TOKENIZERS) <= models
    inst = {m: f for m, _, _, f in chip_smoke.INSTRUCT_SNAPSHOTS}
    assert inst["allenai/tk-instruct-3b-def"] == "t5"
    assert inst["mistralai/Mistral-7B-Instruct-v0.3"] == "mistral_v03"
    assert inst["baichuan-inc/Baichuan2-7B-Chat"] == "sp_bpe"
    assert set(chip_smoke.CLI_TOKENIZERS.values()) | {
        "t5", "mistral_v03", "sp_bpe", "sp_unigram"} \
        == set(chip_smoke.TOKENIZER_FORMATS)
    assert '_format_tokenizer_files("falcon", texts)' in inspect.getsource(
        chip_smoke.cli_phase)


# -- the serve phase and its CLI leg -------------------------------------------

def test_serve_phase_runs_its_legs_and_gates():
    src = inspect.getsource(chip_smoke.serve_phase)
    for leg in ("replay", "prefix", "oom", "pool", "roles", "supervise",
                "load"):
        assert f'("{leg}", {leg}_leg)' in src, leg
    for gate in ("blocked_transfers", "strict.activate(sentry=False)",
                 "serve_slot_admitted", "set_per_process_memory_fraction",
                 "serve_oom_split", "build_shared_pool", "pool.unload(rid)",
                 "SERVE_MEMORY_SLACK", 'kv_dtype="int8"', 'role="prefill"',
                 'role="decode"', "made[0].kill()", "wedged.wedge()",
                 "restart_ms", 'mode="closed"', "sload.rate_sweep",
                 "SERVE_LOAD_FRACTIONS", "_vs_offline", "_top_tokens",
                 'attention_impl="flash"', "FALCON_7B_GEOMETRY"):
        assert gate in src, gate
    assert chip_smoke.SERVE_LOAD_FRACTIONS == (0.25, 0.5, 0.9)
    assert chip_smoke.SERVE_LOAD_S == 1.0
    assert (chip_smoke.SERVE_REPLAY_PROMPTS, chip_smoke.SERVE_PREFIX_PAIRS,
            chip_smoke.SERVE_POOL_PROMPTS) == (192, 16, 24)
    assert chip_smoke.SERVE_MEMORY_SLACK == 64 << 20


def test_serve_cli_phase_drives_every_mode():
    src = inspect.getsource(chip_smoke.serve_cli_phase)
    for flag in ('"--strict"', '"--metrics-port"', '"--replay"',
                 '"--load-rate"', '"--pool-replicas", "2"', '"--supervise"',
                 '"--attention-impl", "flash"', "/healthz", "/metrics",
                 "JSONDecodeError", "parity_ok"):
        assert flag in src, flag
    assert len(chip_smoke.SERVE_CLI_RATES) == 3
    assert chip_smoke.SERVE_CLI_LOAD_S == 1.0
    assert chip_smoke.SERVE_CLI_LINES == 64


def test_main_counts_the_serve_phases_launches():
    """The serve phase runs on the slice's weights before they are freed,
    its CLI leg after the CLI phases, and both count in the ``kernels``
    line's causal launches."""
    src = inspect.getsource(chip_smoke.main)
    assert "tres, cres, fam, inst, svres, svcli, apres)" in src
    assert src.index("tokenizers_phase") < src.index("serve_phase") < \
        src.index("del weights")
    assert src.index("obs_cli_phase") < src.index("serve_cli_phase")
    assert 'pool_inputs = pres.pop("inputs")' in src
    serve_res = dict(runs=[dict(run="replay", kernel_launches=64),
                           dict(run="oom", kernel_launches=40)])
    cli_res = dict(runs=[dict(run="jsonl", kernel_launches=4)])
    assert chip_smoke.causal_launches(serve_res, cli_res) == 108


def test_k_decode_phase_runs_on_the_first_layers():
    src = inspect.getsource(chip_smoke.k_decode_phase)
    assert "_first_layers(full_weights, K_DECODE_LAYERS)" in src
    assert "near_tie = NEAR_TIE_FACTOR" in src
    assert chip_smoke.K_DECODE_LAYERS == 2
    assert "fres[\"near_tie\"], card)" not in inspect.getsource(
        chip_smoke.main)


def test_vs_offline_gates_every_row_exactly():
    rows = [dict(scan_found=True, relative_prob=0.5, yes_prob=0.1),
            dict(scan_found=False, relative_prob=0.25, yes_prob=0.2)]
    fails = []
    stats = chip_smoke._vs_offline("t", rows, [dict(r) for r in rows],
                                   lambda a, b: a == b, fails)
    assert not fails and stats["bit_identical_rows"] == 2
    moved = [rows[0], dict(rows[1], yes_prob=0.2 + 1e-9)]
    stats = chip_smoke._vs_offline("t", moved, rows, lambda a, b: a == b,
                                   fails)
    assert stats["bit_identical_rows"] == 1 and len(fails) == 1
    assert "'yes_prob'" in fails[0] and "first [(1," in fails[0]


def test_obs_and_tokenizer_sweeps_run_on_the_first_layers():
    """The obs phase and the tokenizers phase's sweep run on views of the
    slice's first OBS_LAYERS layers (the smoke's time)."""
    assert chip_smoke.OBS_LAYERS == 2
    assert "_first_layers(full_weights, OBS_LAYERS)" in inspect.getsource(
        chip_smoke.obs_phase)
    assert "_first_layers(weights, OBS_LAYERS)" in inspect.getsource(
        chip_smoke.tokenizers_phase)


def test_main_runs_the_api_phase_on_the_slice_weights():
    """The api phase runs after the serve phase's CLI leg, on the slice's
    weights before they are freed, and its runs count in the ``kernels``
    line's causal launches."""
    src = inspect.getsource(chip_smoke.main)
    assert src.index("serve_cli_phase") < src.index("api_phase") < \
        src.index("del weights") < src.index("families_phase")
    assert "api=apres" in src
    res = dict(runs=[dict(run="corpus", kernel_launches=256),
                     dict(run="pool", kernel_launches=96)])
    assert chip_smoke.causal_launches(res) == 352


def test_api_phase_constants_and_legs():
    src = inspect.getsource(chip_smoke.api_phase)
    for piece in ('"generate-irrelevant"', "IRRELEVANT_CORPUS_SHA256",
                  "RemoteBackend", "strict.activate", "BLOCKED_COUNTER",
                  "rows_equal", "_api_host_leg", "decided_share",
                  "tokens_median", "rows_per_s"):
        assert piece in src, piece
    child = inspect.getsource(chip_smoke._api_host_child)
    for cmd in ("run-api-perturbation", "run-claude-perturbation",
                "run-gpt-perturbation", "run-gemini-perturbation",
                "generate-rephrasings", "repair-batch",
                "is_initialized", '"pandas"'):
        assert cmd in child, cmd
    assert chip_smoke.API_BUDGET_S == 40.0
    assert chip_smoke.API_CORPUS_ROWS == 256
    assert chip_smoke.IRRELEVANT_CORPUS_ROWS == 3400
    assert (chip_smoke.API_SWEEP_SCENARIOS,
            chip_smoke.API_SWEEP_REPHRASINGS) == (2, 5)


@pytest.mark.parametrize("text", [
    "Is a tent a building? Answer only 'Yes' or 'No'.",
    "How confident are you that the answer is Yes?", ""])
def test_api_scripted_answers_are_deterministic(text):
    """The scripted vendors answer from the prompt alone: a confidence
    prompt a two-digit number with its digits' candidates, a binary one
    the best of API_ANSWER_TOKENS."""
    import math

    a, positions = chip_smoke._api_answer(text)
    assert (a, positions) == chip_smoke._api_answer(text)
    if "confident" in text:
        assert a.isdigit() and len(a) == 2 and len(positions) == 2
        assert [p[0][0] for p in positions] == list(a)
    else:
        assert a in chip_smoke.API_ANSWER_TOKENS and len(positions) == 1
        assert positions[0][0][0] == a
        assert sum(math.exp(lp) for _, lp in positions[0]) == \
            pytest.approx(1.0)


# -- the other decoder families (phase other_families) ---------------------------------

_SMALL_OTHER = {
    "qwen2": dict(hidden_size=32, intermediate_size=64, num_attention_heads=4,
                  num_key_value_heads=2),
    "gptj": dict(n_embd=32, n_head=4, rotary_dim=4),
    "mpt": dict(d_model=32, n_heads=4),
    "glm": dict(hidden_size=32, intermediate_size=64, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8),
    "chatglm": dict(hidden_size=32, ffn_hidden_size=64, num_attention_heads=4,
                    kv_channels=8, padded_vocab_size=96),
}
_HF_OTHER = {"qwen2": "Qwen2", "gptj": "GPTJ", "mpt": "Mpt", "glm": "Glm"}


def _small_other(config):
    return dict(config, vocab_size=96, **_SMALL_OTHER[config["model_type"]])


@pytest.mark.parametrize("label", [m[0] for m in chip_smoke.OTHER_FAMILY_MODELS])
def test_other_family_state_dicts_are_the_hf_models_and_convert(
        label, one_torch_thread):
    """Each other family's random checkpoint: the converter reads every
    tensor it holds and finds every one it asks for, and (but ChatGLM,
    remote code only) its names and shapes are the HF model's of the same
    narrowed config."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import convert

    config = next(c for lab, _, c, _ in chip_smoke.OTHER_FAMILY_MODELS
                  if lab == label)
    small = _small_other(config)
    family, cfg = chip_smoke._family_config(small, layers=2)
    assert cfg.num_layers == 2
    sd = chip_smoke._hf_state_dict(family, cfg, 0, "cpu", torch.float32)
    read = set()

    def get(name):
        read.add(name)
        return sd[name]

    tree = convert.CONVERTERS[family](get, cfg)
    assert read == set(sd)
    assert tree["layers"]["attn"]["wk"].shape == (
        2, cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim)
    stem = _HF_OTHER.get(small["model_type"])
    if stem is None:
        return
    import transformers

    hf_kw = {k: v for k, v in chip_smoke._at_depth(small, 2).items()
             if k not in ("model_type", "bos_token_id", "eos_token_id")}
    hf_kw["pad_token_id"] = 0        # the published ids lie past 96
    model = getattr(transformers, f"{stem}ForCausalLM")(
        getattr(transformers, f"{stem}Config")(**hf_kw))
    ref = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if v.is_floating_point() and not (
               k == "lm_head.weight" and cfg.tie_word_embeddings)}
    assert {k: tuple(v.shape) for k, v in sd.items()} == ref


def test_other_published_configs_translate():
    """The five published geometries of the phase's table."""
    got = {label: chip_smoke._family_config(config)
           for label, _, config, _ in chip_smoke.OTHER_FAMILY_MODELS}
    fam, cfg = got["qwen2-7b"]
    assert (fam, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.intermediate_size, cfg.vocab_size, cfg.qkv_bias,
            cfg.sliding_window) == ("llama", 3584, 28, 4, 18944, 152064,
                                    True, None)
    fam, cfg = got["gpt-j-6b"]
    assert (fam, cfg.hidden_size, cfg.num_heads, cfg.head_dim,
            cfg.vocab_size, cfg.rotary_pct * cfg.head_dim,
            cfg.rotary_style) == ("gptj", 4096, 16, 256, 50400, 64,
                                  "interleaved")
    fam, cfg = got["mpt-7b-instruct"]
    assert (fam, cfg.hidden_size, cfg.num_heads, cfg.vocab_size,
            cfg.position_embedding, cfg.qkv_bias, cfg.mlp_bias) == (
        "mpt", 4096, 32, 50432, "alibi", False, False)
    fam, cfg = got["glm-4-9b-chat-hf"]
    assert (fam, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.intermediate_size, cfg.vocab_size,
            cfg.rotary_pct) == ("glm", 4096, 32, 2, 128, 13696, 151552, 0.5)
    fam, cfg = got["chatglm3-6b"]
    assert (fam, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.intermediate_size, cfg.vocab_size) == (
        "chatglm", 4096, 32, 2, 128, 13696, 65024)
    routes = {label: r for label, _, _, r in chip_smoke.OTHER_FAMILY_MODELS}
    assert routes.pop("mpt-7b-instruct") == ("xla",)
    assert set(routes.values()) == {("flash", "xla")}
    kernel = {(k, label): (n, g, d) for k, label, _, _, n, g, d
              in chip_smoke.FAMILY_KERNEL_SHAPES}
    assert kernel[("causal_grouped_attention", "gpt-j-6b")] == (16, 16, 256)
    assert {k for k, label in kernel if label == "gpt-j-6b"} == \
        set(chip_smoke.KERNEL_NAMES)
    assert chip_smoke.WIDE_HEAD_DIM in chip_smoke.EDGE_DIMS


@pytest.mark.parametrize("label", ["gpt-j-6b", "mpt-7b-instruct",
                                   "chatglm3-6b"])
def test_snapshot_round_trip_loads_the_written_tensors(label, tmp_path,
                                                       one_torch_thread):
    """A narrowed snapshot of each writer goes through the port's loader to
    the converter's tree, bit for bit, and is deleted after."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.runtime import loader

    config = _small_other(next(c for lab, _, c, _ in
                               chip_smoke.OTHER_FAMILY_MODELS if lab == label))
    family, cfg = chip_smoke._family_config(config, chip_smoke.FAMILY_LAYERS)
    sd = chip_smoke._hf_state_dict(family, cfg, 0, "cpu", torch.bfloat16)
    tree = convert.CONVERTERS[family](sd.__getitem__, cfg)
    fails = []
    snap = str(tmp_path / label)
    got, sizes = chip_smoke._snapshot_round_trip(
        loader, snap, config, family, cfg, sd, tree, fails, device="cpu")
    assert fails == [] and not os.path.exists(snap)
    assert sizes["bytes"] > sum(t.numel() * 2 for t in sd.values())
    bad = []
    chip_smoke._snapshot_round_trip(
        loader, snap, config, family, cfg,
        {k: v + 1 if k == next(iter(sd)) else v for k, v in sd.items()},
        tree, bad, device="cpu")
    assert len(bad) == 1


def test_main_runs_other_families_and_counts_their_launches():
    """The other_families phase runs after phase 12 in main, its runs count
    in the causal total, and the kernels line adds each kernel's D=256
    instance from its GPT-J runs."""
    src = inspect.getsource(chip_smoke.main)
    assert src.index('timed("families"') < src.index('"other_families"') \
        < src.index('timed("run_100q"')
    assert "causal_launches(oth)" in src
    assert "WIDE_HEAD_DIM" in src and 'forced_routes"' in src


def test_kernels_line_lists_each_kernel_and_its_wide_instance():
    """Six entries with every key of the contract: each kernel over all
    its rows at the Falcon-7B row's times, then its D=256 instance over
    its D=256 rows at GPT-J-6B's."""
    rows = []
    for i, (name, *_rest) in enumerate(chip_smoke.KERNELS):
        for shape, d, err in (("falcon-7b", 64, 0.001), ("gpt-j-6b", 256,
                                                         0.002 + i)):
            rows.append(dict(kernel=name, shape=shape, D=d, causal=True,
                             max_abs_err=err, ms=d / 1e3, plain_ms=1.0,
                             bound_ms=0.5, bound_by="bytes",
                             library_ms=2.0))
        rows.append(dict(kernel=name, D=128, causal=False, max_abs_err=0.005))
    launches = dict.fromkeys(chip_smoke.KERNEL_NAMES, 34)
    wide = dict.fromkeys(chip_smoke.KERNEL_NAMES, 2)
    got = chip_smoke.kernels_line(rows, launches, wide)
    assert [k["name"] for k in got] == chip_smoke.KERNEL_NAMES + [
        f"{n}[D=256]" for n in chip_smoke.KERNEL_NAMES]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(set(k) == keys for k in got)
    assert [k["ms"] for k in got] == [0.064] * 3 + [0.256] * 3
    assert [k["launches"] for k in got] == [34] * 3 + [2] * 3
    assert [k["max_abs_err"] for k in got[3:]] == [0.002, 1.002, 2.002]
    assert got[0]["max_abs_err"] == 0.005


def _small_point(kind="full", before=1 << 30, **kw):
    from llm_interpretation_replication_tpu_torch.models import config

    cfg = config.DecoderConfig(**config.FLAGSHIP_SMALL_GEOMETRY)
    return chip_smoke._plan_point(kind, cfg, 32, 256, before, **kw)


@pytest.mark.parametrize("kind,kw", [
    ("full", dict(pooled=True)), ("full", dict(chunk=64, kv="int8")),
    ("full", dict(decode_k=4, weights_in_run=True)), ("binary", {}),
    ("packed", dict(packing=4)), ("prefill", dict(chunk=128))])
def test_plan_memory_check_fails_a_need_below_the_peak(kind, kw):
    """(b)'s gate: a recorded peak above the budget model's need fails the
    phase, one within it passes; the ratio is the need over the peak."""
    point = _small_point(kind, **kw)
    need, terms = chip_smoke._plan_need(point)
    predicted = need if kw.get("weights_in_run") else need - terms["weights"]
    base = point["memory_before_bytes"]
    for measured, ok in ((predicted, True), (predicted + 1, False),
                         (predicted // 2, True)):
        rows, fails = chip_smoke.plan_memory_check(dict(phase=dict(runs=[
            dict(peak_memory_bytes=base + measured, plan_point=point)])))
        assert bool(fails) == (not ok)
        assert rows[0]["ratio"] == predicted / measured
        assert rows[0]["point"] == "/phase/runs[0]"


def test_plan_memory_check_prices_every_decoder_peak():
    """A run that records a peak must carry its plan point, but for T5's
    (the budget model prices decoders); a run listed twice counts once."""
    run = dict(peak_memory_bytes=(1 << 30) + (1 << 20),
               plan_point=_small_point())
    t5 = dict(route="t5", model="t0-3b", peak_memory_bytes=1 << 30)
    rows, fails = chip_smoke.plan_memory_check(dict(
        families=dict(models=[dict(runs=[run])], runs=[run]),
        instruct=dict(runs=[t5])))
    assert [r["kind"] for r in rows] == ["full", "unpriced"] and not fails
    rows, fails = chip_smoke.plan_memory_check(dict(x=dict(runs=[
        dict(route="flash", peak_memory_bytes=1)])))
    assert fails and "without its plan point" in fails[0]


def _searched_run(**kw):
    run = dict(oom_steps=0, measured_bytes=20 << 30,
               predicted_need_bytes=30 << 30, hbm_bytes=80 << 30,
               batch_size=512, kv_dtype="bf16", prefill_chunk=0, decode_k=4,
               plan_lines=["# plan search chose mesh dp1xtp1 batch 512"],
               forwards=4, kernel_launches=128, layers=32)
    run.update(kw)
    return run


@pytest.mark.parametrize("kw,fails", [
    ({}, 0), (dict(oom_steps=1), 1), (dict(measured_bytes=31 << 30), 1),
    (dict(predicted_need_bytes=81 << 30), 1), (dict(batch_size=256), 1),
    (dict(plan_lines=[]), 1), (dict(kernel_launches=127), 1),
    (dict(forwards=0, kernel_launches=0), 1)])
def test_plan_searched_run_gates(kw, fails):
    """(c)'s gates: an OOM step, a peak above the predicted need, a need
    above the card, another plan than the chosen one, or a prefill without
    its causal launch a layer fails the phase."""
    chosen = dict(batch=512, kv_dtype="bf16", prefill_chunk=0, decode_k=4)
    assert len(chip_smoke.plan_run_fails(_searched_run(**kw), chosen)) == fails


def test_every_phase_that_records_a_peak_records_its_plan_point():
    """Each phase function that resets the peak-memory counter records the
    operating point the budget model prices, but for T5's scoring
    (instruct_phase), the plan phase's own run, the train phase (the
    budget model prices scoring, not training) and the mesh phase's gloo
    ranks (two processes share the one card: a rank's peak is not a
    device's need)."""
    src = inspect.getsource(chip_smoke)
    tree = ast.parse(src)
    missing = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        body = ast.get_source_segment(src, fn)
        if "reset_peak_memory_stats()" in body and "_plan_point(" not in body:
            missing.append(fn.name)
    assert sorted(missing) == ["_mesh_rank_runs", "_plan_searched_run",
                               "instruct_phase", "train_phase"]


def test_main_runs_the_plan_phase_last_and_counts_its_launches():
    """The plan phase runs after every other phase (it holds the budget
    model to their recorded peaks), within its own budget, and its searched
    run's causal launches count in the kernels line."""
    src = inspect.getsource(chip_smoke.main)
    assert src.index('timed("stats"') < src.index('timed("plan"')
    assert 'plres["searched_run"]["kernel_launches"]' in src
    assert "plan=plres" in src
    assert chip_smoke.PLAN_BUDGET_S == 55.0
    assert (chip_smoke.PLAN_QUANT, chip_smoke.PLAN_IMPL) == ("int8", "flash")
    phase = inspect.getsource(chip_smoke.plan_phase)
    for piece in ('"search"', "plan_memory_check", "_plan_searched_run",
                  "plan_run_fails", "PLAN_BUDGET_S", "device_memory_bytes"):
        assert piece in phase, piece
    run = inspect.getsource(chip_smoke._plan_searched_run)
    for piece in ('"--plan-search"', "PLAN_QUANT", "PLAN_IMPL",
                  "fault_events", "FALCON_7B_GEOMETRY"):
        assert piece in run, piece


def _train_result(**changes):
    res = dict(
        falcon_7b=dict(step1_changed=[], losses=[11.09, 11.09, 11.05, 10.98],
                       step2_missing=[], step2_nonfinite=[], step2_norm=3.2),
        card_vs_cpu=dict(card_losses=[11.0968, 11.0968],
                         cpu_losses=[11.0968, 11.0968], grad_rel_l2=2e-6),
        guard=dict(raised=True), seq_parallel=dict(ring=3e-7, ulysses=2e-7),
        pipelined=dict(kernel_launches=64, layers=32, microbatches=2,
                       logits_rel_l2_vs_fp32=0.0101,
                       dense_rel_l2_vs_fp32=0.0100),
        seconds=30.0)
    for key, value in changes.items():
        part, _, field = key.partition("__")
        if field:
            res[part] = dict(res[part], **{field: value})
        else:
            res[part] = value
    return res


@pytest.mark.parametrize("changes,fails", [
    ({}, 0),
    (dict(falcon_7b__step1_changed=["layers/attn/wq"]), 1),
    (dict(falcon_7b__losses=[11.09, float("nan"), 11.05, 10.98]), 1),
    (dict(falcon_7b__losses=[11.09, 11.0, 11.05, 11.01]), 1),
    (dict(falcon_7b__step2_missing=["layers/ln1/bias"]), 1),
    (dict(falcon_7b__step2_nonfinite=["lm_head"]), 1),
    (dict(falcon_7b__step2_norm=0.0), 1),
    (dict(guard__raised=False), 1),
    (dict(card_vs_cpu__card_losses=[11.0968, 11.1]), 1),
    (dict(card_vs_cpu__grad_rel_l2=2e-4), 1),
    (dict(pipelined__kernel_launches=63), 1),
    (dict(pipelined__logits_rel_l2_vs_fp32=0.013), 1),
    (dict(seq_parallel__ulysses=1e-3), 1),
    (dict(seconds=46.0), 1)])
def test_train_phase_gates(changes, fails):
    """The train phase fails on a parameter changed at step 1 (lr 0), a
    NaN loss or no fall from loss 2 to loss 4, a leaf with no gradient or
    a non-finite one at step 2, a kernel guard that does not raise, the
    card parting from the CPU, a pipelined forward without its launch a
    layer a microbatch or off the forced-route tolerance, ring or Ulysses
    off dense attention, or a run past its budget."""
    assert len(chip_smoke.train_run_fails(_train_result(**changes))) == fails


def test_grad_check_names_missing_and_nonfinite_leaves():
    import torch

    params = {"a": torch.ones(2), "b": {"c": torch.ones(3), "d": torch.ones(1)}}
    grads = {"a": torch.tensor([0.5, 0.0]),
             "b": {"c": torch.zeros(3), "d": torch.tensor([float("inf")])}}
    assert chip_smoke._grad_check(grads, params) == (["b/c"], ["b/d"])
    del grads["b"]["c"]
    assert chip_smoke._grad_check(grads, params)[0] == ["b/c"]


def test_train_batch_is_padded_corpus_text(one_torch_thread):
    """The train phase's batch: corpus texts under a WordTokenizer, cut or
    right-padded to the sequence, every id inside Falcon-7B's vocab."""
    from llm_interpretation_replication_tpu_torch.models import config

    ids, mask, vocab = chip_smoke._train_batch(4, 128, "cpu")
    assert ids.shape == mask.shape == (4, 128)
    assert 0 < int(mask.sum()) <= 4 * 128 and vocab < 65024
    assert int(ids.max()) < config.FALCON_7B_GEOMETRY["vocab_size"]
    lengths = mask.sum(-1)
    for row, n in enumerate(lengths.tolist()):
        assert mask[row, :n].all() and not mask[row, n:].any()
        assert not ids[row, n:].any()


def test_main_runs_the_train_phase_last_and_counts_its_launches():
    """The train phase runs after the plan phase, within its own budget,
    and its pipelined forward's causal launches count in the kernels
    line."""
    src = inspect.getsource(chip_smoke.main)
    assert src.index('timed("plan"') < src.index('timed("train"')
    assert 'trres["pipelined"]["kernel_launches"]' in src
    assert "train=trres" in src
    assert chip_smoke.TRAIN_BUDGET_S == 45.0
    assert (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ,
            chip_smoke.TRAIN_STEPS) == (4, 128, 4)
    phase = inspect.getsource(chip_smoke.train_phase)
    for piece in ("initialize_distributed", "file://", "make_mesh()",
                  "FALCON_7B_GEOMETRY", "train_run_fails", "allow_tf32",
                  "destroy_process_group"):
        assert piece in phase, piece
    steps = inspect.getsource(chip_smoke._falcon_train_steps)
    for piece in ("make_optimizer(1e-4, warmup_steps=1, total_steps=10)",
                  'dtype="bf16"', "NotImplementedError", "on_grads"):
        assert piece in steps, piece


def test_bit_fingerprints_see_one_changed_bit():
    """(b)'s step-1 gate: the fingerprint of an unchanged tree is equal,
    and one element changed anywhere (a sign bit: -0.0 for 0.0 too) moves
    its leaf's, across the runs the sums are taken in."""
    import torch

    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(5, 7, generator=gen).to(torch.bfloat16),
            "b": {"c": torch.zeros(300, dtype=torch.bfloat16)}}
    before = chip_smoke._bit_fingerprints(tree, run=64)
    assert chip_smoke._bit_fingerprints(tree, run=64) == before
    assert chip_smoke._bit_fingerprints(tree, run=1 << 20) == before
    for path, index, value in ((("a",), (3, 4), None),
                               (("b", "c"), (299,), -0.0),
                               (("b", "c"), (0,), 2.0 ** -133)):
        leaf = tree[path[0]] if len(path) == 1 else tree["b"]["c"]
        old = leaf[index].clone()
        leaf[index] = -leaf[index] if value is None else value
        after = chip_smoke._bit_fingerprints(tree, run=64)
        assert [p for p in before if after[p] != before[p]] == [path]
        leaf[index] = old
    assert chip_smoke._bit_fingerprints(tree, run=64) == before


# -- the scoring engine on a mesh (phase 26) ------------------------------------

def test_main_runs_the_mesh_phase_after_train_and_counts_its_launches():
    """Phase 26 runs after the train phase, on its world of one, within
    its own budget, and (a)'s causal launches count in the kernels line."""
    src = inspect.getsource(chip_smoke.main)
    assert src.index('timed("train"') < src.index('timed("mesh"')
    assert 'mres["a"]["kernel_launches"]' in src and "mesh=mres" in src
    assert chip_smoke.MESH_BUDGET_S == 80.0
    assert chip_smoke.MESH_PROMPTS == chip_smoke.BATCH
    phase = inspect.getsource(chip_smoke.mesh_phase)
    for piece in ("make_mesh()", "destroy_process_group", "start_processes",
                  "mesh_run_fails", "mesh_leg_fails", 'kv_dtype="int8"'):
        assert piece in phase, piece
    assert "bind_mesh" in inspect.getsource(chip_smoke._mesh_engine)
    assert 'quant="int8"' in inspect.getsource(chip_smoke._mesh_small)


def _mesh_ranks(rows, heads=((71, 71), (36, 35))):
    probe = dict(all_reduce=[3.0] * 4, all_gather=[[0.0, 0.0], [1.0, 1.0]])
    return [dict(probe=probe, runs={
        name: dict(heads=[h[rank]] * chip_smoke.FAMILY_LAYERS, rows=rows)
        for name, h in zip(("dp2", "tp2"), heads)}) for rank in (0, 1)]


@pytest.mark.parametrize("change,fails", [
    (None, 0),
    ("flip", 4),                 # each shape's row 0 on both ranks
    ("far", 4),
    ("near", 0),                 # within MESH_W8A8_RTOL
    ("heads", 2),
    ("left_out", 4),             # no probe and no runs on either rank
])
def test_mesh_phase_gates(change, fails):
    """(b)'s gates: a verdict that differs from the world of one's, a
    probability beyond the w8a8 class or a rank's prefill at other heads
    fails, and so does a rank that brought back no probe or no runs."""
    ref = [[True, 0.5, 0.2, 0.2], [False, 0.25, 0.1, 0.3]]
    rows = [list(r) for r in ref]
    heads = ((71, 71), (36, 35))
    if change == "flip":
        rows[0][0] = False
    elif change == "far":
        rows[0][1] = 0.6
    elif change == "near":
        rows[0][1] = 0.5 * (1 + chip_smoke.MESH_W8A8_RTOL / 2)
    elif change == "heads":
        heads = ((71, 71), (35, 36))
    res = _mesh_ranks(rows, heads)
    if change == "left_out":
        res = [dict(probe_error="RuntimeError: no CUDA"), {}]
    assert len(chip_smoke.mesh_run_fails(res, ref, 71)) == fails


def _mesh_legs(**change):
    """Two ranks' legs (c)-(g) that pass every gate against ``REF`` (the
    world of one's rows on 4 prompts, all in one bucket), with ``change``
    applied to rank ``change.pop("rank", 0)``'s copy."""
    import copy

    rows = [[False, 0.5, 0.1, 0.1]] * 4
    serve = dict(rows=rows, follower=False, engine_calls=2, admitted=2,
                 serve_slot_admitted=2)
    leg = dict(
        c={"dp2": serve, "tp2": serve},
        d=dict(rows=rows, slab_rows=4),
        e=dict(rows=rows, k1_rows=rows, head_digest="x", k_chunks=1,
               k_blocks_proposed=1),
        f=dict(rows=rows, hosted=[["r0"], ["r1"]], health=[
            dict(placement="sliced", devices=1, completed=2)] * 2),
        g=dict(compared_tokens=4, max_abs_err=0.01, dense_max_abs=1.0,
               aux_sharded=1.0, aux_dense=1.0))
    legs = [copy.deepcopy(leg), copy.deepcopy(leg)]
    for r in (0, 1):
        for name in ("dp2", "tp2"):
            legs[r]["c"][name]["follower"] = bool(r)
    rank = change.pop("rank", 0)
    for path, value in change.items():
        *keys, last = path.split("__")
        node = legs[rank]
        for key in keys:
            node = node[key]
        node[last] = value
    return [{"legs": legs[0]}, {"legs": legs[1]}]


@pytest.mark.parametrize("change,fails", [
    ({}, ""),
    ({"c__tp2__admitted": 0, "c__tp2__serve_slot_admitted": 0},
     "mesh (c) tp2: no mid-decode admission"),
    ({"rank": 1, "c__dp2__engine_calls": 3}, "engine_calls 2 vs 3"),
    ({"rank": 1, "c__dp2__follower": False}, "followers"),
    ({"d__rows": [[True, 0.5, 0.1, 0.1]] * 4}, "mesh (d) rank 0 row 0"),
    ({"rank": 1, "e__head_digest": "y"}, "the ranks' K-heads differ"),
    ({"e__k_chunks": 0}, "the K path never ran"),
    ({"f__hosted": [["r0", "r1"], []]}, "mesh (f): hosted"),
    ({"g__max_abs_err": 0.5}, "sharded against dense"),
    ({"rank": 1, "g__aux_sharded": 1.1}, "mesh (g): aux"),
])
def test_mesh_leg_gates(change, fails):
    """Phase 26's gates of (c)-(g) (``mesh_leg_fails``): a passing pair of
    ranks, and each gate failing on its own change."""
    ref = [[False, 0.5, 0.1, 0.1]] * 4
    prompts = [[5] * 100] * 4
    got = chip_smoke.mesh_leg_fails(_mesh_legs(**change), ref, prompts)
    if not fails:
        assert got == []
    else:
        assert any(fails in f for f in got), got


def test_mesh_serve_rows_take_the_fullest_buckets():
    """(c)'s prompts: those of the MESH_SERVE_BUCKETS (3) buckets that hold
    the most prompts (of equal counts, the shorter bucket), in prompt
    order."""
    assert chip_smoke.MESH_SERVE_BUCKETS == 3
    lengths = [100, 300, 100, 500, 300, 100, 700]    # buckets 128, 320,
    prompts = [[1] * n for n in lengths]             # 512 and 768
    assert chip_smoke.mesh_serve_rows(prompts) == [0, 1, 2, 3, 4, 5]
