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
