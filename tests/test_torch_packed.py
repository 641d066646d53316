"""Packed multi-question scoring on the port against the JAX package:
``scoring/packed``, ``decoder.forward_anchor_logits``, ``score_packed``,
``packed_autoregressive_demos`` and ``run_packed_perturbation_sweep``.

Setup: ``FLAGSHIP_SMALL_GEOMETRY`` in float32, the full-study tests' seed-5
weights and byte-level BPE tokenizer (and, for the sweep, the sweep tests'
word tokenizer and seed-7 weights), the same inputs to both packages, the
JAX side on the CPU with its interpret-mode causal kernel.

Classes: packs, anchors, demos and drift blocks identical; ``scan_found``
identical; logits and probabilities rtol 2e-5 (atol 1e-9).  Inside the port
on the CPU, question 0's anchor logits equal the isolated prompt's bit for
bit in a batch of the same shape.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.scoring import packed as jpk
from llm_interpretation_replication_tpu.sweeps import perturbation as jsweep
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.scoring import packed as tpk
from llm_interpretation_replication_tpu_torch.sweeps import perturbation as tsweep
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from test_torch_full_study import engines, text_models, tok
from test_torch_slots import one_torch_thread  # noqa: F401
import test_torch_sweep as sweep_tests

RTOL, ATOL = 2e-5, 1e-9
PROB_FIELDS = ("yes_prob", "no_prob", "relative_prob", "odds_ratio",
               "first_token_yes_prob", "first_token_no_prob",
               "first_token_relative_prob")
ECFG = dict(batch_size=4, decode_completions=False,
            buckets=(32, 64, 96, 128, 192, 256))
# the sweep tests' engines with buckets that hold their packed rows
SWEEP_ECFG = dict(buckets=(32, 64, 128))


def _prompts(n=6):
    return [f"Is item number {i} a beverage? Answer only 'Yes' or 'No'."
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def pair(**kw):
    return engines(**{**ECFG, **kw})


def _rows_match(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"] == ""
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=RTOL, atol=ATOL,
                                       err_msg=f)


# -- formatting and encoding -------------------------------------------------------

class TestPackedEncoding:
    @pytest.mark.parametrize("packing,demos", [
        (1, None), (2, ["Yes", "No", "Yes", "No", "Yes"]), (3, None),
        (4, ["No"] * 5)])
    def test_packs_and_anchors_match_reference(self, packing, demos):
        prompts = _prompts(5)
        packs = tpk.build_packs(prompts, packing, demos)
        assert packs == jpk.build_packs(prompts, packing, demos)
        assert tpk.encode_packs(tok(), packs) == jpk.encode_packs(tok(), packs)

    def test_anchors_point_at_last_prompt_token(self):
        prompts = _prompts(4)
        rows, anchors = tpk.encode_packs(
            tok(), tpk.build_packs(prompts, 2, demos=["Yes"] * 4))
        assert len(rows) == 2 and [len(a) for a in anchors] == [2, 2]
        iso = tok()(prompts[0])["input_ids"]
        assert rows[0][: len(iso)] == list(iso)
        assert anchors[0][0] == len(iso) - 1
        assert anchors[0][-1] == len(rows[0]) - 1

    def test_demo_continuation_between_questions(self):
        (_, d0), (_, d1) = tpk.build_packs(_prompts(2), 2,
                                           demos=["Yes", "No"])[0]
        assert d0 == " Yes.\n\n" == jpk.format_demo("Yes")
        assert d1 is None
        assert tpk.PACKED_SEPARATOR == jpk.PACKED_SEPARATOR

    def test_pre_tokenized_segments_match_reference(self):
        ids = [tok()(p)["input_ids"] for p in _prompts(3)]
        packs = [[(ids[0], [7, 8]), (ids[1], None)], [(ids[2], None)]]
        assert tpk.encode_packs(tok(), packs) == jpk.encode_packs(tok(), packs)
        with pytest.raises(ValueError, match="empty pack"):
            tpk.encode_packs(tok(), [[]])

    def test_build_packs_rejects_bad_packing(self):
        with pytest.raises(ValueError):
            tpk.build_packs(_prompts(2), 0)

    def test_demos_from_relative_probs(self):
        rel = [0.9, 0.1, float("nan"), 0.5]
        pairs = [["Yes", "No"], ["Yes", "No"], ["Yes", "No"], ["No", "Yes"]]
        assert tpk.demos_from_relative_probs(rel, pairs) == \
            jpk.demos_from_relative_probs(rel, pairs) == \
            ["Yes", "No", "Yes", "No"]


# -- the anchor gather -----------------------------------------------------------

class TestAnchorCorrectness:
    def test_forward_anchor_logits_matches_reference(self):
        jcfg, tcfg, params, weights = text_models()
        rows, anchors = tpk.encode_packs(
            tok(), tpk.build_packs(_prompts(5), 3, ["Yes", "No", "No",
                                                   "Yes", "No"]))
        s = max(map(len, rows))
        ids = np.zeros((len(rows), s), np.int64)
        mask = np.zeros((len(rows), s), np.int32)
        anc = np.zeros((len(rows), 3), np.int64)
        for i, (r, a) in enumerate(zip(rows, anchors)):
            ids[i, :len(r)], mask[i, :len(r)] = r, 1
            anc[i] = a + [a[0]] * (3 - len(a))
        ref = np.asarray(jdec.forward_anchor_logits(
            params, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
            jnp.asarray(anc, jnp.int32)))
        got = tdec.forward_anchor_logits(
            weights, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
            torch.from_numpy(anc))
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=2e-5)

    @pytest.mark.parametrize("packing", [1, 2, 3])
    def test_score_packed_matches_reference(self, packing):
        """Rows, per-question targets and the packing counters as the JAX
        engine's (a ragged last pack at Q=2 and Q=3)."""
        jeng, teng = pair()
        prompts = _prompts(7)
        targets = [("Yes", "No"), ("No", "Yes")] * 3 + [("Yes", "No")]
        packs = tpk.build_packs(prompts, packing,
                                ["Yes", "No", "Yes", "No", "No", "Yes",
                                 "Yes"])
        jtel.clear_counters()
        ref = jeng.score_packed(packs, targets=targets)
        ttel.clear_counters()
        got = teng.score_packed(packs, targets=targets)
        _rows_match(got, ref)
        keys = ("packed_rows", "packed_questions")
        assert {k: ttel.counter(k) for k in keys} == \
            {k: jtel.counters().get(k, 0) for k in keys}
        assert ttel.counter("packed_questions") == 7

    def test_single_question_packs_reproduce_isolated_bitwise(self):
        _, teng = pair()
        prompts = _prompts(6)
        targets = [["Yes", "No"]] * 6
        iso = teng.first_token_relative_prob(prompts, targets=targets,
                                             top_filter=0)
        rows = teng.score_packed(tpk.build_packs(prompts, 1),
                                 targets=targets, top_filter=0)
        got = np.asarray([r["first_token_relative_prob"] for r in rows])
        np.testing.assert_array_equal(got, iso[:, 2])

    def test_first_question_of_each_pack_is_bit_identical(self):
        """Question 0's stream is the isolated prompt's: in a batch of the
        packed rows' shape, its anchor logits equal those of the isolated
        prompt alone, bit for bit (the later questions are causally
        invisible).  Through the engines the packed rows land in a longer
        bucket, whose other GEMM row counts round the CPU's float32 sums
        differently in the last bit, so there question 0 holds to the
        probability class; later questions move with their context."""
        jcfg, tcfg, params, weights = text_models()
        prompts = _prompts(6)
        rows, anchors = tpk.encode_packs(tok(), tpk.build_packs(prompts, 3))
        s = max(map(len, rows))
        packed = torch.zeros((2, s), dtype=torch.long)
        alone = torch.zeros((2, s), dtype=torch.long)
        pmask = torch.zeros((2, s), dtype=torch.int32)
        amask = torch.zeros((2, s), dtype=torch.int32)
        for i, r in enumerate(rows):
            iso = tok()(prompts[3 * i])["input_ids"]
            packed[i, :len(r)], pmask[i, :len(r)] = torch.tensor(r), 1
            alone[i, :len(iso)], amask[i, :len(iso)] = torch.tensor(iso), 1
        anc = torch.tensor([[a[0]] for a in anchors])
        assert torch.equal(
            tdec.forward_anchor_logits(weights, tcfg, packed, pmask, anc),
            tdec.forward_anchor_logits(weights, tcfg, alone, amask, anc))
        _, teng = pair()
        targets = [["Yes", "No"]] * 6
        iso = teng.first_token_relative_prob(prompts, targets=targets,
                                             top_filter=0)
        got = teng.score_packed(tpk.build_packs(prompts, 3),
                                targets=targets, top_filter=0)
        rel = np.asarray([r["first_token_relative_prob"] for r in got])
        np.testing.assert_allclose(rel[[0, 3]], iso[[0, 3], 2], rtol=RTOL,
                                   atol=ATOL)
        assert not np.allclose(rel[1:3], iso[1:3, 2])

    def test_per_question_targets_route_to_the_right_anchor(self):
        _, teng = pair()
        packs = tpk.build_packs(_prompts(4), 2)
        base = [["Yes", "No"]] * 4
        swapped = [["Yes", "No"], ["No", "Yes"], ["Yes", "No"],
                   ["Yes", "No"]]
        ra = np.asarray([r["first_token_relative_prob"] for r in
                         teng.score_packed(packs, base, top_filter=0)])
        rb = np.asarray([r["first_token_relative_prob"] for r in
                         teng.score_packed(packs, swapped, top_filter=0)])
        np.testing.assert_allclose(rb[1], 1.0 - ra[1], rtol=1e-6)
        np.testing.assert_array_equal(rb[[0, 2, 3]], ra[[0, 2, 3]])

    def test_t5_rejects_packed_scoring(self):
        """As in the reference: a ``ValueError`` naming the decoder-only
        route, from both packed entries."""
        import test_torch_t5

        jeng, teng = test_torch_t5.engines()
        for eng in (jeng, teng):
            with pytest.raises(ValueError, match="decoder-only"):
                eng.score_packed([[("q", None)]], targets=("Yes", "No"))
            with pytest.raises(ValueError, match="decoder-only"):
                eng.packed_autoregressive_demos(["q", "r"], 2)


# -- the drift block and the packed sweep -------------------------------------

class TestDriftReport:
    @pytest.mark.parametrize("case", ["populated", "nan", "all-nan"])
    def test_report_matches_reference(self, case):
        rng = np.random.default_rng(4)
        packed, iso = rng.random(9), rng.random(9)
        if case == "nan":
            packed[2] = iso[5] = float("nan")
        if case == "all-nan":
            packed[:] = float("nan")
        got = tpk.drift_report(packed, iso, 3)
        assert got == jpk.drift_report(packed, iso, 3)
        assert got["n_questions"] + got["n_skipped"] == 9

    def test_report_is_deterministic_and_populated(self):
        _, teng = pair()
        prompts = _prompts(6)
        targets = [["Yes", "No"]] * 6
        iso = teng.first_token_relative_prob(prompts, targets=targets,
                                             top_filter=0)
        packs = tpk.build_packs(prompts, 3, tpk.demos_from_relative_probs(
            iso[:, 2], targets))

        def one():
            rows = teng.score_packed(packs, targets=targets, top_filter=0)
            return tpk.drift_report(
                [r["first_token_relative_prob"] for r in rows], iso[:, 2], 3)

        a, b = one(), one()
        assert a == b and a["packing"] == 3 and a["n_questions"] == 6
        assert a["max_abs_delta"] > 0

    def test_nan_rows_are_skipped_and_lengths_checked(self):
        rep = tpk.drift_report([0.6, float("nan")], [0.4, 0.5], 2)
        assert rep["n_questions"] == 1 and rep["n_skipped"] == 1
        assert rep["flip_rate"] == 1.0
        with pytest.raises(ValueError):
            tpk.drift_report([0.5], [0.5, 0.5], 2)

    @pytest.mark.parametrize("parity", [True, False])
    def test_packed_sweep_matches_reference(self, tmp_path, parity):
        """``run_packed_perturbation_sweep`` on the sweep tests' corpus:
        the workbook (the packed extractor tag, empty response and
        confidence columns) and the drift block as the JAX sweep's; a
        second call over the finished workbook resumes every row."""
        jeng, teng = sweep_tests.engines(**SWEEP_ECFG)
        kw = dict(packing=2, drift_parity=parity, checkpoint_every=4,
                  score_chunk=6)
        jdf, jrep = jsweep.run_packed_perturbation_sweep(
            jeng, sweep_tests.MODEL, sweep_tests.scenarios(),
            str(tmp_path / "j.xlsx"), log=sweep_tests.quiet(), **kw)
        trows, trep = tsweep.run_packed_perturbation_sweep(
            teng, sweep_tests.MODEL, sweep_tests.scenarios(),
            str(tmp_path / "t.xlsx"), log=sweep_tests.quiet(), **kw)
        sweep_tests._sweep_rows_match(trows, jdf)
        rows = sweep_tests.assert_workbooks_equal(tmp_path / "t.xlsx",
                                                  tmp_path / "j.xlsx")
        n = 5 * sweep_tests.PER_SCENARIO
        assert len(rows) == n
        assert all(r["Log Probabilities"] == "local:packed2:first_token_top20"
                   and r["Model Response"] in ("", None)
                   and r["Model Confidence Response"] in ("", None)
                   and r["Confidence Value"] is None for r in rows)
        assert not os.path.exists(str(tmp_path / "t.xlsx") + ".rows.jsonl")
        if parity:
            assert trep == jrep and trep["n_questions"] == n
            assert trep["n_skipped"] == 0
        else:
            assert trep is None and jrep is None
        again, rep2 = tsweep.run_packed_perturbation_sweep(
            teng, sweep_tests.MODEL, sweep_tests.scenarios(),
            str(tmp_path / "t.xlsx"), log=sweep_tests.quiet(), **kw)
        assert len(again) == n
        assert rep2 is None if not parity else rep2["n_questions"] == 0

    def test_packed_sweep_flushes_on_sigterm(self, tmp_path):
        """SIGTERM at the second chunk's scoring: the guard flushes the
        first chunk's pending rows to the side-log, ``Preempted`` ends the
        sweep (both packages' side-logs hold the same rows), and the next
        call resumes the rest into the workbook an uninterrupted call
        writes."""
        import json
        import signal

        from llm_interpretation_replication_tpu.runtime import faults as jf
        from llm_interpretation_replication_tpu_torch.runtime import faults

        kw = dict(packing=2, checkpoint_every=50, score_chunk=6)
        logs = []
        for mod, eng, name, exc in (
                (jsweep, sweep_tests.engines(**SWEEP_ECFG)[0], "j", jf.Preempted),
                (tsweep, sweep_tests.engines(**SWEEP_ECFG)[1], "t", faults.Preempted)):
            real, calls = eng.score_packed, []

            def interrupted(*args, real=real, calls=calls, **kwargs):
                calls.append(1)
                if len(calls) == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return real(*args, **kwargs)

            eng.score_packed = interrupted
            path = str(tmp_path / f"{name}.xlsx")
            with pytest.raises(exc):
                mod.run_packed_perturbation_sweep(
                    eng, sweep_tests.MODEL, sweep_tests.scenarios(), path,
                    log=sweep_tests.quiet(), **kw)
            with open(path + ".rows.jsonl") as f:
                logs.append([json.loads(line) for line in f])
            eng.score_packed = real
        assert len(logs[0]) == len(logs[1]) == 6
        for a, b in zip(logs[0], logs[1]):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(b[k], float):
                    np.testing.assert_allclose(a[k], b[k], rtol=RTOL,
                                               atol=ATOL)
                else:
                    assert a[k] == b[k]
        _, teng = sweep_tests.engines(**SWEEP_ECFG)
        path = str(tmp_path / "t.xlsx")
        rows, rep = tsweep.run_packed_perturbation_sweep(
            teng, sweep_tests.MODEL, sweep_tests.scenarios(), path,
            log=sweep_tests.quiet(), **kw)
        tsweep.run_packed_perturbation_sweep(
            teng, sweep_tests.MODEL, sweep_tests.scenarios(),
            str(tmp_path / "ref.xlsx"), log=sweep_tests.quiet(), **kw)
        assert rep["n_questions"] == 5 * sweep_tests.PER_SCENARIO - 6
        sweep_tests.assert_workbooks_equal(path, tmp_path / "ref.xlsx")


# -- autoregressive demonstrations on the slot ring ----------------------------

class TestPackedDemos:
    QS = [f"Q{i}: is a tent a dwelling? Answer Yes or No." for i in range(8)]
    KW = dict(phase2_pool_target=2, buckets=(32, 64, 128, 256))

    @pytest.mark.parametrize("repack,extend", [
        (True, True), (False, True), (True, False)])
    def test_autoregressive_demos_match_reference(self, repack, extend):
        """Demos and packs as the JAX engine's, on the ring (refilling
        lanes), in whole flushes, and with every stage prefilled whole;
        the last question of each pack stays demo-free, and the packs
        score through ``score_packed``."""
        jeng, teng = engines(**self.KW)
        kw = dict(packing=4, max_demo_tokens=6, repack=repack,
                  extend_stages=extend)
        ttel.clear_counters()
        packs, demos = teng.packed_autoregressive_demos(self.QS, **kw)
        c = ttel.counters()
        assert (packs, demos) == jeng.packed_autoregressive_demos(self.QS,
                                                                  **kw)
        assert c.get("slot_rows|leg=packed,workload=packed", 0) == 6
        assert bool(c.get("slot_stage_extends", 0)) == extend
        assert demos[3] is None and demos[7] is None
        assert all(d is not None for d in demos[:3])
        rows = teng.score_packed(packs, targets=("Yes", "No"))
        assert len(rows) == 8 and all(r["success"] for r in rows)

    def test_repack_parity_and_facade(self):
        _, teng = engines(**self.KW)
        on = tpk.autoregressive_demos(teng, self.QS, 4, max_demo_tokens=6)
        off = tpk.autoregressive_demos(teng, self.QS, 4, max_demo_tokens=6,
                                       repack=False)
        assert on == off

    def test_demo_decode_occupancy_recorded(self):
        _, teng = engines(**self.KW)
        teng.packed_autoregressive_demos([f"Q{i}?" for i in range(6)],
                                         packing=3, max_demo_tokens=4)
        occ = teng.occupancy_report()
        assert occ is not None and occ["rows"] >= 4
        with pytest.raises(ValueError):
            teng.packed_autoregressive_demos(["q"], 0)
