"""The port's survey layer (``survey/``, ``analysis/questions.py``) against
the JAX package's on the same numpy-seeded synthetic inputs: two Qualtrics
exports of 40 respondents (``chip_smoke._survey_exports``, with a planted
number of each preregistered exclusion) and results CSVs of 4 models x 20
questions in the run-100q, instruct-sweep and word-meaning schemas.

Parity classes: bit-equal (numbers compared with ``==``, NaN equal to
NaN, ints against ints) wherever the JAX code calls numpy or scipy on
arrays, and where it reduces through pandas at these sizes too (its
means and spreads take the same sums here); files and printed reports
byte-equal; figures PNG-equal (drawn through one pyplot).
"""

import json
import math
import numbers
import os

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from llm_interpretation_replication_tpu import survey as jsurvey
from llm_interpretation_replication_tpu.analysis import questions as jquestions
from llm_interpretation_replication_tpu.survey import pipeline as jpipeline
from llm_interpretation_replication_tpu.survey import variants as jvariants
from llm_interpretation_replication_tpu_torch import survey as tsurvey
from llm_interpretation_replication_tpu_torch.analysis import questions as tquestions
from llm_interpretation_replication_tpu_torch.config import ordinary_meaning_questions
from llm_interpretation_replication_tpu_torch.survey import pipeline as tpipeline
from llm_interpretation_replication_tpu_torch.survey import variants as tvariants
from llm_interpretation_replication_tpu_torch.sweeps.writers import (
    BASE_VS_INSTRUCT_100Q_COLUMNS, INSTRUCT_COMPARISON_COLUMNS,
    MODEL_COMPARISON_COLUMNS, write_csv)
from llm_interpretation_replication_tpu_torch.utils import frame
from test_torch_slots import one_torch_thread  # noqa: F401

SEED = 23
#: 40 respondents, 20 in each export
PLANTED = {"duration_excluded": 2, "identical_excluded": 1,
           "attention_failed": 3}
#: the 4 models of the results CSVs (two MODEL_FAMILIES pairs)
MODELS = [("tiiuae/falcon-7b", "falcon", "base"),
          ("tiiuae/falcon-7b-instruct", "falcon", "instruct"),
          ("mistralai/Mistral-7B-v0.1", "mistral", "base"),
          ("mistralai/Mistral-7B-Instruct-v0.2", "mistral", "instruct")]


def equal(a, b):
    """Recursive equality: numbers by value and kind (an int is not a
    float), NaN equal to NaN; dicts, lists, tuples and arrays whole."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and \
            np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if isinstance(a, bool) or isinstance(b, bool):
        return bool(a) == bool(b) and isinstance(a, (bool, np.bool_)) \
            and isinstance(b, (bool, np.bool_))
    if isinstance(a, numbers.Number) and isinstance(b, numbers.Number):
        if isinstance(a, numbers.Integral) != isinstance(b, numbers.Integral):
            return False
        if isinstance(a, float) and math.isnan(a):
            return isinstance(b, float) and math.isnan(b)
        return a == b
    return type(a) is type(b) and a == b


def records(df):
    """A JAX function's DataFrame as the rows the port returns."""
    return df.to_dict("records")


# -- inputs ---------------------------------------------------------------------------

def survey_files(root):
    paths, planted = chip_smoke._survey_exports(
        SEED, str(root), n_respondents=40, planted=PLANTED)
    assert planted == PLANTED
    return paths


def matched_questions():
    """Ten questions of each export (the exact texts of its headers)."""
    qs = ordinary_meaning_questions()
    return qs[:10] + qs[50:60]


def results_rows(schema, seed=SEED):
    """4 models x 20 questions in ``schema`` (``"100q"``, ``"instruct"`` or
    ``"base"``): probabilities from ``seed``, each model leaning its own
    way; one row of each model with both probabilities 0 and one NaN
    relative probability, so the loaders' fills run."""
    rng = np.random.default_rng(seed)
    rows = []
    for m, (model, family, role) in enumerate(MODELS):
        lean = rng.normal(0, 0.15)
        for q, prompt in enumerate(matched_questions()):
            yes = float(np.clip(rng.beta(2, 2) + lean, 0.001, 0.999))
            no = float(rng.uniform(0.001, 0.999) * (1 - yes))
            if q == 3 + m:
                yes = no = 0.0
            rel = yes / (yes + no) if yes + no else float("nan")
            out = "Yes" if yes > no else ("No" if q % 7 else "Maybe")
            rows.append({
                "yes_prob": yes, "no_prob": no, "relative_prob": rel,
                "completion": out, "success": True, "prompt": prompt,
                "model": model, "formatted_prompt": f"Q: {prompt}\nA:",
                "model_family": family, "base_or_instruct": role,
                "model_output": out, "odds_ratio": yes / no if no else
                float("nan")})
    columns = {"100q": BASE_VS_INSTRUCT_100Q_COLUMNS,
               "instruct": INSTRUCT_COMPARISON_COLUMNS,
               "base": MODEL_COMPARISON_COLUMNS}[schema]
    return columns, [{c: r[c] for c in columns} for r in rows]


def results_csv(root, schema, seed=SEED):
    path = os.path.join(str(root), f"{schema}_results.csv")
    write_csv(*results_rows(schema, seed), path)
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("survey_inputs")
    return {"surveys": survey_files(root),
            "100q": results_csv(root, "100q"),
            "instruct": results_csv(root, "instruct"),
            "base": results_csv(root, "base")}


@pytest.fixture(scope="module")
def loaded(inputs):
    """Both packages' cleaned survey and results tables."""
    t_df, t_cols = tsurvey.load_and_clean_survey_data(inputs["surveys"])
    j_df, j_cols = jsurvey.load_and_clean_survey_data(inputs["surveys"])
    t_clean, t_excl = tsurvey.apply_exclusion_criteria(t_df, t_cols)
    j_clean, j_excl = jsurvey.apply_exclusion_criteria(j_df, j_cols)
    return dict(t=(t_df, t_cols, t_clean, t_excl), j=(j_df, j_cols, j_clean, j_excl),
                t_llm=frame.read_csv(inputs["instruct"])[1],
                j_llm=pd.read_csv(inputs["instruct"]))


# -- loading, exclusions, matching ------------------------------------------------------

def test_loading_and_exclusions_match_reference(loaded):
    t_df, t_cols, t_clean, t_excl = loaded["t"]
    j_df, j_cols, j_clean, j_excl = loaded["j"]
    assert t_cols == j_cols and len(t_cols) == 110
    assert equal(t_df, records(j_df))
    assert equal(t_excl, {k: (float(v) if isinstance(v, np.floating) else v)
                          for k, v in j_excl.items()})
    assert equal(t_clean, records(j_clean))
    for key, n in PLANTED.items():
        assert t_excl[key] == n
    assert t_excl["total_excluded"] == sum(PLANTED.values()) + \
        chip_smoke.SURVEY_NO_DURATION


def test_question_text_and_matching_match_reference(inputs, loaded):
    paths = inputs["surveys"]
    mapping = tpipeline.extract_question_text(paths)
    assert mapping == jpipeline.extract_question_text(paths)
    matches = tsurvey.match_survey_to_llm_questions(loaded["t_llm"], paths)
    assert matches == jsurvey.match_survey_to_llm_questions(loaded["j_llm"], paths)
    assert len(matches[0]) == 20


def test_per_question_stats_and_correlation_match_reference(inputs, loaded):
    t_clean, t_cols = loaded["t"][2], loaded["t"][1]
    j_clean, j_cols = loaded["j"][2], loaded["j"][1]
    th = tsurvey.human_responses_by_question(t_clean, t_cols)
    jh = jsurvey.human_responses_by_question(j_clean, j_cols)
    assert equal(th, jh)
    tl = tsurvey.llm_responses_by_question(loaded["t_llm"])
    jl = jsurvey.llm_responses_by_question(loaded["j_llm"])
    assert equal(tl, jl)
    matches = tsurvey.match_survey_to_llm_questions(loaded["t_llm"],
                                                    inputs["surveys"])[0]
    assert equal(tsurvey.human_llm_correlation(th, tl, matches, seed=3),
                 jsurvey.human_llm_correlation(jh, jl, matches, seed=3))
    assert tsurvey.human_llm_correlation(th, tl, {}) is None


@pytest.mark.parametrize("n", [2, 9, 40])
def test_pearson_with_bootstrap_matches_reference(n):
    rng = np.random.default_rng(n)
    x, y = rng.normal(size=n), rng.normal(size=n)
    assert equal(tsurvey.pearson_with_bootstrap(x, y, n_bootstrap=200, seed=n),
                 jsurvey.pearson_with_bootstrap(x, y, n_bootstrap=200, seed=n))


def test_agreements_cross_prompt_and_meta_match_reference(inputs, loaded):
    t_clean, t_cols = loaded["t"][2], loaded["t"][1]
    j_clean = loaded["j"][2]
    th = tsurvey.per_item_agreement_humans(t_clean, t_cols, n_bootstrap=300)
    jh = jsurvey.per_item_agreement_humans(j_clean, t_cols, n_bootstrap=300)
    assert equal(th, jh)
    tl = tsurvey.per_item_agreement_llms(loaded["t_llm"], n_bootstrap=300)
    jl = jsurvey.per_item_agreement_llms(loaded["j_llm"], n_bootstrap=300)
    assert equal(tl, jl)
    matches, mapping = tsurvey.match_survey_to_llm_questions(
        loaded["t_llm"], inputs["surveys"])
    assert equal(tpipeline.meta_correlation(th, tl, matches, 300),
                 jpipeline.meta_correlation(jh, jl, matches, 300))
    assert equal(tpipeline.meta_correlation(th, tl, {}, 300),
                 jpipeline.meta_correlation(jh, jl, {}, 300))
    thc = tsurvey.human_cross_prompt_correlations(t_clean, t_cols, 30, seed=5)
    jhc = jsurvey.human_cross_prompt_correlations(j_clean, t_cols, 30, seed=5)
    assert equal(thc, jhc)
    tlc = tsurvey.llm_cross_prompt_correlations(loaded["t_llm"], mapping, 30)
    jlc = jsurvey.llm_cross_prompt_correlations(loaded["j_llm"], mapping, 30)
    assert equal(tlc, jlc)
    assert equal(tsurvey.cross_prompt_difference_ci(thc, tlc, 400, seed=2),
                 jsurvey.cross_prompt_difference_ci(jhc, jlc, 400, seed=2))


def test_resampled_means_split_into_blocks_keep_the_draws():
    """The difference CI's resamples, drawn a block at a time, are the one
    draw's (the generator's stream does not depend on the split)."""
    pool = np.random.default_rng(1).normal(size=1001)
    want = np.mean(pool[np.random.default_rng(4).integers(
        0, 1001, size=(57, 1001))], axis=1)
    for cells in (1001, 5000, 1 << 24):
        got = tpipeline._resampled_means(np.random.default_rng(4), pool, 57,
                                         cells=cells)
        assert np.array_equal(got, want)


def test_consolidated_analysis_matches_reference(inputs, tmp_path):
    out = {}
    for tag, mod in (("port", tpipeline), ("jax", jpipeline)):
        logs = []
        d = tmp_path / tag
        res = mod.run_consolidated_analysis(
            inputs["surveys"], inputs["instruct"], str(d), n_bootstrap=300,
            cross_prompt_bootstrap=20, log=logs.append)
        out[tag] = (logs, (d / "results.json").read_bytes(),
                    (d / "report.txt").read_bytes())
        assert res["n_matched"] == 20
    assert out["port"] == out["jax"]


# -- Table 5 (survey/mae_100q.py) ---------------------------------------------------------

def mae_synthetic():
    """``tests/test_survey.py``'s TestMae100q inputs."""
    rng = np.random.default_rng(0)
    questions = [f"q{i}" for i in range(30)]
    human_avgs = {f"S1_Q1_{i}": float(rng.uniform(0.3, 0.8)) for i in range(30)}
    matches = {f"q{i}": f"S1_Q1_{i}" for i in range(30)}
    rows = []
    for model, offset, noise in [("tiiuae/falcon-7b", 0.05, 0.05),
                                 ("tiiuae/falcon-7b-instruct", 0.25, 0.05)]:
        for q in questions:
            h = human_avgs[matches[q]]
            rows.append({"prompt": q, "model": model, "relative_prob": float(
                np.clip(h + offset + rng.normal(0, noise), 0, 1))})
    for q in questions:
        rows.append({"prompt": q, "model": "stabilityai/stablelm-base-alpha-7b",
                     "relative_prob": 0.5})
        rows.append({"prompt": q, "model": "stabilityai/stablelm-tuned-alpha-7b",
                     "relative_prob": float(rng.uniform(0, 1))})
    rows.append({"prompt": "q0", "model": "half/nan", "relative_prob": 0.2})
    rows += [{"prompt": f"q{i}", "model": "half/nan",
              "relative_prob": float("nan")} for i in (1, 2)]
    return rows, human_avgs, matches


@pytest.mark.parametrize("model", ["tiiuae/falcon-7b",
                                   "stabilityai/stablelm-base-alpha-7b",
                                   "missing/model", "half/nan"])
def test_validate_model_data_matches_reference(model):
    rows, _, _ = mae_synthetic()
    got = tsurvey.validate_model_data(rows, model)
    assert got == jsurvey.validate_model_data(pd.DataFrame(rows), model)
    assert got[0] == (model == "tiiuae/falcon-7b")


@pytest.mark.parametrize("families", [None, "Falcon", "StableLM"])
def test_analyze_families_matches_reference(families):
    rows, human_avgs, matches = mae_synthetic()
    fams = None if families is None else {
        families: tsurvey.MODEL_FAMILIES[families]}
    got = tsurvey.analyze_families(rows, human_avgs, matches, families=fams,
                                   n_bootstrap=2000, seed=42)
    ref = jsurvey.analyze_families(pd.DataFrame(rows), human_avgs, matches,
                                   families=fams, n_bootstrap=2000, seed=42)
    assert equal(got, ref)
    if families == "Falcon":
        assert got["Falcon"]["instruct_mae"] > got["Falcon"]["base_mae"]
        assert got["Falcon"]["p_value"] < 0.05
    if families == "StableLM":
        assert got["StableLM"]["excluded"]


def test_mae_per_model_and_paired_bootstrap_match_reference():
    rows, human_avgs, matches = mae_synthetic()
    for model in ("tiiuae/falcon-7b", "half/nan", "none/such"):
        assert equal(tsurvey.mae_per_model(rows, human_avgs, matches, model),
                     jsurvey.mae_per_model(pd.DataFrame(rows), human_avgs,
                                           matches, model))
    rng = np.random.default_rng(1)
    base, inst = np.abs(rng.normal(0.3, 0.1, 50)), np.abs(rng.normal(0.45, 0.1, 47))
    for a, b in ((base, inst), (inst, base)):
        assert equal(tsurvey.paired_bootstrap_mae_difference(a, b, 2000, 42),
                     jsurvey.paired_bootstrap_mae_difference(a, b, 2000, 42))
    assert tsurvey.MODEL_FAMILIES == jsurvey.MODEL_FAMILIES


# -- demographics ------------------------------------------------------------------------

def test_demographics_match_reference(inputs):
    paths = inputs["surveys"]
    tdf, jdf = tsurvey.load_demographics(paths), jsurvey.load_demographics(paths)
    assert tdf[0] == list(jdf.columns)
    for column in ("Sex", "Age", "Student status", "Duration (in seconds)"):
        for top in (None, 2):
            assert equal(tsurvey.summarize_categorical(tdf, column, top),
                         records(jsurvey.summarize_categorical(jdf, column, top)))
    assert equal(tsurvey.summarize_age(tdf), jsurvey.summarize_age(jdf))
    cols = ["Sex", "Ethnicity simplified", "Employment status",
            "Student status", "Absent"]
    assert tsurvey.demographics_latex_table(tdf, cols) == \
        jsurvey.demographics_latex_table(jdf, cols)


# -- the variants ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def three_way_inputs(inputs, loaded):
    """(port, jax) (llm rows, clean survey, columns, mapping), the llm rows
    as the CLI loads them."""
    from llm_interpretation_replication_tpu import __main__ as jmain
    from llm_interpretation_replication_tpu_torch import __main__ as tmain

    mapping = tpipeline.extract_question_text(inputs["surveys"])
    t_llm = tmain._load_llm_csv(inputs["100q"])
    j_llm = jmain._load_llm_csv(inputs["100q"])
    assert equal(t_llm, records(j_llm))
    return ((t_llm, loaded["t"][2], loaded["t"][1], mapping),
            (j_llm, loaded["j"][2], loaded["j"][1], mapping))


def test_three_way_pieces_match_reference(three_way_inputs):
    (t_llm, t_clean, cols, mapping), (j_llm, j_clean, _, _) = three_way_inputs
    tp = tvariants.human_proportions_by_prompt(t_clean, cols, mapping)
    jp = jvariants.human_proportions_by_prompt(j_clean, cols, mapping)
    assert equal(tp, jp)
    for min_q in (10, 30):
        assert equal(tvariants.model_human_correlations(t_llm, tp, min_q),
                     records(jvariants.model_human_correlations(j_llm, jp, min_q)))
    assert equal(tvariants.output_validity_audit(t_llm), [])
    _, inst = results_rows("instruct")
    audit = tvariants.output_validity_audit(inst)
    assert audit and equal(audit, jvariants.output_validity_audit(
        pd.DataFrame(inst)))
    assert equal(tvariants.probability_distribution_stats(t_llm),
                 records(jvariants.probability_distribution_stats(j_llm)))


@pytest.mark.parametrize("make_figures", [True, False])
def test_three_way_report_matches_reference(three_way_inputs, tmp_path,
                                            make_figures):
    files = {}
    for tag, mod, args in (("jax", jvariants, three_way_inputs[1]),
                           ("port", tvariants, three_way_inputs[0])):
        d = tmp_path / tag
        out = mod.three_way_report(*args, str(d), make_figures=make_figures)
        files[tag] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
        assert out["human_questions"] == 100
    assert files["port"] == files["jax"]
    assert ("human_vs_model_comparison.png" in files["port"]) == make_figures


def test_agreement_bootstrap_and_family_differences_match_reference(
        three_way_inputs):
    (t_llm, t_clean, cols, mapping), (j_llm, j_clean, _, _) = three_way_inputs
    got = tvariants.agreement_bootstrap(t_llm, t_clean, cols, mapping, 50, 7)
    ref = jvariants.agreement_bootstrap(j_llm, j_clean, cols, mapping, 50, 7)
    assert equal(got, ref) and len(got["model_results"]) == 4
    fams = {"Falcon": tsurvey.MODEL_FAMILIES["Falcon"],
            "Mistral": tsurvey.MODEL_FAMILIES["Mistral"],
            "BLOOM": tsurvey.MODEL_FAMILIES["BLOOM"]}
    for f in (None, fams):
        t_rec = tvariants.family_differences(got, f)
        j_rec = jvariants.family_differences(ref, f)
        assert equal(t_rec, j_rec)
        assert tvariants.family_differences_text(t_rec) == \
            jvariants.family_differences_text(j_rec)


def test_agreement_bootstrap_mape_keeps_tiny_but_nonzero_means():
    """``tests/test_survey.py``'s finite-filter case on both packages."""
    survey = [{"Q_tiny": 0.5, "Q_mid": 50.0, "Q_zero": 0.0}] * 4
    mapping = {"Q_tiny": "p_tiny", "Q_mid": "p_mid", "Q_zero": "p_zero"}
    llm = [{"model": "m", "prompt": p, "relative_prob": v}
           for p, v in (("p_tiny", 0.105), ("p_mid", 0.25), ("p_zero", 0.4))]
    got = tvariants.agreement_bootstrap(llm, survey, list(mapping), mapping,
                                        n_bootstrap=8, seed=0, min_questions=1)
    ref = jvariants.agreement_bootstrap(pd.DataFrame(llm), pd.DataFrame(survey),
                                        list(mapping), mapping, n_bootstrap=8,
                                        seed=0, min_questions=1)
    assert equal(got, ref)
    (rec,) = got["model_results"]
    np.testing.assert_allclose(rec["mape_mean"], (20.0 + 0.5) / 2 * 100,
                               rtol=1e-12)


def test_ground_truth_values_and_figures_match_reference(loaded, tmp_path):
    t_clean, cols = loaded["t"][2], loaded["t"][1]
    tv = tvariants.ground_truth_values(t_clean, cols)
    jv = jvariants.ground_truth_values(loaded["j"][2], cols)
    assert equal(tv, jv) and tv.size == 100
    outs = {}
    for tag, mod in (("jax", jvariants), ("port", tvariants)):
        d = tmp_path / tag
        res = mod.ground_truth_figures(tv, str(d))
        outs[tag] = ({k: v for k, v in res.items() if k not in ("two_panel",
                                                                "simple")},
                     (d / "ground_truth_distribution.png").read_bytes(),
                     (d / "ground_truth_distribution_simple.png").read_bytes())
    assert equal(outs["port"], outs["jax"])
    rng = np.random.default_rng(3)
    x, y = rng.uniform(0, 100, 30), rng.uniform(0, 1, 30)
    assert equal(tvariants._lowess(y, x, 0.3), jvariants._lowess(y, x, 0.3))


def test_human_agreement_reports_match_reference(inputs):
    from llm_interpretation_replication_tpu import __main__ as jmain
    from llm_interpretation_replication_tpu_torch import __main__ as tmain

    t_inst, j_inst = (m._load_llm_csv(inputs["instruct"]) for m in (tmain, jmain))
    t_base = frame.read_csv(inputs["base"])[1]
    j_base = pd.read_csv(inputs["base"])
    survey = inputs["surveys"][:1]
    tm = tvariants.human_agreement_means(survey, t_inst)
    jm = jvariants.human_agreement_means(survey, j_inst)
    assert equal(tm, jm) and len(tm) == 10
    for tb, jb in ((t_base, j_base), (None, None)):
        assert equal(tvariants.human_agreement_report(t_inst, tb, tm, 5),
                     jvariants.human_agreement_report(j_inst, jb, jm, 5))
        got = tvariants.agreement_question_bootstrap(
            t_inst, tb, tm, n_bootstrap=120, seed=7, min_questions=5,
            n_diff_bootstrap=300)
        ref = jvariants.agreement_question_bootstrap(
            j_inst, jb, jm, n_bootstrap=120, seed=7, min_questions=5,
            n_diff_bootstrap=300)
        assert json.dumps(got, default=float) == json.dumps(ref, default=float)


def test_questions_loaders_match_reference(inputs):
    s1, s2 = inputs["surveys"]
    assert tquestions.extract_survey2_questions(s2) == \
        jquestions.extract_survey2_questions(s2)
    for n1, n2 in ((50, 50), (3, 4)):
        assert tquestions.load_ordinary_meaning_questions(
            inputs["instruct"], s2, n1, n2) == \
            jquestions.load_ordinary_meaning_questions(inputs["instruct"], s2,
                                                       n1, n2)
    for full in (False, True):
        assert equal(tquestions.load_human_survey_means(s1, s2, full),
                     jquestions.load_human_survey_means(s1, s2, full))
    for text in (None, 1.5, "a - b", "Stem - Is it?", "x - y - Z?  "):
        assert tquestions.question_from_header(text) == \
            jquestions.question_from_header(text)


def test_survey_package_exports_match_reference():
    names = {n for n in dir(jsurvey) if not n.startswith("_")}
    assert names - {"pipeline", "variants", "mae_100q", "demographics"} <= set(
        dir(tsurvey))


def test_smoke_survey_pins_are_the_reference(tmp_path, capsys):
    """What ``chip_smoke.py``'s phase 22 holds its survey-only numbers to
    (``SURVEY_SHA256``, at ``--seed 0`` and the study's 1,003 respondents)
    is the port's on the CPU, and those numbers are the JAX package's:
    the planted exclusions exactly, the human per-item agreement bit for
    bit, the human cross-prompt correlations at rtol 1e-12 (the exact
    integer path against pandas' Welford), the demographics LaTeX byte
    for byte."""
    from llm_interpretation_replication_tpu import __main__ as jmain
    from llm_interpretation_replication_tpu_torch import __main__ as tmain

    paths, planted = chip_smoke._survey_exports(0, str(tmp_path))
    numbers = {}
    for tag, mod in (("port", tsurvey), ("jax", jsurvey)):
        df, cols = mod.load_and_clean_survey_data(paths)
        clean, excl = mod.apply_exclusion_criteria(df, cols)
        items = mod.per_item_agreement_humans(clean, cols, n_bootstrap=1)
        cross = mod.human_cross_prompt_correlations(clean, cols, n_bootstrap=0)
        numbers[tag] = json.loads(json.dumps({
            "exclusions": excl,
            "n_survey_questions": len(mod.human_responses_by_question(
                clean, cols)),
            "human_agreement": {k: v for k, v in items.items()
                                if k != "per_item"},
            "human_cross_prompt": {k: v for k, v in cross.items() if k not in (
                "group_results", "pairwise_correlations")}}, default=float))
    got, ref = numbers["port"], numbers["jax"]
    for key, n in planted.items():
        assert got["exclusions"][key] == n
    assert got["exclusions"] == ref["exclusions"]
    assert got["human_agreement"] == ref["human_agreement"]
    tc, jc = got["human_cross_prompt"], ref["human_cross_prompt"]
    assert tc["n_pairs"] == jc["n_pairs"] > 100_000
    for key in ("mean_correlation", "std_correlation"):
        np.testing.assert_allclose(tc[key], jc[key], rtol=1e-12)
    tex = {}
    for tag, main in (("port", tmain), ("jax", jmain)):
        out = tmp_path / f"{tag}.tex"
        main.main(["demographics-table", "--csv", paths[0], "--csv", paths[1],
                   "--output", str(out)])
        tex[tag] = out.read_text()
    capsys.readouterr()
    assert tex["port"] == tex["jax"]
    assert chip_smoke._survey_digest(chip_smoke._survey_numbers(
        got, tex["port"])) == chip_smoke.SURVEY_SHA256
