"""The port's analysis modules (``analysis/``: the perturbation report, the
similarity report, the model comparison and cross-experiment kappa, the
base-vs-instruct figures, the three-model confidence combiner) and the
statistics that took DataFrames (``stats/compliance.py``,
``stats/correlations.py``, ``stats.base_vs_instruct_analysis``) against
the JAX package's on the same seeded synthetic inputs: sweep workbooks
written once and read by each package's own reader, and results rows.

Parity classes: numbers bit-equal (``test_torch_survey.equal``), every
file each writes (CSV, JSON, LaTeX, xlsx) byte-equal, and every figure's
PNG byte-equal (drawn through one pyplot, the JAX package's first).
"""

import importlib
import json
import os
import sys
import types

import numpy as np
import pandas as pd
import pytest

from llm_interpretation_replication_tpu import analysis as janalysis
from llm_interpretation_replication_tpu import stats as jstats
from llm_interpretation_replication_tpu.utils.xlsx import read_xlsx as jread_xlsx
from llm_interpretation_replication_tpu_torch import analysis as tanalysis
from llm_interpretation_replication_tpu_torch import stats as tstats
from llm_interpretation_replication_tpu_torch.config import legal_scenarios
from llm_interpretation_replication_tpu_torch.sweeps.writers import (
    PERTURBATION_COLUMNS, perturbation_frame)
from llm_interpretation_replication_tpu_torch.utils import frame
from llm_interpretation_replication_tpu_torch.utils.xlsx import (
    read_xlsx as tread_xlsx, write_xlsx)
from test_torch_slots import one_torch_thread  # noqa: F401
from test_torch_survey import equal, records, results_rows

SEED = 31
# the packages export a function of the module's name
jsimrep = importlib.import_module(
    "llm_interpretation_replication_tpu.analysis.similarity_report")
tsimrep = importlib.import_module(
    "llm_interpretation_replication_tpu_torch.analysis.similarity_report")


def workbook_rows(rng, scenarios, model="gpt-test", rows_per_scenario=40):
    """``tests/test_analysis.py``'s sweep rows, plus what a real workbook
    holds: an unparseable confidence reply, an empty response, a
    non-finite probability pair and API-style log probabilities."""
    rows = []
    for s in scenarios:
        center = rng.uniform(0.2, 0.8)
        for j in range(rows_per_scenario):
            t1 = float(np.clip(rng.normal(center, 0.15), 0.001, 0.999))
            conf = str(int(100 * t1)) if j % 9 else ("85.5" if j % 2 else "high")
            lp = "" if j % 5 else json.dumps({"content": [
                {"token": "Not" if t1 < 0.5 else "Covered"},
                {"token": " Covered" if t1 < 0.5 else ""}]})
            rows.append({
                "Model": model,
                "Original Main Part": s["original_main"],
                "Response Format": s["response_format"],
                "Confidence Format": s["confidence_format"],
                "Rephrased Main Part": f"{s['original_main']} v{j}",
                "Full Rephrased Prompt": "x",
                "Full Confidence Prompt": "y",
                "Model Response": "" if j == 7 else (
                    "Covered" if t1 > 0.5 else "Not Covered"),
                "Model Confidence Response": conf,
                "Log Probabilities": lp,
                "Token_1_Prob": 0.0 if j == 11 else t1,
                "Token_2_Prob": 0.0 if j == 11 else 1 - t1,
                "Odds_Ratio": t1 / (1 - t1),
                "Confidence Value": int(100 * t1),
                "Weighted Confidence": 100 * t1,
            })
    return rows


def write_workbook(path, rows):
    write_xlsx(PERTURBATION_COLUMNS, perturbation_frame(rows), str(path))
    return str(path)


def both_workbook(path):
    """(port rows, JAX frame) of one workbook, each through its reader."""
    columns, rows = tread_xlsx(path)
    return frame.records(rows, columns)[1], jread_xlsx(path)


def tree(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


# -- the statistics that took frames -----------------------------------------------------

@pytest.fixture(scope="module")
def workbook(tmp_path_factory):
    rng = np.random.default_rng(SEED)
    scen = legal_scenarios()[:3]
    rows = workbook_rows(rng, scen) + workbook_rows(rng, scen, "other-model", 12)
    return write_workbook(tmp_path_factory.mktemp("wb") / "w.xlsx", rows)


def test_workbook_rows_are_typed_as_the_reference_frame(workbook):
    trows, jdf = both_workbook(workbook)
    assert equal(trows, records(jdf))


def test_compliance_matches_reference(workbook):
    trows, jdf = both_workbook(workbook)
    trows = tanalysis.add_relative_prob(trows)
    jdf = janalysis.add_relative_prob(jdf)
    assert equal(trows, records(jdf))
    for fn in ("check_output_compliance", "check_confidence_compliance"):
        got = getattr(tstats, fn)(trows)
        assert got and equal(got, records(getattr(jstats, fn)(jdf)))
    exp = tstats.EXPECTED_TOKENS[0]
    for first, full in (("Covered", "Covered"), ("Not", "Not covered"),
                        ("Nope", "Nope"), ("Not", "Not sure")):
        assert tstats.check_first_and_full(first, full, exp) == \
            jstats.check_first_and_full(first, full, exp)
    for v in ("50", "101", "5.5", "high", "-", 7):
        assert tstats.classify_confidence_response(v) == \
            jstats.classify_confidence_response(v)


@pytest.fixture(scope="module")
def comparison_rows():
    """``tests/test_analysis.py``'s TestModelComparison frame: 40 prompts,
    two close models and a random one, one value missing."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(40):
        base = rng.uniform(0, 1)
        for model, noise in (("org/a-7b", 0.02), ("org/baichuan-7b", 0.02),
                             ("org/c-7b", 1.0)):
            v = rng.uniform(0, 1) if noise > 0.5 else np.clip(
                base + rng.normal(0, noise), 0, 1)
            rows.append({"prompt": f"q{i}", "model": model,
                         "relative_prob": float(v)})
    rows[5]["relative_prob"] = float("nan")
    return rows


def test_correlations_match_reference(comparison_rows):
    tp = tstats.pivot_model_values(comparison_rows)
    jp = jstats.pivot_model_values(pd.DataFrame(comparison_rows))
    assert (tp.index, tp.columns) == (list(jp.index), list(jp.columns))
    assert np.array_equal(tp.values, jp.to_numpy(), equal_nan=True)
    assert equal(tstats.pairwise_correlations(tp),
                 records(jstats.pairwise_correlations(jp)))
    assert equal(tstats.correlation_summary_bootstrap(tp, 60, 4),
                 jstats.correlation_summary_bootstrap(jp, 60, 4))
    for threshold in (0.5, 0.3):
        assert equal(tstats.pairwise_kappa(tp, threshold, 60, 4),
                     jstats.pairwise_kappa(jp, threshold, 60, 4))
    for a, b in (([1, 0, 1, 1], [1, 0, 0, 1]), ([1, 1], [1, 1]), ([0, 1], [1, 0])):
        assert tstats.cohens_kappa(a, b) == jstats.cohens_kappa(a, b)


def test_base_vs_instruct_analysis_matches_reference():
    _, rows = results_rows("100q")
    rows = [dict(r, model_family="all") if i < 6 else r
            for i, r in enumerate(rows)]
    got = tstats.base_vs_instruct_analysis(rows, n_bootstrap=500)
    ref = jstats.base_vs_instruct_analysis(pd.DataFrame(rows), n_bootstrap=500)
    assert equal(got, ref) and not got["falcon"].get("skipped")
    assert got["all"]["skipped"]


# -- the analysis modules ---------------------------------------------------------------------

@pytest.mark.parametrize("make_figures", [True, False])
def test_analyze_workbook_matches_reference(workbook, tmp_path, make_figures):
    trows, jdf = both_workbook(workbook)
    scen = legal_scenarios()
    out = {}
    for tag, mod, df in (("jax", janalysis, jdf), ("port", tanalysis, trows)):
        d = tmp_path / tag
        rep = mod.analyze_workbook(df, scen, str(d), n_simulations=3000,
                                   seed=5, make_figures=make_figures)
        out[tag] = (rep, tree(d))
    assert equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert set(out["port"][0]) == {"gpt-test", "other-model"}
    pngs = [p for p in out["port"][1] if p.endswith(".png")]
    assert bool(pngs) == make_figures


def test_similarity_report_matches_reference(tmp_path):
    records_in = [{
        "original_main": "Is a screenshot a photograph?",
        "rephrasings": ["Would a screenshot count as a photograph?",
                        "Can a screenshot be considered a photograph?",
                        "Do bananas grow on trees in cold climates?"]},
        {"original_main": "Is a tomato a vegetable?", "rephrasings": []}]

    class Embed:
        def encode(self, xs):
            return np.random.default_rng(len(xs)).normal(size=(len(xs), 8))

    for model in (None, Embed()):
        out = {}
        for tag, mod in (("jax", jsimrep), ("port", tsimrep)):
            d = tmp_path / tag / str(model is None)
            summary = mod.similarity_report(records_in, str(d), max_rephrasings=2,
                                            embedding_model=model)
            out[tag] = (summary, tree(d))
        assert equal(out["port"][0], records(out["jax"][0]))
        assert out["port"][1] == out["jax"][1]
        assert "original_vs_rephrasings_similarity.xlsx" in out["port"][1]


@pytest.mark.parametrize("case", ["missing", "loads", "fails"])
def test_load_embedding_model_gates_like_the_reference(monkeypatch, case):
    """Without ``sentence_transformers`` (or with a model that cannot
    load) both packages warn and return None; with one, they return it.
    The package is replaced by a stand-in: nothing is downloaded."""
    if case == "missing":
        monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    else:
        fake = types.ModuleType("sentence_transformers")

        class SentenceTransformer:
            def __init__(self, name):
                if case == "fails":
                    raise OSError(f"no model {name}")
                self.name = name

        fake.SentenceTransformer = SentenceTransformer
        monkeypatch.setitem(sys.modules, "sentence_transformers", fake)
    logs = {}
    for tag, mod in (("jax", jsimrep), ("port", tsimrep)):
        logs[tag] = []
        model = mod.load_embedding_model("m", log=logs[tag].append)
        assert (model is None) == (case != "loads")
    assert logs["port"] == logs["jax"] and logs["port"]


@pytest.mark.parametrize("reference", ["org/c-7b", None, "absent/model"])
def test_model_comparison_report_matches_reference(comparison_rows, tmp_path,
                                                   reference):
    out = {}
    for tag, mod, df in (("jax", janalysis, pd.DataFrame(comparison_rows)),
                         ("port", tanalysis, comparison_rows)):
        d = tmp_path / tag
        rep = mod.model_comparison_report(df, str(d), n_bootstrap=60,
                                          reference_model=reference)
        rep["pairwise"] = rep["pairwise"] if tag == "port" else records(
            rep["pairwise"])
        out[tag] = ({k: (os.path.relpath(v, d) if isinstance(v, str) else v)
                     for k, v in rep.items()}, tree(d))
    assert equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert ("difference_strip.png" in out["port"][1]) == (reference == "org/c-7b")


def test_cross_experiment_kappa_matches_reference(comparison_rows):
    second = [dict(r, prompt=r["prompt"] + "b") for r in comparison_rows]
    got = tanalysis.cross_experiment_kappa([comparison_rows, second],
                                           n_bootstrap=50)
    ref = janalysis.cross_experiment_kappa(
        [pd.DataFrame(comparison_rows), pd.DataFrame(second)], n_bootstrap=50)
    assert equal(got, ref) and len(got["pairs"]) == 3


def test_base_vs_instruct_figures_match_reference(tmp_path):
    _, rows = results_rows("100q")
    rows[5]["yes_prob"] = rows[5]["no_prob"] = 0.0
    pair = tanalysis.process_model_pair(rows, "tiiuae/falcon-7b",
                                        "tiiuae/falcon-7b-instruct")
    ref = janalysis.process_model_pair(pd.DataFrame(rows), "tiiuae/falcon-7b",
                                       "tiiuae/falcon-7b-instruct")
    assert equal(pair, records(ref)) and len(pair) == 17
    out = {}
    for tag, mod, df in (("jax", janalysis, pd.DataFrame(rows)),
                         ("port", tanalysis, rows)):
        d = tmp_path / tag
        paths = mod.base_vs_instruct_figures(df, str(d))
        out[tag] = (sorted(paths), tree(d))
    assert out["port"] == out["jax"] and len(out["port"][1]) == 2


def test_combined_confidence_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    scen = legal_scenarios()[:2]
    names = ("GPT-4.1", "Claude", "Gemini")
    paths = {}
    for i, m in enumerate(names):
        rows = workbook_rows(rng, scen, m, 20 + 3 * i)
        rows[1]["Rephrased Main Part"] = rows[0]["Rephrased Main Part"]
        if m == "Claude":
            for r in rows:
                r.pop("Confidence Value")
        paths[m] = write_workbook(tmp_path / f"{m}.xlsx", rows)
    for subset in (names, names[:1]):
        t_frames = {m: both_workbook(paths[m])[0] for m in subset}
        j_frames = {m: both_workbook(paths[m])[1] for m in subset}
        out = {}
        for tag, mod, frames in (("jax", janalysis, j_frames),
                                 ("port", tanalysis, t_frames)):
            d = tmp_path / tag / str(len(subset))
            res = mod.run_combined_analysis(frames, str(d))
            out[tag] = (res, tree(d))
        t_res, j_res = out["port"][0], out["jax"][0]
        assert equal(t_res["stats"], records(j_res["stats"]))
        assert equal(t_res["correlations"], records(j_res["correlations"]))
        assert equal(t_res["combined"], records(j_res["combined"]))
        assert out["port"][1] == out["jax"][1]


def test_analysis_package_exports_this_slice():
    names = {n for n in dir(tanalysis) if not n.startswith("_")}
    vendor = {"calculate_correlations", "compare_with_human_data",
              "evaluate_all_models", "write_report", "analyze_results",
              "build_vendor_evaluators", "consistency_statistics",
              "create_stacked_visualization", "process_scenario_perturbations",
              "run_irrelevant_evaluation", "save_results", "summary_frame",
              "write_outputs", "closed_source_eval", "irrelevant_eval",
              "replication"}
    ref = {n for n in dir(janalysis) if not n.startswith("_")} - vendor
    assert ref <= names
