"""The three vendor-evaluation commands of the port (``run-closed-source``,
``run-irrelevant``, ``verify-replication``) and their modules against the
JAX package's, on the same inputs: scripted vendors
(``chip_smoke._api_transport``, no socket) answer both packages alike,
synthetic Qualtrics exports (``chip_smoke._survey_exports``) and sweep CSVs
in the rosters' schemas stand in for the study's files.

Classes: every CSV, JSON, LaTeX, text and workbook file byte-equal to the
JAX package's (figure PNGs too); a resumed or repeated run sends no
request; the replication checks, numbers and verdicts equal.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest

from llm_interpretation_replication_tpu import __main__ as jmain
from llm_interpretation_replication_tpu.analysis import irrelevant_eval as jirr
from llm_interpretation_replication_tpu.analysis import replication as jrep
from llm_interpretation_replication_tpu_torch import __main__ as tmain
from llm_interpretation_replication_tpu_torch.analysis import irrelevant_eval as tirr
from llm_interpretation_replication_tpu_torch.analysis import replication as trep
from llm_interpretation_replication_tpu_torch.config import (
    irrelevant_scenarios, irrelevant_statements)
from llm_interpretation_replication_tpu_torch.gen.irrelevant import (
    generate_perturbations, save_perturbations)
from llm_interpretation_replication_tpu_torch.sweeps import (
    base_vs_instruct_100q as tsweep)
import chip_smoke
from test_torch_100q import (QUESTIONS, SNAPSHOT_PAIRS, _parse,
                             snapshots)  # noqa: F401
from test_torch_slots import one_torch_thread  # noqa: F401
from test_torch_stats import synthetic_sweeps

SEED = 31
PACKAGES = {"jax": "llm_interpretation_replication_tpu",
            "port": "llm_interpretation_replication_tpu_torch"}
MAINS = {"jax": jmain, "port": tmain}


@pytest.fixture
def vendors(monkeypatch):
    """Both packages' clients talk to scripted vendors; each package's
    requests are counted in its own list; the keys are set and
    ``time.sleep`` (the per-vendor pacing) returns at once."""
    calls = {"jax": [], "port": []}
    for tag, pkg in PACKAGES.items():
        api = importlib.import_module(f"{pkg}.api_backends")
        for mod, vendor in (("openai_client", "openai"),
                            ("anthropic_client", "anthropic"),
                            ("gemini_client", "gemini")):
            monkeypatch.setattr(
                importlib.import_module(f"{pkg}.api_backends.{mod}"),
                "UrllibTransport",
                lambda api=api, vendor=vendor, c=calls[tag]:
                    chip_smoke._api_transport(api, vendor, c))
    for var in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY", "GEMINI_API_KEY"):
        monkeypatch.setenv(var, "scripted-key")
    monkeypatch.setattr(time, "sleep", lambda s: None)
    return calls


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two synthetic survey exports (40 respondents), the two sweep CSVs in
    the rosters' schemas and the irrelevant-insertion corpus."""
    root = tmp_path_factory.mktemp("inputs")
    (s1, s2), _ = chip_smoke._survey_exports(SEED, str(root / "survey"),
                                              n_respondents=40)
    run100q, instruct = synthetic_sweeps(root, SEED)
    corpus = str(root / "perturbations_irrelevant.json")
    save_perturbations(generate_perturbations(
        irrelevant_scenarios(), irrelevant_statements()), corpus)
    return dict(s1=s1, s2=s2, run100q=run100q, instruct=instruct,
                corpus=corpus)


def _files(root, skip=()):
    """{relative path: bytes} of every file under ``root``; a workbook as
    its members' bytes (the zip headers hold the write time)."""
    import zipfile

    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if rel in skip:
                continue
            if rel.endswith(".xlsx"):
                with zipfile.ZipFile(path) as zf:
                    out[rel] = {n: zf.read(n) for n in zf.namelist()}
                continue
            with open(path, "rb") as f:
                out[rel] = f.read()
    return out


def _assert_same_files(tmp_path, skip=()):
    ref = _files(str(tmp_path / "jax"), skip)
    got = _files(str(tmp_path / "port"), skip)
    assert sorted(got) == sorted(ref)
    for rel in ref:
        assert got[rel] == ref[rel], rel
    return got


# -- run-closed-source ------------------------------------------------------------------

def _closed_source(tag, inputs, out, capsys):
    MAINS[tag].main(["run-closed-source", "--questions-csv", inputs["instruct"],
                     "--survey2-csv", inputs["s2"], "--survey1-csv",
                     inputs["s1"], "--output-dir", out, "--yes"])
    return capsys.readouterr().out.replace(out, "<out>")


def test_run_closed_source_matches_reference(vendors, inputs, tmp_path, capsys):
    """100 questions (50 of the instruct CSV, 50 of the part-2 export)
    over the three scripted vendors: the results CSV (one row a question,
    the section 2.8 columns), the response cache, the LaTeX tables, both
    JSON reports and the four figures byte-equal to the JAX package's;
    a second run sends no request, nor does one over the finished cache."""
    from llm_interpretation_replication_tpu_torch.analysis import (
        closed_source_eval as tcs)
    from llm_interpretation_replication_tpu_torch.utils import frame

    printed = {tag: _closed_source(tag, inputs, str(tmp_path / tag), capsys)
               for tag in MAINS}
    assert printed["port"] == printed["jax"]
    files = _assert_same_files(tmp_path)
    assert {"closed_source_evaluation_results.csv", "mae_results_tables.tex",
            "correlations.json", "human_comparisons.json", "api_cache.json",
            "per_question_errors.png", "mae_heatmap.png",
            "model_comparison_plots.png", "mae_comparison.png"} <= set(files)
    columns, rows = frame.read_csv(
        str(tmp_path / "port" / "closed_source_evaluation_results.csv"))
    assert columns == tcs.RESULT_COLUMNS and len(rows) == 100
    assert len({r["question"] for r in rows}) == 100
    asked = len(vendors["port"])
    assert asked == len(vendors["jax"]) > 0
    # a rerun finds the results file; one without it finds the cache full
    _closed_source("port", inputs, str(tmp_path / "port"), capsys)
    os.remove(tmp_path / "port" / "closed_source_evaluation_results.csv")
    _closed_source("port", inputs, str(tmp_path / "port"), capsys)
    assert len(vendors["port"]) == asked
    assert _files(str(tmp_path / "port")) == files


def test_closed_source_partial_rerun_matches_reference(vendors, inputs):
    """A cache missing one vendor on some questions: only that vendor is
    asked again, and the rows equal the JAX package's."""
    from llm_interpretation_replication_tpu.analysis import (
        closed_source_eval as jcs)
    from llm_interpretation_replication_tpu.api_backends import cache as jcache
    from llm_interpretation_replication_tpu_torch.analysis import (
        closed_source_eval as tcs)
    from llm_interpretation_replication_tpu_torch.api_backends import (
        cache as tcache)
    from llm_interpretation_replication_tpu_torch.utils import frame

    questions = frame.unique(frame.column(
        frame.read_csv(inputs["instruct"])[1], "prompt"))[:6]
    out = {}
    for tag, pkg, cs, cache_mod in (("jax", PACKAGES["jax"], jcs, jcache),
                                    ("port", PACKAGES["port"], tcs, tcache)):
        api = importlib.import_module(f"{pkg}.api_backends")
        clients = {f"{v}_client": chip_smoke._api_client(api, vendor,
                                                         vendors[tag])
                   for v, vendor in (("gpt", "openai"), ("gemini", "gemini"),
                                     ("claude", "anthropic"))}
        cache = cache_mod.ResponseCache()
        first = cs.evaluate_all_models(questions, cache=cache, **clients)
        for q in questions[::2]:      # the stored record, in place
            for col in ("gemini_response", "gemini_confidence"):
                cache.get(q).pop(col)
        before = len(vendors[tag])
        again = cs.evaluate_all_models(questions, cache=cache, **clients)
        out[tag] = (first, again, vendors[tag][before:])
    first, again, asked = out["port"]
    jfirst, jagain, jasked = out["jax"]
    assert [dict(r) for r in first] == _records(jfirst)
    assert [dict(r) for r in again] == _records(jagain)
    assert asked == jasked and len(asked) == 2 * len(questions[::2])
    assert all(":generateContent" in url for url in asked)


def _records(df):
    """A JAX function's DataFrame as the port's row dicts (NaN for NaN)."""
    return [{k: (float("nan") if v is None else v) for k, v in r.items()}
            for r in df.to_dict("records")]


# -- run-irrelevant ----------------------------------------------------------------------

def _irrelevant(tag, inputs, out, capsys, *extra):
    MAINS[tag].main(["run-irrelevant", "--perturbations", inputs["corpus"],
                     "--output-dir", out, *extra])
    return capsys.readouterr().out.replace(out, "<out>")


def test_run_irrelevant_matches_reference(vendors, inputs, tmp_path, capsys):
    """``--limit 60`` (20 evaluations a vendor): the raw and summary CSVs,
    the three-sheet workbook, analysis.json, both reports, the
    processed-triple checkpoint and the stacked violins byte-equal to the
    JAX package's; the consistency table finite; a rerun loads the saved
    results and asks nothing."""
    printed = {tag: _irrelevant(tag, inputs, str(tmp_path / tag), capsys,
                                "--limit", "60") for tag in MAINS}
    assert printed["port"] == printed["jax"]
    files = _assert_same_files(tmp_path, skip=("progress.json",))
    assert {"raw_results.csv", "summary.csv", "results_analysis.xlsx",
            "analysis.json", "summary_report.txt", "detailed_prompts.txt",
            "processed_triples.json",
            "three_model_stacked_visualization.png"} <= set(files)
    with open(tmp_path / "port" / "progress.json") as f:
        progress = json.load(f)
    with open(tmp_path / "jax" / "progress.json") as f:
        assert sorted(json.load(f)) == sorted(progress)
    assert progress["done"] == 60
    asked = len(vendors["port"])
    assert asked == len(vendors["jax"]) == 2 * 60
    from llm_interpretation_replication_tpu_torch.utils import frame

    _, summary = frame.read_csv(str(tmp_path / "port" / "summary.csv"))
    assert summary and all(np.isfinite(r["consistency"]) for r in summary)
    again = _irrelevant("port", inputs, str(tmp_path / "port"), capsys,
                        "--limit", "60")
    assert "to force re-running evaluations" in again
    assert len(vendors["port"]) == asked


def test_irrelevant_resume_asks_nothing(vendors, inputs, tmp_path):
    """The processed-triple checkpoint: a second pass over the same
    triples asks nothing and returns the same rows, as the JAX package's;
    consistency_statistics and write_outputs (CSV, JSON, workbook and the
    per-model violins) byte-equal to the JAX package's."""
    from llm_interpretation_replication_tpu_torch.gen.irrelevant import (
        load_perturbations)

    scenarios = load_perturbations(inputs["corpus"])[:2]
    rows = {}
    for tag, pkg, mod in (("jax", PACKAGES["jax"], jirr),
                          ("port", PACKAGES["port"], tirr)):
        api = importlib.import_module(f"{pkg}.api_backends")
        evaluators = mod.build_vendor_evaluators(
            gpt_client=chip_smoke._api_client(api, "openai", vendors[tag]),
            claude_client=chip_smoke._api_client(api, "anthropic",
                                                 vendors[tag]))
        out = str(tmp_path / "run" / tag)
        first = mod.process_scenario_perturbations(
            evaluators, scenarios, out, max_per_scenario=3)
        asked = len(vendors[tag])
        second = mod.process_scenario_perturbations(
            evaluators, scenarios, out, max_per_scenario=3)
        assert len(vendors[tag]) == asked == 2 * 2 * 2 * 4
        stats = mod.consistency_statistics(second)
        mod.write_outputs(second, stats, str(tmp_path / tag))
        rows[tag] = (first, second, stats)
    first, second, stats = rows["port"]
    assert len(first) == len(second) == 2 * 2 * 4
    assert _same_rows(second, _records(rows["jax"][1]))
    assert _same_rows(stats, _records(rows["jax"][2]))
    _assert_same_files(tmp_path, skip=())


def _same_rows(got, ref):
    def norm(v):
        return "nan" if isinstance(v, float) and v != v else v
    return [{k: norm(v) for k, v in r.items()} for r in got] == \
        [{k: norm(v) for k, v in r.items()} for r in ref]


# -- verify-replication ----------------------------------------------------------------------

def _reference_tree(root, inputs, closed_source_csv):
    """The reference's file names (``replication.verify_replication``) over
    the synthetic inputs."""
    data = root / "data"
    results = root / "results" / "closed_source_evaluation"
    data.mkdir(parents=True)
    results.mkdir(parents=True)
    links = {data / "word_meaning_survey_results.csv": inputs["s1"],
             data / "word_meaning_survey_results_part_2.csv": inputs["s2"],
             data / "instruct_model_comparison_results.csv": inputs["instruct"],
             data / "instruct_model_comparison_results_combined.csv":
                 inputs["instruct"],
             results / "closed_source_evaluation_results.csv":
                 closed_source_csv}
    for dst, src in links.items():
        os.symlink(src, dst)
    return str(root)


@pytest.fixture(scope="module")
def reference_tree(inputs, tmp_path_factory):
    """A reference tree whose closed-source results come from a scripted
    run of the port's evaluation."""
    from llm_interpretation_replication_tpu_torch.analysis import (
        closed_source_eval as tcs)
    from llm_interpretation_replication_tpu_torch.analysis.questions import (
        load_ordinary_meaning_questions)

    api = importlib.import_module(f"{PACKAGES['port']}.api_backends")
    out = str(tmp_path_factory.mktemp("closed_source"))
    clients = {f"{v}_client": chip_smoke._api_client(api, vendor)
               for v, vendor in (("gpt", "openai"), ("gemini", "gemini"),
                                 ("claude", "anthropic"))}
    questions = load_ordinary_meaning_questions(inputs["instruct"],
                                                inputs["s2"])
    rows = tcs.evaluate_all_models(questions, **clients)
    tcs.write_report(rows, {"mae": {}, "differences": {}}, {}, out)
    root = tmp_path_factory.mktemp("reference")
    return _reference_tree(root, inputs, os.path.join(
        out, "closed_source_evaluation_results.csv"))


def _check_rows_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k not in ("computed",
                                                         "computed_ci")} == \
            {k: v for k, v in r.items() if k not in ("computed",
                                                     "computed_ci")}
        for key in ("computed", "computed_ci"):
            if r[key] is None:
                assert g[key] is None
            else:
                np.testing.assert_allclose(np.asarray(g[key], float),
                                           np.asarray(r[key], float),
                                           rtol=1e-12, atol=1e-15)


def test_verify_replication_matches_reference(inputs, reference_tree):
    """Every check of the synthetic reference tree, with the Table-5 CSV:
    the same checks, verdicts and numbers (the cross-prompt correlations to
    the rater sums' 1e-12 class), the same counts and report."""
    kw = dict(reference_root=reference_tree, results_100q_csv=inputs["run100q"],
              n_bootstrap=200, cross_prompt_bootstrap=5)
    got, ref = trep.verify_replication(**kw), jrep.verify_replication(**kw)
    _check_rows_equal(got["checks"], ref["checks"])
    assert {k: got[k] for k in ("n_pass", "n_fail", "n_skip", "ok")} == \
        {k: ref[k] for k in ("n_pass", "n_fail", "n_skip", "ok")}
    assert trep.format_report(got) == jrep.format_report(ref)
    assert got["n_skip"] == 0 and len(got["checks"]) == 20
    missing = trep.verify_replication(reference_root=str(reference_tree) + "-x")
    assert missing == jrep.verify_replication(
        reference_root=str(reference_tree) + "-x")


def test_verify_replication_cli_matches_reference(inputs, reference_tree,
                                                  tmp_path, capsys):
    """The command: the same report, exit code 1 exactly when a check
    fails, and the same JSON."""
    codes, printed = {}, {}
    for tag in MAINS:
        out_json = str(tmp_path / f"{tag}.json")
        try:
            MAINS[tag].main([
                "verify-replication", "--reference-root", reference_tree,
                "--results-100q", inputs["run100q"], "--bootstrap", "200",
                "--cross-prompt-bootstrap", "5", "--output-json", out_json])
            codes[tag] = 0
        except SystemExit as exit_:
            codes[tag] = exit_.code
        printed[tag] = capsys.readouterr().out.replace(out_json, "<json>")
        with open(out_json) as f:
            result = json.load(f)
        assert codes[tag] == (1 if result["n_fail"] else 0)
    assert codes["port"] == codes["jax"]
    assert printed["port"] == printed["jax"]


def test_verify_replication_snapshot_sweep(snapshots, inputs, reference_tree,  # noqa: F811
                                           tmp_path, capsys, monkeypatch):
    """``--snapshots``: the Table-5 sweep runs through the port's
    ``run_sweep`` and engine factory over tiny snapshots (on the CPU here),
    writes the in-process sweep's CSV bytes, and feeds Table 5's checks,
    which equal the JAX package's on that CSV."""
    from llm_interpretation_replication_tpu_torch.utils import frame

    monkeypatch.setattr(tsweep, "model_pairs_100q", lambda: SNAPSHOT_PAIRS)
    monkeypatch.setattr(tsweep, "ordinary_meaning_questions",
                        lambda: list(QUESTIONS))
    out = str(tmp_path / "snap")
    with pytest.raises(SystemExit):
        tmain.main(["verify-replication", "--snapshots", snapshots,
                    "--device", "cpu", "--dtype", "float32", "--batch-size",
                    "4", "--output-dir", out, "--reference-root",
                    reference_tree, "--bootstrap", "200",
                    "--cross-prompt-bootstrap", "5"])
    capsys.readouterr()
    csv_path = os.path.join(out, "base_vs_instruct_100q_results.csv")
    _, rows = frame.read_csv(csv_path)
    assert len(rows) == 4 * len(QUESTIONS) and all(r["success"] for r in rows)
    rc = tmain._run_config(_parse([
        "run-100q", "--device", "cpu", "--dtype", "float32",
        "--checkpoint-dir", snapshots, "--batch-size", "4"]))
    tsweep.run_sweep(tmain._engine_factory(rc),
                     checkpoint_path=str(tmp_path / "in" / "ck.json"),
                     results_csv=str(tmp_path / "in" / "out.csv"))
    with open(csv_path, "rb") as f:
        assert f.read() == (tmp_path / "in" / "out.csv").read_bytes()
    _check_rows_equal(trep.check_table5(csv_path, inputs["s1"], inputs["s2"]),
                      jrep.check_table5(csv_path, inputs["s1"], inputs["s2"]))


def test_vendor_modules_import_nothing_off_card():
    """The three modules and the CLI load neither pandas nor matplotlib
    nor sklearn (nor JAX) when imported, and create no CUDA context."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "import llm_interpretation_replication_tpu_torch.__main__\n"
        "from llm_interpretation_replication_tpu_torch.analysis import "
        "closed_source_eval, irrelevant_eval, replication\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'sklearn', 'pandas', 'jax', 'jaxlib', "
        "'llm_interpretation_replication_tpu'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
