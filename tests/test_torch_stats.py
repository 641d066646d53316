"""The port's pandas-free statistics layer (``stats/``, ``native/``,
``utils/strict_json.py``, the ``power-analysis`` and ``sample-statements``
commands) against the JAX package's on the same seeded numpy inputs.

Both packages make the same numpy and scipy calls on the same inputs, so
every number is expected bit-equal (compared with ``==``, NaN equal to
NaN).  The native Levenshtein is held against its plain Python version
and the JAX package's on random Unicode strings.
"""

import contextlib
import ctypes
import hashlib
import io
import json
import math
import os

import numpy as np
import pytest

from llm_interpretation_replication_tpu import native as jnative
from llm_interpretation_replication_tpu import stats as jstats
from llm_interpretation_replication_tpu.stats import normality as jnormality
from llm_interpretation_replication_tpu.utils import strict_json as jstrict
from llm_interpretation_replication_tpu_torch import native as tnative
from llm_interpretation_replication_tpu_torch import stats as tstats
from llm_interpretation_replication_tpu_torch.stats import normality as tnormality
from llm_interpretation_replication_tpu_torch.utils import strict_json as tstrict
import chip_smoke
from test_torch_slots import one_torch_thread  # noqa: F401

SEED = 5


def same(a, b):
    """Recursive equality with NaN equal to NaN and arrays compared whole
    (dtype and bits)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def draws(n, seed=SEED, loc=0.4, scale=0.3):
    return np.random.default_rng(seed).normal(loc, scale, n)


# -- bootstrap ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 2, 37])
def test_bootstrap_mae_matches_reference(n):
    v = np.abs(draws(n))
    assert same(tstats.bootstrap_mae(v, n_bootstrap=500),
                jstats.bootstrap_mae(v, n_bootstrap=500))


@pytest.mark.parametrize("baseline", ["scalar", "paired", "mismatched"])
def test_bootstrap_mae_difference_matches_reference(baseline):
    model = np.abs(draws(40))
    base = {"scalar": 0.18, "paired": np.abs(draws(40, SEED + 1)),
            "mismatched": np.abs(draws(25, SEED + 2))}[baseline]
    for m in (model, -model):
        assert same(tstats.bootstrap_mae_difference(m, base, n_bootstrap=700),
                    jstats.bootstrap_mae_difference(m, base, n_bootstrap=700))
    assert tstats.bootstrap_mae_difference([], 0.1) == (None,) * 4


def test_paired_and_generic_bootstrap_match_reference():
    d = draws(64)
    d[::9] = np.nan
    for x in (d, -d, [np.nan]):
        assert same(tstats.paired_mean_diff_bootstrap(x, n_bootstrap=800),
                    jstats.paired_mean_diff_bootstrap(x, n_bootstrap=800))
    for stat in (np.mean, np.median):
        assert same(tstats.bootstrap_statistic(draws(30), stat, 300, 0.9, 3),
                    jstats.bootstrap_statistic(draws(30), stat, 300, 0.9, 3))


# -- normality, the clipped-normal fit ---------------------------------------------

@pytest.mark.parametrize("n", [0, 2, 3, 50, 400])
def test_normality_tests_match_reference(n):
    v = draws(n)
    if n > 10:
        v[::11] = np.inf
    assert same(tstats.normality_tests(v, label="x"),
                jstats.normality_tests(v, label="x"))


def test_ad_tables_match_reference():
    assert tnormality.active_ad_table_version() == \
        jnormality.active_ad_table_version()
    for version in tnormality.AD_NORM_TABLES:
        for n in (5, 50, 500):
            assert same(tnormality.ad_critical_values(n, version),
                        jnormality.ad_critical_values(n, version))
    crit = (0.5, 0.6, 0.7, 0.8, 1.0)
    for stat in (0.1, 0.65, 0.75, 0.9, 2.0, 11.0):
        assert tstats.ad_pvalue_from_bands(stat, crit) == \
            jstats.ad_pvalue_from_bands(stat, crit)


@pytest.mark.parametrize("case", ["mixed", "boundary", "empty", "tight"])
def test_clipped_normal_fit_matches_reference(case):
    v = {"mixed": np.clip(draws(120), 0, 1),
         "boundary": np.array([0.0, 1.0, 0.0, 1.0]),
         "empty": np.array([np.nan]),
         "tight": np.clip(draws(80, loc=0.98, scale=0.05), 0, 1)}[case]
    got = tstats.fit_clipped_normal(v, n_simulations=4000, seed=3)
    ref = jstats.fit_clipped_normal(v, n_simulations=4000, seed=3)
    assert same(got, ref)
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    assert same(tstats.simulate_clipped_normal(rng_t, 0.3, 0.4, 50),
                jstats.simulate_clipped_normal(rng_j, 0.3, 0.4, 50))


# -- power -------------------------------------------------------------------------

def test_power_functions_match_reference(tmp_path):
    for diff, std in ((0.032, 0.126), (0.0, 0.1), (0.05, 0.0)):
        assert same(tstats.required_sample_size(diff, std),
                    jstats.required_sample_size(diff, std))
    assert tstats.simulated_power(0.05, 0.12, 40, 600) == \
        jstats.simulated_power(0.05, 0.12, 40, 600)
    assert tstats.power_curve(0.05, 0.12, [10, 30], 300) == \
        jstats.power_curve(0.05, 0.12, [10, 30], 300)
    from llm_interpretation_replication_tpu_torch.config import (
        power_pilot_results)

    pilot = power_pilot_results()
    models = dict(pilot["models"], Flat={"mae_diff": 0.0, "mae_std": 0.1})
    tex = {k: str(tmp_path / f"{k}.tex") for k in ("port", "jax")}
    got = tstats.power_report(models, pilot["baseline_mae"], 50,
                              n_simulations=300, output_tex=tex["port"])
    ref = jstats.power_report(models, pilot["baseline_mae"], 50,
                              n_simulations=300, output_tex=tex["jax"])
    got.pop("tex_path")
    ref.pop("tex_path")
    assert same(got, ref)
    with open(tex["port"], "rb") as a, open(tex["jax"], "rb") as b:
        assert a.read() == b.read()


def test_power_pilot_asset_is_a_byte_identical_copy():
    from llm_interpretation_replication_tpu import config as jconfig
    from llm_interpretation_replication_tpu_torch import config as tconfig

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    blobs = []
    for pkg in ("llm_interpretation_replication_tpu",
                "llm_interpretation_replication_tpu_torch"):
        with open(os.path.join(root, pkg, "data_assets",
                               "power_pilot_results.json"), "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]
    assert tconfig.power_pilot_results() == jconfig.power_pilot_results()


# -- similarity and the native Levenshtein ------------------------------------------

def random_strings(n, seed=SEED):
    rng = np.random.default_rng(seed)
    alphabet = ["a", "b", "c", " ", "é", "é", "中", "文", "🤖", "\x00",
                "ß", "ΣΑ", "\U0001F1FA\U0001F1F8"]
    return ["".join(rng.choice(alphabet, rng.integers(0, 30)))
            for _ in range(n)]


def test_levenshtein_native_plain_and_reference_agree():
    """The C kernel, its plain Python version and the JAX package's on
    random Unicode strings (code points, astral ones and NUL included):
    identical distances; the normalized similarity too."""
    assert tnative.using_native()
    s = random_strings(40)
    for a, b in zip(s, s[1:] + s[:1]):
        d = tnative.levenshtein(a, b)
        assert d == tnative._levenshtein_py(a, b) == jnative.levenshtein(a, b)
        assert tnative.normalized_levenshtein_similarity(a, b) == \
            jnative.normalized_levenshtein_similarity(a, b)
    assert tnative.normalized_levenshtein_similarity("", "") == 1.0


def test_native_library_lives_in_the_build_directory():
    """Built under ``build/native/`` with a name hashing the source, never
    beside the package's source."""
    tnative.using_native()
    target = tnative._target()
    assert os.path.exists(target)
    assert os.path.dirname(target) == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.endswith(os.path.join("build", "native"))
    here = os.path.dirname(tnative.__file__)
    assert sorted(f for f in os.listdir(here) if not f.startswith("__")) == [
        "levenshtein.c"]


def test_native_failures_raise(monkeypatch, tmp_path):
    """No quiet fallback: a failed build and a failed allocation raise."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="failed"):
        tnative.levenshtein("a", "b")

    class NoMemory:
        @staticmethod
        def levenshtein_u32(*args):
            return ctypes.c_size_t(-1).value

    monkeypatch.setattr(tnative, "_lib", NoMemory())
    with pytest.raises(MemoryError):
        tnative.levenshtein("abc", "abd")


def similarity_texts():
    return chip_smoke._similarity_texts()


def test_similarity_matrices_match_reference():
    texts = similarity_texts()[:9] + random_strings(4)
    for fn in ("bm25_similarity_matrix", "levenshtein_similarity_matrix",
               "tfidf_cosine_matrix"):
        assert same(getattr(tstats, fn)(texts), getattr(jstats, fn)(texts)), fn
    corpus = [t.lower().split() for t in texts]
    for query in (corpus[0], ["the", "zzz"], []):
        assert same(tstats.BM25Okapi(corpus).get_scores(query),
                    jstats.BM25Okapi(corpus).get_scores(query))


def test_calculate_all_similarities_matches_reference():
    texts = similarity_texts()[:6]

    class Embed:
        def encode(self, xs):
            rng = np.random.default_rng(len(xs))
            return rng.normal(size=(len(xs), 8))

    for model in (None, Embed()):
        assert same(tstats.calculate_all_similarities(texts[0], texts[1:], model),
                    jstats.calculate_all_similarities(texts[0], texts[1:], model))


def test_smoke_stats_pins_are_the_reference():
    """What ``chip_smoke.py``'s stats phase holds the card's host to is
    the JAX package's on the CPU: the similarity matrices' digests, the
    sample's bytes, and power-analysis's N(80%) lines and recommendation
    at its default 10,000 simulations."""
    from llm_interpretation_replication_tpu import __main__ as jmain

    texts = similarity_texts()
    assert chip_smoke._matrix_digest(jstats.bm25_similarity_matrix(texts)) \
        == chip_smoke.SIMILARITY_SHA256["bm25"]
    assert chip_smoke._matrix_digest(jstats.levenshtein_similarity_matrix(
        texts)) == chip_smoke.SIMILARITY_SHA256["levenshtein"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jmain.main(["sample-statements"])
    assert hashlib.sha256((out.getvalue()).encode()).hexdigest() == \
        chip_smoke.SAMPLE_STATEMENTS_SHA256
    report = jstats.power_report(
        jstats_pilot()["models"], 0.18, 50, n_simulations=10)
    assert {m: a["sample_sizes"]["power_80"]["raw"]
            for m, a in report["models"].items()} == chip_smoke.POWER_N80
    rec = report["recommendation"]["power_80"]
    assert (rec["with_margin"], rec["limiting_model"]) == (
        chip_smoke.POWER_RECOMMENDED_N, chip_smoke.POWER_LIMITING_MODEL)


def jstats_pilot():
    from llm_interpretation_replication_tpu.config import power_pilot_results

    return power_pilot_results()


def synthetic_sweeps(root, seed=SEED):
    """The two CSVs phase 22 reads, in the sweeps' schemas and rosters
    (run-100q's 12 models, run-instruct-sweep's 10) over the 100
    questions, probabilities from ``seed``."""
    from llm_interpretation_replication_tpu_torch.config import (
        instruct_sweep_models, model_pairs_100q, ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.sweeps.writers import (
        BASE_VS_INSTRUCT_100Q_COLUMNS, INSTRUCT_COMPARISON_COLUMNS,
        model_family_from_name, write_csv)

    rng = np.random.default_rng(seed)
    questions = ordinary_meaning_questions()
    q100, inst = [], []
    for pair in model_pairs_100q():
        for role in ("base", "instruct"):
            for q in questions:
                yes, no = rng.uniform(0.001, 0.5, 2)
                q100.append(dict(yes_prob=yes, no_prob=no,
                                 relative_prob=yes / (yes + no),
                                 completion=" Yes", success=True, prompt=q,
                                 model=pair[role], formatted_prompt=q,
                                 model_family=pair["family"],
                                 base_or_instruct=role))
    for model in instruct_sweep_models():
        for q in questions:
            yes, no = rng.uniform(0.001, 0.5, 2)
            inst.append(dict(prompt=q, model=model,
                             model_family=model_family_from_name(model),
                             model_output="No", yes_prob=yes, no_prob=no,
                             relative_prob=yes / (yes + no)))
    paths = [str(root / "base_vs_instruct_100q_results.csv"),
             str(root / "instruct_model_comparison_results.csv")]
    write_csv(BASE_VS_INSTRUCT_100Q_COLUMNS, q100, paths[0])
    write_csv(INSTRUCT_COMPARISON_COLUMNS, inst, paths[1])
    return paths


def test_smoke_stats_child_passes_on_the_cpu(tmp_path):
    """The stats phase's child runs here too (its gates hold on the CPU,
    the analysis commands over sweeps CSVs in the rosters' shapes and the
    1,003-respondent synthetic survey included) and leaves no CUDA
    context and no pandas, matplotlib, sklearn or JAX."""
    out = io.StringIO()
    sweeps = synthetic_sweeps(tmp_path)
    with contextlib.redirect_stdout(out):
        chip_smoke._stats_host_child(str(tmp_path), *sweeps, 0)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["fails"] == [] and res["using_native"]
    assert res["power"]["n80"] == chip_smoke.POWER_N80
    from llm_interpretation_replication_tpu_torch.survey import MODEL_FAMILIES

    analysis = res["analysis"]
    assert analysis["shared"] == list(MODEL_FAMILIES)
    assert analysis["latex_rows"] == 6 and analysis["model_pairs"] == 66
    assert analysis["survey_sha256"] == chip_smoke.SURVEY_SHA256
    lint = res["lint"]
    assert lint["files"] > 100 and lint["baselined"] == 0
    assert lint["suppressions"] >= 20
    assert set(lint["seconds"]) == {"total", "lint", "contracts"}


# -- strict JSON ---------------------------------------------------------------------

def test_strict_json_matches_reference(tmp_path):
    obj = {"a": float("nan"), "b": [1.0, float("inf"), np.float64("nan"),
                                   np.float32(2.5)], "c": (np.int64(3), "x"),
           "d": {"e": -float("inf"), "f": None}}
    assert same(tstrict.nan_to_null(obj), jstrict.nan_to_null(obj))
    paths = [tstrict.dump_strict(obj, str(tmp_path / "t" / "o.json")),
             jstrict.dump_strict(obj, str(tmp_path / "j" / "o.json"))]
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1] and b"NaN" not in blobs[0]


# -- the two commands ------------------------------------------------------------------

def run_cli(main_mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_mod.main(argv)
    return out.getvalue()


def test_power_analysis_command_matches_reference(tmp_path):
    """``power-analysis`` (in process, 400 simulations, the built-in pilot
    and a ``--pilot-json``): the same printed lines (but the path) and the
    same ``.tex`` bytes as the JAX command."""
    from llm_interpretation_replication_tpu import __main__ as jmain
    from llm_interpretation_replication_tpu_torch import __main__ as tmain

    pilot = tmp_path / "pilot.json"
    pilot.write_text(json.dumps({"baseline_mae": 0.2, "sample_size": 30,
                                 "models": {"A": {"mae_diff": 0.1,
                                                  "mae_std": 0.2,
                                                  "ci_lower": 0.01,
                                                  "ci_upper": 0.2}}}))
    for extra in ([], ["--pilot-json", str(pilot), "--alpha", "0.01"]):
        outs = {}
        for tag, mod in (("port", tmain), ("jax", jmain)):
            d = str(tmp_path / tag / str(len(extra)))
            printed = run_cli(mod, ["power-analysis", "--output-dir", d,
                                    "--simulations", "400", *extra])
            with open(os.path.join(d, "power_analysis_report.tex"), "rb") as f:
                outs[tag] = (printed.replace(d, "<dir>"), f.read())
        assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("argv", [[], ["--k", "7", "--seed", "3"]])
def test_sample_statements_command_matches_reference(tmp_path, argv):
    from llm_interpretation_replication_tpu import __main__ as jmain
    from llm_interpretation_replication_tpu_torch import __main__ as tmain

    assert run_cli(tmain, ["sample-statements", *argv]) == run_cli(
        jmain, ["sample-statements", *argv])
    paths = [str(tmp_path / f"{t}.tex") for t in ("port", "jax")]
    run_cli(tmain, ["sample-statements", *argv, "--output", paths[0]])
    run_cli(jmain, ["sample-statements", *argv, "--output", paths[1]])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_stats_phase_runs_after_the_api_phase():
    """Phase 22 runs in a child process after phase 21 and after the
    run-100q and run-instruct-sweep phases whose CSVs it analyses, and its
    result lands in ``chip_smoke.json``."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert src.index('"api", api_phase') < src.index('"run_100q",') \
        < src.index('"run_instruct_sweep",') \
        < src.index('"stats", stats_phase') < src.index("finally:")
    assert "stats=stres" in src
    assert "_stats_host_child" in inspect.getsource(chip_smoke.stats_phase)
    # 20 s before the vendor and lint legs, whose own 10 s each the
    # budget took on
    assert chip_smoke.STATS_BUDGET_S <= (20 + chip_smoke.VENDOR_EVAL_BUDGET_S
                                         + chip_smoke.LINT_BUDGET_S)


# -- the statistics that took DataFrames (more in tests/test_torch_analysis.py) -----------

def test_stats_package_exports_match_reference():
    names = {n for n in dir(jstats) if not n.startswith("_")}
    assert {n for n in names if callable(getattr(jstats, n))} <= set(dir(tstats))


@pytest.mark.parametrize("case", ["separated", "same", "nan_and_p", "few"])
def test_correlation_distribution_comparison_matches_reference(case):
    a, b = draws(40, SEED, 0.5, 0.2), draws(35, SEED + 1, 0.1, 0.3)
    kwargs = {}
    if case == "same":
        b = draws(35, SEED + 2, 0.5, 0.2)
    if case == "nan_and_p":
        a[::7] = np.nan
        kwargs = dict(p_values_a=np.abs(draws(40, 3, 0, 0.05)),
                      p_values_b=[np.nan] * 35, labels=("humans", "llms"))
    if case == "few":
        with pytest.raises(ValueError) as t_err:
            tstats.compare_correlation_distributions([0.1, np.nan], b)
        with pytest.raises(ValueError) as j_err:
            jstats.compare_correlation_distributions([0.1, np.nan], b)
        assert str(t_err.value) == str(j_err.value)
        return
    assert same(tstats.compare_correlation_distributions(a, b, **kwargs),
                jstats.compare_correlation_distributions(a, b, **kwargs))
    for r, n in ((0.3, 50), (-0.99, 10), (1.0, 20), (0.2, 3)):
        assert same(tstats.fisher_z_pvalue(r, n), jstats.fisher_z_pvalue(r, n))
