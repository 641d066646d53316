"""One-command replication verifier.

Recomputes every headline table of the paper through THIS framework's
statistics pipeline and diffs each number against the published values with
CI-overlap PASS/FAIL verdicts — the harness the per-piece commands
(``run-100q``, ``analyze-mae-100q``, ``model-comparison``, ``analyze-survey``)
compose into but never judged before.

Published targets are transcribed from the paper sources mirrored in
BASELINE.md:

- Table 3 (MAE vs human mean) / Table 4 (MAE differences vs baselines):
  the reference repository's ``main.tex:375-417``
- Table 5 (base→instruct MAE): ``main.tex:432-446``
- Appendix inter-LLM correlations: ``main_online_appendix.tex:517-533``
- Appendix cross-prompt correlations: ``main_online_appendix.tex:582-621``

Two operating modes per check:

- **Recorded-artifact mode** (always available when the reference
  repository is mounted at ``reference_root``): feed the reference's
  committed result artifacts through our statistics stack — verifies the
  downstream pipeline reproduces the paper.
- **Snapshot mode** (``snapshots=`` / ``--snapshots``): additionally run the
  Table-5 sweep with real local HF checkpoints through the engine first
  (run_base_vs_instruct_100q.py:514-599's role), then judge its output
  against the published Table 5.  Without snapshots that check reports
  SKIP — the raw reference CSV for Table 5 was never published
  (``.MISSING_LARGE_BLOBS``), so there is nothing to replay offline.

Verdict rule: a metric PASSES when the recomputed point estimate lands
inside the published 95% CI, the published point lands inside the recomputed
CI, or the two CIs overlap (statistical parity per SURVEY.md §7 — bf16/int8
arithmetic makes bitwise parity the wrong bar); where the paper publishes
only a point value, equality to the paper's printed precision is required.
Significance calls (ns/*/**/***) must match categorically.

A copy of the JAX package's module on row dicts (``utils.frame.read_csv``
in place of pandas' reader); snapshot mode's sweep runs through the port's
``run_sweep`` and engine factory, on the card by default.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..utils import frame

# --------------------------------------------------------------------------
# Published values (rounded exactly as printed in the paper)
# --------------------------------------------------------------------------

TABLE3_MAE = {
    # model -> (mae, ci_lo, ci_hi)   main.tex:375-395
    "Equanimity": (0.175, 0.154, 0.196),
    "Normal": (0.172, 0.147, 0.198),
    "GPT": (0.197, 0.171, 0.224),
    "Claude": (0.229, 0.201, 0.258),
    "Gemini": (0.241, 0.216, 0.268),
}

TABLE4_DIFFS = {
    # (model, baseline) -> (diff, significance)   main.tex:396-417
    ("GPT", "Equanimity"): (0.022, "ns"),
    ("GPT", "Normal"): (0.027, "ns"),
    ("Claude", "Equanimity"): (0.054, "**"),
    ("Claude", "Normal"): (0.059, "***"),
    ("Gemini", "Equanimity"): (0.067, "***"),
    ("Gemini", "Normal"): (0.072, "***"),
}

TABLE5_FAMILIES = {
    # family -> (base_mae, (lo,hi), instruct_mae, (lo,hi), diff, (lo,hi), sig)
    # main.tex:432-446
    "Falcon": (0.333, (0.299, 0.370), 0.468, (0.427, 0.506),
               0.135, (0.082, 0.188), "***"),
    "StableLM": (0.369, (0.329, 0.407), 0.341, (0.304, 0.378),
                 -0.030, (-0.084, 0.024), "ns"),
    "RedPajama": (0.313, (0.230, 0.386), 0.437, (0.320, 0.543),
                  0.122, (-0.010, 0.254), "*"),
}

APPENDIX_INTER_LLM = {
    # main_online_appendix.tex:517-533
    "mean_rho": (0.051, (-0.015, 0.126)),
    "median_rho": (0.045, (-0.065, 0.147)),
    "std_rho": (0.220, (0.209, 0.327)),
}

APPENDIX_CROSS_PROMPT = {
    # main_online_appendix.tex:582-621
    "human": (0.285, (0.238, 0.314)),
    "llm": (0.052, (-0.003, 0.155)),
    "difference": (0.212, (0.126, 0.292)),
}

SIG_LEVELS = (("***", 0.01), ("**", 0.05), ("*", 0.10))


def significance_category(p: float) -> str:
    """Star category from the p-value AT THE PAPER'S PRINTED PRECISION
    (3 decimals): the paper stars Claude-vs-Equanimity ** at recorded
    p=0.0098 because it prints p=0.010 — the stars follow the rounded
    value, not the raw bootstrap estimate."""
    p = round(p, 3)
    for stars, level in SIG_LEVELS:
        if p < level:
            return stars
    return "ns"


def _ci_overlap(a_lo, a_hi, b_lo, b_hi) -> bool:
    return a_lo <= b_hi and b_lo <= a_hi


def _check(table: str, metric: str, published, published_ci,
           computed, computed_ci=None, extra: str = "") -> Dict:
    """One verdict row.  PASS when point-in-CI either direction or the CIs
    overlap; point-only targets require match at printed precision."""
    if computed is None or (isinstance(computed, float) and np.isnan(computed)):
        verdict = "FAIL"
        detail = "no computed value"
    elif published_ci is None and computed_ci is None:
        decimals = max(len(str(published).split(".")[-1]), 1)
        verdict = "PASS" if round(computed, decimals) == published else "FAIL"
        detail = f"point match at {decimals} decimals"
    else:
        plo, phi = published_ci if published_ci else (published, published)
        clo, chi = computed_ci if computed_ci else (computed, computed)
        ok = (plo <= computed <= phi) or (clo <= published <= chi) \
            or _ci_overlap(plo, phi, clo, chi)
        verdict = "PASS" if ok else "FAIL"
        detail = "CI overlap"
    if extra:
        detail = f"{detail}; {extra}"
    return {
        "table": table, "metric": metric,
        "published": published, "published_ci": published_ci,
        "computed": None if computed is None else float(computed),
        "computed_ci": computed_ci, "verdict": verdict, "detail": detail,
    }


def _skip(table: str, metric: str, reason: str) -> Dict:
    return {"table": table, "metric": metric, "published": None,
            "published_ci": None, "computed": None, "computed_ci": None,
            "verdict": "SKIP", "detail": reason}


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------

def check_tables_3_4(results_csv: str, survey1: str, survey2: str,
                     n_bootstrap: int = 10_000) -> List[Dict]:
    """Tables 3-4 through analysis/closed_source_eval.compare_with_human_data
    (the path regression-pinned bit-exactly in test_published_regression)."""
    from .closed_source_eval import compare_with_human_data
    from .questions import load_human_survey_means

    if not os.path.exists(results_csv):
        return [_skip("Table 3", "all", f"missing {results_csv}"),
                _skip("Table 4", "all", f"missing {results_csv}")]
    rows = frame.read_csv(results_csv)[1]
    human_means = load_human_survey_means(survey1, survey2)
    human_std = float(np.std(list(human_means.values())))
    cmp = compare_with_human_data(rows, human_means, human_std=human_std,
                                  n_bootstrap=n_bootstrap, seed=42)
    rows = []
    for model, (mae, lo, hi) in TABLE3_MAE.items():
        got = cmp["mae"].get(model)
        rows.append(_check(
            "Table 3", f"MAE {model}", mae, (lo, hi),
            got and got["mae"],
            got and (got["ci_lower"], got["ci_upper"]),
        ))
    for (model, baseline), (diff, sig) in TABLE4_DIFFS.items():
        got = (cmp.get("differences", {}).get(model) or {}).get(baseline)
        if not got:
            rows.append(_check("Table 4", f"{model} vs {baseline}", diff,
                               None, None))
            continue
        got_sig = significance_category(got["p_value"])
        row = _check(
            "Table 4", f"MAE diff {model} vs {baseline}", diff, None,
            got["diff"], (got["ci_lower"], got["ci_upper"]),
            extra=f"significance {got_sig} (published {sig})",
        )
        if row["verdict"] == "PASS" and got_sig != sig:
            row["verdict"] = "FAIL"
        rows.append(row)
    return rows


def check_table5(results_100q_csv: Optional[str], survey1: str,
                 survey2: str) -> List[Dict]:
    """Table 5 through survey/mae_100q.analyze_families.  ``results_100q_csv``
    comes from a real run-100q sweep (snapshot mode) — the reference never
    committed its own raw CSV, so without one this reports SKIP."""
    if not results_100q_csv or not os.path.exists(results_100q_csv):
        return [_skip("Table 5", f"{fam} base->instruct",
                      "requires --snapshots (or --results-100q from a "
                      "finished run-100q sweep); raw reference CSV "
                      "unpublished")
                for fam in TABLE5_FAMILIES]
    from ..__main__ import _mae_100q_families

    res, _meta = _mae_100q_families(results_100q_csv, [survey1, survey2])
    rows = []
    for fam, (bm, bci, im, ici, diff, dci, sig) in TABLE5_FAMILIES.items():
        got = res.get(fam)
        if not got or got.get("excluded"):
            rows.append(_check("Table 5", f"{fam} base->instruct", diff, dci,
                               None,
                               extra=got and got.get("reason", "excluded")))
            continue
        got_sig = significance_category(got["p_value"])
        for name, pub, pci, val, ci in (
            ("base MAE", bm, bci, got["base_mae"], None),
            ("instruct MAE", im, ici, got["instruct_mae"], None),
            ("diff", diff, dci, got["observed_diff"],
             (got["ci_lower"], got["ci_upper"])),
        ):
            row = _check("Table 5", f"{fam} {name}", pub, pci, val, ci)
            if name == "diff" and row["verdict"] == "PASS" and got_sig != sig:
                row["verdict"] = "FAIL"
                row["detail"] += f"; significance {got_sig} != published {sig}"
            rows.append(row)
    return rows


def check_appendix_inter_llm(instruct_csv: str,
                             n_bootstrap: int = 1000) -> List[Dict]:
    """Online-appendix inter-LLM correlation summary through
    stats/correlations (28 non-degenerate pairs)."""
    from ..stats.correlations import (
        correlation_summary_bootstrap,
        pivot_model_values,
    )

    if not os.path.exists(instruct_csv):
        return [_skip("Appendix inter-LLM", "all", f"missing {instruct_csv}")]
    pivot = pivot_model_values(frame.read_csv(instruct_csv)[1])
    summary = correlation_summary_bootstrap(pivot, n_bootstrap=n_bootstrap,
                                            seed=42)
    return [
        _check("Appendix inter-LLM", "mean pairwise rho",
               *APPENDIX_INTER_LLM["mean_rho"],
               summary["mean"], tuple(summary["mean_ci"]),
               extra=f"{summary['n_pairs']} pairs"),
        _check("Appendix inter-LLM", "median pairwise rho",
               *APPENDIX_INTER_LLM["median_rho"],
               summary["median"], tuple(summary["median_ci"])),
        _check("Appendix inter-LLM", "std of pairwise rho",
               *APPENDIX_INTER_LLM["std_rho"],
               summary["std"], tuple(summary["std_ci"])),
    ]


def check_appendix_cross_prompt(survey_csvs: List[str], llm_csv: str,
                                n_bootstrap: int = 200) -> List[Dict]:
    """Online-appendix human-vs-LLM cross-prompt correlations through
    survey/pipeline (exclusions + 10-question groups + bootstrap)."""
    from ..survey.pipeline import (
        apply_exclusion_criteria,
        cross_prompt_difference_ci,
        human_cross_prompt_correlations,
        llm_cross_prompt_correlations,
        load_and_clean_survey_data,
        match_survey_to_llm_questions,
    )

    if not all(os.path.exists(p) for p in survey_csvs + [llm_csv]):
        return [_skip("Appendix cross-prompt", "all", "missing inputs")]
    df, cols = load_and_clean_survey_data(survey_csvs)
    df, _ = apply_exclusion_criteria(df, cols)
    llm_df = frame.read_csv(llm_csv)[1]
    _, mapping = match_survey_to_llm_questions(llm_df, survey_csvs)
    hum = human_cross_prompt_correlations(df, cols, n_bootstrap=n_bootstrap,
                                          seed=42)
    llm = llm_cross_prompt_correlations(llm_df, mapping,
                                        n_bootstrap=n_bootstrap, seed=42)
    diff = cross_prompt_difference_ci(hum, llm, n_bootstrap=n_bootstrap,
                                      seed=42)
    return [
        _check("Appendix cross-prompt", "human mean correlation",
               *APPENDIX_CROSS_PROMPT["human"],
               hum["mean_correlation"],
               (hum["ci_lower"], hum["ci_upper"])),
        _check("Appendix cross-prompt", "LLM mean correlation",
               *APPENDIX_CROSS_PROMPT["llm"],
               llm["mean_correlation"],
               (llm["ci_lower"], llm["ci_upper"])),
        _check("Appendix cross-prompt", "human - LLM difference",
               *APPENDIX_CROSS_PROMPT["difference"],
               diff["difference"],
               (diff["ci_lower"], diff["ci_upper"])),
    ]


# --------------------------------------------------------------------------
# Orchestration
# --------------------------------------------------------------------------

def run_snapshot_sweep(run_config, output_dir: str) -> str:
    """Snapshot mode: run the real Table-5 sweep (run-100q) with local HF
    checkpoints through the port's engine; returns the results CSV path."""
    from ..sweeps import run_sweep
    from ..__main__ import _engine_factory

    os.makedirs(output_dir, exist_ok=True)
    results_csv = os.path.join(output_dir, "base_vs_instruct_100q_results.csv")

    run_sweep(
        _engine_factory(run_config),
        checkpoint_path=os.path.join(
            output_dir, "base_vs_instruct_100q_checkpoint.json"),
        results_csv=results_csv,
    )
    return results_csv


#: where the JAX CLI looks for the reference repository (its default, kept)
DEFAULT_REFERENCE_ROOT = "/root/reference"


def verify_replication(
    reference_root: str = DEFAULT_REFERENCE_ROOT,
    results_100q_csv: Optional[str] = None,
    n_bootstrap: int = 10_000,
    cross_prompt_bootstrap: int = 200,
) -> Dict:
    """Run every check against the recorded artifacts under
    ``reference_root`` (plus ``results_100q_csv`` for Table 5 when a sweep
    output exists).  Returns {"checks": [...], "n_pass", "n_fail", "n_skip",
    "ok"} — ``ok`` is True when nothing FAILED (SKIPs don't fail the run)."""
    ref = reference_root
    checks: List[Dict] = []
    checks += check_tables_3_4(
        f"{ref}/results/closed_source_evaluation/closed_source_evaluation_results.csv",
        f"{ref}/data/word_meaning_survey_results.csv",
        f"{ref}/data/word_meaning_survey_results_part_2.csv",
        n_bootstrap=n_bootstrap,
    )
    checks += check_table5(
        results_100q_csv,
        f"{ref}/data/word_meaning_survey_results.csv",
        f"{ref}/data/word_meaning_survey_results_part_2.csv",
    )
    checks += check_appendix_inter_llm(
        f"{ref}/data/instruct_model_comparison_results.csv")
    checks += check_appendix_cross_prompt(
        [f"{ref}/data/word_meaning_survey_results.csv",
         f"{ref}/data/word_meaning_survey_results_part_2.csv"],
        f"{ref}/data/instruct_model_comparison_results_combined.csv",
        n_bootstrap=cross_prompt_bootstrap,
    )
    n_pass = sum(c["verdict"] == "PASS" for c in checks)
    n_fail = sum(c["verdict"] == "FAIL" for c in checks)
    n_skip = sum(c["verdict"] == "SKIP" for c in checks)
    return {"checks": checks, "n_pass": n_pass, "n_fail": n_fail,
            "n_skip": n_skip, "ok": n_fail == 0}


def format_report(result: Dict) -> str:
    """Human-readable per-table PASS/FAIL report."""
    lines = ["REPLICATION VERIFICATION", "=" * 60]
    current = None
    for c in result["checks"]:
        if c["table"] != current:
            current = c["table"]
            lines.append("")
            lines.append(current)
            lines.append("-" * len(current))
        pub = c["published"]
        ci = c["published_ci"]
        pub_s = "" if pub is None else (
            f" published {pub}" + (f" [{ci[0]}, {ci[1]}]" if ci else ""))
        got = c["computed"]
        got_ci = c["computed_ci"]
        got_s = "" if got is None else (
            f" computed {got:.3f}"
            + (f" [{got_ci[0]:.3f}, {got_ci[1]:.3f}]" if got_ci else ""))
        lines.append(f"[{c['verdict']:4s}] {c['metric']}:{pub_s}{got_s}"
                     + (f"  ({c['detail']})" if c["verdict"] != "PASS" else ""))
    lines.append("")
    lines.append(f"{result['n_pass']} PASS, {result['n_fail']} FAIL, "
                 f"{result['n_skip']} SKIP -> "
                 + ("REPLICATION OK" if result["ok"] else "REPLICATION FAILED"))
    return "\n".join(lines)
