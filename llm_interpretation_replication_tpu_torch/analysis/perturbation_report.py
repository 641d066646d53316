"""Per-model perturbation statistics report.

Rebuild of analyze_perturbation_results.py's ``analyze_model`` orchestration
(:1719-1960) + the main-entry split by ``Model`` column (:1963-2026): per
scenario — relative probability from Token_1/Token_2, summary stats, KS/AD
normality, the clipped-normal Monte-Carlo fit, QQ/histogram/model-overlay
figures, LaTeX tables; then the combined jitter panels, Cohen's kappa between
scenario pairs, and the output/confidence compliance audits.

A copy of the JAX package's module on a workbook's row dicts (as
``utils.frame.records`` types them); its figures are drawn by
``viz.figures``, imported only when one is drawn.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..stats.compliance import check_confidence_compliance, check_output_compliance
from ..stats.correlations import cohens_kappa
from ..stats.normality import normality_tests
from ..stats.truncated import fit_clipped_normal
from ..utils import frame
from ..viz import latex


def add_relative_prob(df: List[Dict]) -> List[Dict]:
    """Relative_Prob = T1/(T1+T2) with non-finite guard (:1737-1760)."""
    t1 = np.asarray(frame.to_numeric(frame.column(df, "Token_1_Prob")), dtype=float)
    t2 = np.asarray(frame.to_numeric(frame.column(df, "Token_2_Prob")), dtype=float)
    total = t1 + t2
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(total > 0, t1 / np.where(total == 0, np.nan, total), np.nan)
    return [dict(r, Relative_Prob=float(v)) for r, v in zip(df, rel)]


def analyze_model(
    df: List[Dict],
    model_name: str,
    scenarios: Sequence[Dict],
    output_dir: str,
    n_simulations: int = 100_000,
    seed: int = 42,
    make_figures: bool = True,
) -> Dict:
    """Full per-model report; returns a dict of all computed statistics and
    writes figures/tables under ``output_dir``."""
    os.makedirs(output_dir, exist_ok=True)
    df = add_relative_prob(df)
    report: Dict = {"model": model_name, "scenarios": []}
    latex_tables: List[str] = []

    prob_panels: Dict[str, Sequence[float]] = {}
    conf_panels: Dict[str, Sequence[float]] = {}

    for idx, scenario in enumerate(scenarios):
        sub = [r for r in df if r["Original Main Part"] == scenario["original_main"]]
        if len(sub) < 2:
            report["scenarios"].append({"scenario": idx + 1, "skipped": True, "n": len(sub)})
            continue
        probs = np.asarray(frame.column(sub, "Relative_Prob"), dtype=float)
        conf = np.asarray(frame.to_numeric(frame.column(sub, "Weighted Confidence")),
                          dtype=float)
        name = f"Scenario {idx + 1}"
        prob_panels[name] = probs
        conf_panels[name] = conf

        rec: Dict = {"scenario": idx + 1, "n": int(np.isfinite(probs).sum())}
        finite = probs[np.isfinite(probs)]
        if finite.size:
            p = np.percentile(finite, [2.5, 97.5])
            rec["summary"] = {
                "mean": float(finite.mean()),
                # ddof=1 to match the reference's pandas describe() stats
                # (analyze_perturbation_results.py:1789-1845); single-sample
                # std is NaN, like pandas
                "std": float(finite.std(ddof=1)) if finite.size > 1 else float("nan"),
                "median": float(np.median(finite)),
                "p2_5": float(p[0]),
                "p97_5": float(p[1]),
                "ci_width": float(p[1] - p[0]),
            }
        rec["normality"] = normality_tests(probs, label=name)
        trunc, simulated = fit_clipped_normal(probs, n_simulations=n_simulations, seed=seed)
        rec["truncated_normal"] = trunc
        # confidence rescaled /100 gets the same treatment (:1867-1909)
        conf01 = conf / 100.0
        rec["confidence_normality"] = normality_tests(conf01, label=f"{name} confidence")
        conf_trunc, conf_sim = fit_clipped_normal(conf01, n_simulations=n_simulations, seed=seed)
        rec["confidence_truncated_normal"] = conf_trunc

        latex_tables.append(
            latex.summary_stats_table(
                probs, f"{model_name}-s{idx + 1}",
                f"{model_name} — scenario {idx + 1} relative probability",
            )
        )

        if make_figures:
            from ..viz import figures

            base = os.path.join(output_dir, f"scenario_{idx + 1}")
            figures.probability_histogram(probs, f"{model_name} — {name}", base + "_prob_hist.png")
            figures.probability_histogram(
                conf, f"{model_name} — {name} confidence", base + "_conf_hist.png",
                xlabel="Weighted confidence",
            )
            figures.qq_plot(probs, f"{model_name} — {name}", base + "_qq.png")
            if trunc.get("fit") == "ok" and len(simulated):
                figures.truncated_model_plot(
                    probs, simulated, f"{model_name} — {name} clipped-normal",
                    base + "_truncated.png", ks_statistic=trunc.get("ks_stat"),
                )
        report["scenarios"].append(rec)

    if make_figures and prob_panels:
        from ..viz import figures

        figures.jitter_strip_panels(
            prob_panels, f"{model_name} — relative probability by scenario",
            os.path.join(output_dir, "combined_probability.png"),
        )
        figures.jitter_strip_panels(
            conf_panels, f"{model_name} — weighted confidence by scenario",
            os.path.join(output_dir, "combined_confidence.png"),
            ylabel="Weighted confidence", ylim=(0, 100),
        )

    # Cohen's kappa between binary (>= 0.5) judgments of scenario pairs (:1095-1190)
    kappas = {}
    names = list(prob_panels)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a = np.asarray(prob_panels[names[i]], float)
            b = np.asarray(prob_panels[names[j]], float)
            n = min(a.size, b.size)
            ok = np.isfinite(a[:n]) & np.isfinite(b[:n])
            if ok.sum() >= 3:
                kappas[f"{names[i]} vs {names[j]}"] = cohens_kappa(
                    (a[:n][ok] >= 0.5).astype(int), (b[:n][ok] >= 0.5).astype(int)
                )
    report["scenario_pair_kappa"] = kappas

    compliance = check_output_compliance(df)
    conf_compliance = check_confidence_compliance(df)
    report["compliance"] = compliance
    report["confidence_compliance"] = conf_compliance
    if len(compliance):
        latex_tables.append(latex.compliance_table(compliance))
    if len(conf_compliance):
        latex_tables.append(latex.confidence_compliance_table(conf_compliance))

    with open(os.path.join(output_dir, "tables.tex"), "w") as f:
        f.write(latex.standalone_document(latex_tables, title=f"{model_name} perturbation analysis"))
    return report


def analyze_workbook(
    df: List[Dict],
    scenarios: Sequence[Dict],
    output_root: str,
    **kwargs,
) -> Dict[str, Dict]:
    """Split a multi-model workbook by ``Model`` and report each (:1963-2026)."""
    out = {}
    for model_name in frame.unique(frame.column(df, "Model")):
        model_dir = os.path.join(output_root, str(model_name).replace("/", "--"))
        out[model_name] = analyze_model(
            [r for r in df if r["Model"] == model_name], model_name, scenarios,
            model_dir, **kwargs
        )
    return out
