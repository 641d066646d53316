"""LaTeX table fragments (reference L5).

Covers: per-scenario summary tables + standalone document
(analyze_perturbation_results.py:723-911), compliance tables (:1453-1718),
and the MAE results tables of the ordinary-meaning study
(evaluate_closed_source_models.py:1136-1330).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _esc(text: str) -> str:
    return (
        str(text)
        .replace("&", "\\&")
        .replace("%", "\\%")
        .replace("_", "\\_")
        .replace("#", "\\#")
    )


def summary_stats_table(values, label: str, caption: str) -> str:
    """Mean / std / percentiles / CI-width summary for one scenario's sweep."""
    vals = np.asarray(values, float)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        rows = [("N", "0")]
    else:
        p2_5, p97_5 = np.percentile(vals, [2.5, 97.5])
        rows = [
            ("N", f"{vals.size}"),
            ("Mean", f"{vals.mean():.3f}"),
            ("Std.\\ dev.", f"{vals.std():.3f}"),
            ("Median", f"{np.median(vals):.3f}"),
            ("2.5th percentile", f"{p2_5:.3f}"),
            ("97.5th percentile", f"{p97_5:.3f}"),
            ("95\\% interval width", f"{p97_5 - p2_5:.3f}"),
        ]
    body = "\n".join(f"{name} & {value} \\\\" for name, value in rows)
    return (
        "\\begin{table}[htbp]\n\\centering\n"
        f"\\caption{{{caption}}}\n\\label{{tab:{label}}}\n"
        "\\begin{tabular}{lr}\n\\hline\n"
        f"{body}\n\\hline\n\\end{{tabular}}\n\\end{{table}}"
    )


def standalone_document(tables: Sequence[str], title: str = "Perturbation analysis") -> str:
    body = "\n\n".join(tables)
    return (
        "\\documentclass{article}\n\\usepackage{booktabs}\n"
        f"\\title{{{_esc(title)}}}\n\\begin{{document}}\n\\maketitle\n"
        f"{body}\n\\end{{document}}\n"
    )


def _rows(table):
    """A report's rows: a list of row dicts (``stats.compliance``'s), or
    anything with ``iterrows()``."""
    if hasattr(table, "iterrows"):
        return [row for _, row in table.iterrows()]
    return list(table)


def compliance_table(compliance_df) -> str:
    """First-token / subsequent compliance rates per scenario."""
    lines = [
        "\\begin{tabular}{lrrrr}",
        "\\hline",
        "Prompt & N & First-token \\% & Non-compliant \\% & Subsequent \\% \\\\",
        "\\hline",
    ]
    for row in _rows(compliance_df):
        sub = row.get("Conditional_Subsequent_Compliance_Rate")
        sub_str = f"{sub:.1f}" if sub is not None and np.isfinite(sub) else "--"
        lines.append(
            f"{int(row['Prompt'])} & {int(row['Total_Samples'])} & "
            f"{row['First_Token_Compliance_Rate']:.1f} & "
            f"{row['First_Token_Non_Compliance_Rate']:.1f} & {sub_str} \\\\"
        )
    lines += ["\\hline", "\\end{tabular}"]
    return "\n".join(lines)


def confidence_compliance_table(conf_df) -> str:
    lines = [
        "\\begin{tabular}{lrrrrr}",
        "\\hline",
        "Prompt & N & Compliant \\% & Float & Text & Out-of-range \\\\",
        "\\hline",
    ]
    for row in _rows(conf_df):
        lines.append(
            f"{int(row['Prompt'])} & {int(row['Total_Confidence_Samples'])} & "
            f"{row['Confidence_Compliance_Rate']:.1f} & {int(row['Float_Errors'])} & "
            f"{int(row['Text_Errors'])} & {int(row['Out_Of_Range_Errors'])} \\\\"
        )
    lines += ["\\hline", "\\end{tabular}"]
    return "\n".join(lines)


def mae_results_tables(mae_records: Dict[str, Dict], diff_records: Optional[Dict] = None) -> str:
    """Tables 3/4 style: MAE with CIs per model; differences vs baselines.

    mae_records: name -> {mae, ci_lower, ci_upper}
    diff_records: name -> {baseline -> {diff, ci_lower, ci_upper, p_value}}
    """
    lines = [
        "% Table: MAE vs human mean",
        "\\begin{tabular}{lccc}",
        "\\hline",
        "Model & MAE & \\multicolumn{2}{c}{95\\% CI} \\\\",
        "\\hline",
    ]
    for name, rec in mae_records.items():
        lines.append(
            f"{_esc(name)} & {rec['mae']:.3f} & [{rec['ci_lower']:.3f} & "
            f"{rec['ci_upper']:.3f}] \\\\"
        )
    lines += ["\\hline", "\\end{tabular}"]
    if diff_records:
        lines += [
            "",
            "% Table: MAE differences vs baselines",
            "\\begin{tabular}{llcccc}",
            "\\hline",
            "Model & Baseline & $\\Delta$MAE & CI low & CI high & $p$ \\\\",
            "\\hline",
        ]
        for name, baselines in diff_records.items():
            for bname, rec in baselines.items():
                stars = significance_stars(rec.get("p_value"))
                lines.append(
                    f"{_esc(name)} & {_esc(bname)} & {rec['diff']:+.3f}{stars} & "
                    f"{rec['ci_lower']:.3f} & {rec['ci_upper']:.3f} & "
                    f"{rec['p_value']:.3f} \\\\"
                )
        lines += ["\\hline", "\\end{tabular}"]
    return "\n".join(lines)


def significance_stars(p: Optional[float]) -> str:
    if p is None or not np.isfinite(p):
        return ""
    if p < 0.01:
        return "***"
    if p < 0.05:
        return "**"
    if p < 0.10:
        return "*"
    return ""


def base_vs_instruct_table(family_records: Dict[str, Dict]) -> str:
    """Table-5 style: base→instruct MAE per family with Δ CI and p."""
    lines = [
        "\\begin{tabular}{lcccc}",
        "\\hline",
        "Family & Base MAE & Instruct MAE & $\\Delta$ [95\\% CI] & $p$ \\\\",
        "\\hline",
    ]
    for family, rec in family_records.items():
        if family.startswith("_"):
            continue
        if rec.get("excluded"):
            lines.append(f"{_esc(family)} & \\multicolumn{{4}}{{c}}{{excluded: {_esc(rec.get('reason', ''))}}} \\\\")
            continue
        stars = significance_stars(rec.get("p_value"))
        lines.append(
            f"{_esc(family)} & {rec['base_mae']:.3f} & {rec['instruct_mae']:.3f} & "
            f"{rec['observed_diff']:+.3f}{stars} [{rec['ci_lower']:+.3f}, "
            f"{rec['ci_upper']:+.3f}] & {rec['p_value']:.3f} \\\\"
        )
    lines += ["\\hline", "\\end{tabular}"]
    return "\n".join(lines)


# unicode -> LaTeX replacements for the irrelevant-statement sampler
# (data/generate_latex_statements.py:28-44)
_STATEMENT_REPLACEMENTS = (
    ("&", "\\&"), ("%", "\\%"), ("$", "\\$"), ("#", "\\#"), ("_", "\\_"),
    ("°", "$^\\circ$"), ("−", "$-$"), ("×", "$\\times$"),
    ("π", "$\\pi$"),
    ("⁻¹⁹", "$^{-19}$"), ("⁻³⁴", "$^{-34}$"),
    ("²³", "$^{23}$"), ("₂", "$_2$"),
    ("²", "$^2$"), ("³", "$^3$"), ("–", "--"),
)


def escape_statement(statement: str) -> str:
    for src, dst in _STATEMENT_REPLACEMENTS:
        statement = statement.replace(src, dst)
    return statement


def irrelevant_statements_sample(statements, k: int = 50, seed: int = 42) -> str:
    """Seeded random sample of irrelevant statements as a LaTeX enumerate
    (data/generate_latex_statements.py: random.seed(42) + random.sample(·, 50),
    same escaping rules) for the paper appendix."""
    import random

    rng = random.Random(seed)
    selected = rng.sample(list(statements), k)
    lines = ["\\begin{enumerate}"]
    lines += [f"    \\item {escape_statement(s)}" for s in selected]
    lines.append("\\end{enumerate}")
    return "\n".join(lines)


def power_analysis_table(report, alpha: float = 0.05,
                         sample_size: int = None) -> str:
    """LaTeX table for a `stats.power.power_report` result: per-model effect
    size, required N at 80%/90% power, achieved power at the current N, and
    the limiting-model recommendation."""
    import math

    def fmt_n(n):
        return "$\\infty$" if math.isinf(n) else str(int(n))

    lines = [
        "\\begin{table}[htbp]", "\\centering",
        "\\caption{Power analysis: required sample sizes "
        f"($\\alpha={alpha}$, current $N={sample_size}$)}}",
        "\\begin{tabular}{lrrrr}", "\\hline",
        "Model & Cohen's $d$ & $N$ (80\\% power) & $N$ (90\\% power) "
        "& Power at current $N$ \\\\", "\\hline",
    ]
    for name, analysis in report["models"].items():
        n80 = analysis["sample_sizes"]["power_80"]["raw"]
        n90 = analysis["sample_sizes"]["power_90"]["raw"]
        power_pct = f"{100 * analysis['achieved_power']:.1f}\\%"
        lines.append(
            f"{_esc(str(name))} & {analysis['effect_size']:.3f} & {fmt_n(n80)} & "
            f"{fmt_n(n90)} & {power_pct} \\\\"
        )
    rec = report["recommendation"]["power_80"]
    if math.isinf(rec["raw"]):
        footer = (
            f"No finite $N$ achieves 80\\% power for every model "
            f"(zero observed effect for: {_esc(str(rec['limiting_model']))})."
        )
    else:
        footer = (
            f"Recommended $N$ for 80\\% power across all models: {fmt_n(rec['raw'])} "
            f"({fmt_n(rec['with_margin'])} with 50\\% margin; "
            f"limiting model: {_esc(str(rec['limiting_model']))})."
        )
    lines += ["\\hline", "\\end{tabular}", "\\par\\smallskip " + footer,
              "\\end{table}", ""]
    return "\n".join(lines)
