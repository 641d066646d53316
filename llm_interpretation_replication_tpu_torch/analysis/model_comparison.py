"""Inter-model comparison reports + figures.

Rebuild of model_comparison_graph.py (pairwise correlation engine + heatmap +
distribution + reference-model difference strip) and
calculate_cohens_kappa.py (cross-experiment kappa merge), consuming the
instruct-sweep CSV schema.

A copy of the JAX package's module on the results' row dicts; its figures
are drawn by ``viz.figures``, imported only when one is drawn.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..stats.correlations import (
    correlation_summary_bootstrap,
    pairwise_correlations,
    pairwise_kappa,
    pivot_model_values,
)
from ..utils import frame

#: the columns of ``pairwise_correlations.csv``
PAIRWISE_COLUMNS = ["model_1", "model_2", "n", "pearson_r", "pearson_p",
                    "spearman_r", "spearman_p"]


def difference_strip_plot(df: List[Dict], reference_model: str, output_path: str,
                          value_col: str = "relative_prob") -> Optional[str]:
    """Per-model distribution of (model − reference) differences per prompt
    (model_comparison_graph.py:33-205, Baichuan-referenced in the paper)."""
    pivot = pivot_model_values(df, value_col=value_col)
    if reference_model not in pivot.columns:
        return None
    from ..viz import figures

    ref = pivot.values[:, pivot.columns.index(reference_model)]
    diffs = {}
    for j, model in enumerate(pivot.columns):
        if model != reference_model:
            d = pivot.values[:, j] - ref
            diffs[model] = d[~np.isnan(d)]
    return figures.difference_strip(diffs, reference_model, value_col,
                                    output_path)


def model_comparison_report(
    df: List[Dict],
    output_dir: str,
    value_col: str = "relative_prob",
    n_bootstrap: int = 1000,
    seed: int = 42,
    reference_model: Optional[str] = None,
    make_figures: bool = True,
) -> Dict:
    """All pairwise correlations + bootstrap summary + kappa + figures."""
    os.makedirs(output_dir, exist_ok=True)
    pivot = pivot_model_values(df, value_col=value_col)
    corr_df = pairwise_correlations(pivot)
    summary = correlation_summary_bootstrap(pivot, n_bootstrap=n_bootstrap, seed=seed)
    kappa = pairwise_kappa(pivot, n_bootstrap=n_bootstrap, seed=seed)
    frame.write_csv(PAIRWISE_COLUMNS if corr_df else [], corr_df,
                 os.path.join(output_dir, "pairwise_correlations.csv"))
    report = {"pairwise": corr_df, "summary": summary, "kappa": kappa}
    if make_figures and len(pivot.columns) >= 2:
        from ..viz import figures

        labels = [m.split("/")[-1] for m in pivot.columns]
        mat = frame.pairwise_corr(pivot.values)
        report["heatmap"] = figures.correlation_heatmap(
            mat, labels, "Inter-model Pearson correlations",
            os.path.join(output_dir, "correlation_heatmap.png"),
        )
        if summary["values"]:
            report["distribution"] = figures.correlation_distribution(
                summary["values"], "Pairwise correlation distribution",
                os.path.join(output_dir, "correlation_distribution.png"),
            )
        if reference_model:
            report["difference_strip"] = difference_strip_plot(
                df, reference_model,
                os.path.join(output_dir, "difference_strip.png"), value_col,
            )
    import json

    with open(os.path.join(output_dir, "correlation_summary.json"), "w") as f:
        json.dump(
            {"summary": {k: v for k, v in summary.items() if k != "values"},
             "mean_kappa": kappa["mean_kappa"],
             "mean_kappa_ci": kappa["mean_kappa_ci"]},
            f, indent=2, default=float,
        )
    return report


def cross_experiment_kappa(
    frames: Sequence[List[Dict]],
    value_col: str = "relative_prob",
    threshold: float = 0.5,
    n_bootstrap: int = 1000,
    seed: int = 42,
) -> Dict:
    """Merge multiple experiment frames (same schema) into one prompts×models
    pivot and compute aggregate kappa (calculate_cohens_kappa.py)."""
    merged = [r for rows in frames for r in rows]
    pivot = pivot_model_values(merged, value_col=value_col)
    return pairwise_kappa(pivot, threshold=threshold, n_bootstrap=n_bootstrap, seed=seed)
