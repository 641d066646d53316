"""Base-vs-instruct figure builders (paper Figures 7-8).

Rebuild of analyze_results_base_versus_instruct.py: pair base/instruct rows on
prompt, drop zero-probability rows (:46-52), per-family difference strips and
a family × prompt difference heatmap.

A copy of the JAX package's module on the results' row dicts; its figures
are drawn by ``viz.figures``, imported only when one is drawn.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..utils import frame


def process_model_pair(df: List[Dict], base_model: str, instruct_model: str,
                       value_col: str = "relative_prob") -> List[Dict]:
    """Paired rows with instruct−base differences; zero-prob rows dropped."""
    cols = ["prompt", value_col, "yes_prob", "no_prob"]
    base, inst = ([{c: r[c] for c in cols} for r in df if r["model"] == m]
                  for m in (base_model, instruct_model))
    merged = frame.inner_merge(base, inst, "prompt",
                               suffixes=("_base", "_instruct"))
    # the reference drops rows where both target probabilities are zero
    out = []
    for r in merged:
        if (r["yes_prob_base"] == 0 and r["no_prob_base"] == 0) or (
                r["yes_prob_instruct"] == 0 and r["no_prob_instruct"] == 0):
            continue
        out.append(dict(r, diff=r[f"{value_col}_instruct"] - r[f"{value_col}_base"]))
    return out


def base_vs_instruct_figures(
    df: List[Dict],
    output_dir: str,
    value_col: str = "relative_prob",
) -> Dict[str, str]:
    """Per-family difference strips + a family×prompt heatmap.

    Expects the model_comparison_results.csv schema (model, model_family,
    base_or_instruct, prompt, yes_prob, no_prob, <value_col>).
    """
    os.makedirs(output_dir, exist_ok=True)
    paths: Dict[str, str] = {}
    diffs_by_family: Dict[str, np.ndarray] = {}
    heat_rows = []
    heat_families = []
    prompts: Optional[list] = None
    for family in frame.unique(frame.column(df, "model_family")):
        fam = [r for r in df if r["model_family"] == family]
        base_models, inst_models = (
            frame.unique([r["model"] for r in fam if r["base_or_instruct"] == role])
            for role in ("base", "instruct"))
        if not len(base_models) or not len(inst_models):
            continue
        merged = process_model_pair(fam, base_models[0], inst_models[0], value_col)
        if not len(merged):
            continue
        diffs_by_family[family] = np.asarray(frame.column(merged, "diff"), dtype=float)
        if prompts is None:
            prompts = frame.column(merged, "prompt")
        by_prompt = {r["prompt"]: r["diff"] for r in merged}
        heat_rows.append(np.asarray([by_prompt.get(p, np.nan) for p in prompts],
                                    dtype=float))
        heat_families.append(family)
    if diffs_by_family or (heat_rows and prompts):
        from ..viz import figures
    if diffs_by_family:
        paths["difference_strips"] = figures.jitter_strip_panels(
            diffs_by_family, "Instruct − base relative-probability differences",
            os.path.join(output_dir, "base_vs_instruct_diffs.png"),
            ylabel="Δ relative probability", ylim=(-1, 1),
        )
    if heat_rows and prompts:
        labels = [f"q{i + 1}" for i in range(len(prompts))]
        paths["heatmap"] = figures.mae_heatmap(
            np.vstack(heat_rows), heat_families, labels,
            "Instruct − base differences by prompt",
            os.path.join(output_dir, "base_vs_instruct_heatmap.png"),
        )
    return paths
