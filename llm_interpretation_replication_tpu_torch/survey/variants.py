"""Survey-analysis variants: 3-way base/instruct/human comparison, per-family
metric differences, and the ground-truth distribution figure.

Rebuilds the three standalone reference scripts that have no condensed
equivalent in the main pipeline:

- ``analyze_base_vs_instruct_vs_human.py:1-244`` — per-model Pearson/Spearman/
  MAE against human proportions, output-validity audit, probability-
  distribution stats, best-model scatter figure.
- ``analyze_llm_human_agreement_bootstrap.py`` (the JSON producer) +
  ``analyze_model_family_differences.py:1-231`` — respondent-level bootstrap
  of MAE/MSE/MAPE per model, then per-family instruct − base differences with
  quadrature-combined CIs.
- ``visualize_ground_truth_distribution.py:1-265`` — human ground-truth
  histogram with fitted normal + random-baseline panel, and the simplified
  single-panel variant.
- ``analyze_llm_human_agreement.py:1-315`` — per-model point-estimate
  agreement with the cleaned human means (MAE/RMSE/MAPE/Pearson/Spearman,
  worst questions, cross-model question variance) →
  ``llm_human_agreement_analysis.json``.
- ``analyze_llm_agreement_simple_bootstrap.py:1-482`` — QUESTION-level
  bootstrap of the same metrics (the respondent-level variant is
  ``agreement_bootstrap`` above) plus a base-vs-instruct group comparison
  with a permutation p-value → ``llm_human_agreement_bootstrap.json``.

A copy of the JAX package's module on row dicts (``utils.frame``); its
figures are drawn by ``viz.figures``, imported only when one is drawn.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import frame

from .mae_100q import MODEL_FAMILIES


# ---------------------------------------------------------------------------
# 3-way base vs instruct vs human (analyze_base_vs_instruct_vs_human.py)
# ---------------------------------------------------------------------------

def human_proportions_by_prompt(survey_df: List[Dict],
                                question_cols: Sequence[str],
                                mapping: Dict[str, str]) -> Dict[str, float]:
    """prompt -> human proportion-yes (mean slider / 100).  The reference
    consumed a pre-built ``proportion_yes`` from its saved JSON
    (analyze_base_vs_instruct_vs_human.py:71-74); the producer is not in the
    replication package, so the paper's convention (mean response normalized
    to 0-1) is used throughout — one source: pipeline.human_responses_by_question."""
    from .pipeline import human_responses_by_question

    present = survey_df[0] if survey_df else {}
    cols = [q for q in mapping if q in present]
    stats = human_responses_by_question(survey_df, cols)
    return {mapping[qid]: s["mean"] / 100.0 for qid, s in stats.items()}


def _model_pairs(llm_df: List[Dict], model, human_proportions: Dict[str, float],
                 finite_only: bool):
    return [
        (human_proportions[row["prompt"]], row["relative_prob"])
        for row in llm_df
        if row["model"] == model and row["prompt"] in human_proportions
        and (not finite_only or not frame.is_na(row["relative_prob"]))
    ]


#: the columns of ``model_human_correlations``' rows
CORRELATION_COLUMNS = ["model", "n_questions", "pearson_r", "pearson_p",
                       "spearman_r", "spearman_p", "mae"]


def model_human_correlations(llm_df: List[Dict],
                             human_proportions: Dict[str, float],
                             min_questions: int = 10) -> List[Dict]:
    """Per-model Pearson/Spearman/MAE vs human proportions, sorted by Pearson
    (reference :81-125)."""
    from scipy.stats import pearsonr, spearmanr

    records = []
    for model in frame.unique(frame.column(llm_df, "model")):
        pairs = _model_pairs(llm_df, model, human_proportions, True)
        if len(pairs) < min_questions:
            continue
        h, m = np.array(pairs).T
        pr, pp = pearsonr(h, m)
        sr, sp = spearmanr(h, m)
        records.append({
            "model": model, "n_questions": len(pairs),
            "pearson_r": float(pr), "pearson_p": float(pp),
            "spearman_r": float(sr), "spearman_p": float(sp),
            "mae": float(np.mean(np.abs(h - m))),
        })
    order = frame.sort_desc([r["pearson_r"] for r in records])
    return [records[i] for i in order]


def output_validity_audit(llm_df: List[Dict]) -> List[Dict]:
    """Rows whose model_output contains neither Yes nor No (reference
    :128-148)."""
    invalid = []
    if not llm_df or "model_output" not in llm_df[0]:
        return invalid
    for row in llm_df:
        output = str(row["model_output"]).lower()
        if "yes" not in output and "no" not in output:
            invalid.append({"model": row["model"], "prompt": row["prompt"],
                            "output": row["model_output"]})
    return invalid


def probability_distribution_stats(llm_df: List[Dict]) -> List[Dict]:
    """Per-model relative_prob mean/std/min/max with the reference's
    yes/no-bias warnings (:151-172)."""
    records = []
    for model in frame.unique(frame.column(llm_df, "model")):
        probs = np.asarray(frame.dropna(
            [r["relative_prob"] for r in llm_df if r["model"] == model]),
            dtype=float)
        if not len(probs):
            continue
        mean = float(np.mean(probs))
        warning = ""
        if mean < 0.3:
            warning = "tends to answer 'No' (low mean probability)"
        elif mean > 0.7:
            warning = "tends to answer 'Yes' (high mean probability)"
        records.append({
            "model": model, "mean": mean, "std": frame.std(probs),
            "min": float(probs.min()), "max": float(probs.max()),
            "warning": warning,
        })
    return records


def human_vs_model_scatter(llm_df: List[Dict],
                           human_proportions: Dict[str, float],
                           model: str, pearson_r: float,
                           output_path: str) -> str:
    """Scatter of the best-correlated model vs humans with identity line
    (reference :175-214)."""
    from ..viz import figures

    pairs = _model_pairs(llm_df, model, human_proportions, False)
    h, m = np.array(pairs).T
    return figures.human_vs_model_scatter(h, m, model, pearson_r, output_path)


def three_way_report(llm_df: List[Dict], survey_df: List[Dict],
                     question_cols: Sequence[str], mapping: Dict[str, str],
                     output_dir: str, make_figures: bool = True) -> Dict:
    """The full 3-way analysis: correlations CSV + audit + distribution stats
    + best-model scatter (analyze_base_vs_instruct_vs_human.py end-to-end)."""
    os.makedirs(output_dir, exist_ok=True)
    props = human_proportions_by_prompt(survey_df, question_cols, mapping)
    corr = model_human_correlations(llm_df, props)
    invalid = output_validity_audit(llm_df)
    dist = probability_distribution_stats(llm_df)
    corr_path = os.path.join(output_dir, "model_human_correlations.csv")
    frame.write_csv(CORRELATION_COLUMNS if corr else [], corr, corr_path)
    out = {
        "human_questions": len(props),
        "correlations": corr,
        "invalid_responses": invalid,
        "distribution_stats": dist,
        "correlations_csv": corr_path,
    }
    if make_figures and len(corr):
        best = corr[0]
        out["figure"] = human_vs_model_scatter(
            llm_df, props, best["model"], best["pearson_r"],
            os.path.join(output_dir, "human_vs_model_comparison.png"),
        )
    return out


# ---------------------------------------------------------------------------
# Respondent-level agreement bootstrap + per-family differences
# ---------------------------------------------------------------------------

def _metric_summary(name: str, vals, alpha: float = 0.05) -> Dict:
    """mean/std/percentile-CI record fields for one bootstrap metric —
    shared by the respondent-level and question-level bootstraps."""
    vals = np.asarray(vals, float)
    vals = vals[np.isfinite(vals)]
    if not vals.size:
        nan = float("nan")
        return {f"{name}_mean": nan, f"{name}_ci_lower": nan,
                f"{name}_ci_upper": nan, f"{name}_std": nan}
    return {
        f"{name}_mean": float(np.mean(vals)),
        f"{name}_ci_lower": float(np.percentile(vals, alpha / 2 * 100)),
        f"{name}_ci_upper": float(np.percentile(vals, (1 - alpha / 2) * 100)),
        f"{name}_std": float(np.std(vals)),
    }


def agreement_bootstrap(llm_df: List[Dict], survey_df: List[Dict],
                        question_cols: Sequence[str], mapping: Dict[str, str],
                        n_bootstrap: int = 100, seed: int = 42,
                        min_questions: int = 10) -> Dict:
    """Per-model MAE/MSE/MAPE/pearson vs human means with a respondent-level
    bootstrap (analyze_llm_human_agreement_bootstrap.py): resample survey
    respondents, recompute per-question human means, re-score every model
    against them; report mean/std/95% CI per metric."""
    prompt_for = {qid: prompt for qid, prompt in mapping.items()
                  if not qid.endswith("_8")}
    present = survey_df[0] if survey_df else {}
    cols = [q for q in question_cols if q in prompt_for and q in present]
    rng = np.random.default_rng(seed)
    n_resp = len(survey_df)
    model_rows = {
        model: {
            row["prompt"]: row["relative_prob"]
            for row in llm_df
            if row["model"] == model and not frame.is_na(row["relative_prob"])
        }
        for model in frame.unique(frame.column(llm_df, "model"))
    }
    # [n_bootstrap, n_cols] bootstrapped human means (0-1)
    values = np.asarray([[r[c] for c in cols] for r in survey_df],
                        dtype=float).reshape(n_resp, len(cols))
    boot_means = np.empty((n_bootstrap, len(cols)))
    for b in range(n_bootstrap):
        idx = rng.integers(0, n_resp, size=n_resp)
        boot_means[b] = np.nanmean(values[idx], axis=0) / 100.0

    results = []
    for model, by_prompt in model_rows.items():
        keep = [j for j, q in enumerate(cols) if prompt_for[q] in by_prompt]
        if len(keep) < min_questions:
            continue
        preds = np.array([by_prompt[prompt_for[cols[j]]] for j in keep])
        h = boot_means[:, keep]                    # [n_bootstrap, n_q]
        err = h - preds[None, :]
        mae = np.abs(err).mean(axis=1)
        mse = (err ** 2).mean(axis=1)
        # MAPE mirrors the reference's finite-filter semantics
        # (analyze_llm_human_agreement_bootstrap.py:179-182): every FINITE
        # |err|/h term is kept — including tiny-but-nonzero human means,
        # whose terms are huge but finite — and only inf (h == 0) and nan
        # terms drop; a resample with no finite terms reports nan.
        with np.errstate(divide="ignore", invalid="ignore"):
            ape = np.abs(err) / h
        finite = np.isfinite(ape)
        n_fin = finite.sum(axis=1)
        mape = np.where(
            n_fin > 0,
            np.where(finite, ape, 0.0).sum(axis=1) / np.maximum(n_fin, 1),
            np.nan,
        ) * 100
        hc = h - h.mean(axis=1, keepdims=True)
        pc = preds - preds.mean()
        denom = np.sqrt((hc ** 2).sum(axis=1) * (pc ** 2).sum())
        pearson = np.where(denom > 0, (hc * pc[None, :]).sum(axis=1) / denom, np.nan)
        rec = {"model": model, "n_questions": len(keep),
               "n_bootstrap": n_bootstrap}
        for name, vals in (("mae", mae), ("mse", mse), ("mape", mape),
                           ("pearson_r", pearson)):
            rec.update(_metric_summary(name, vals))
        results.append(rec)
    return {
        "analysis_type": "llm_human_agreement_bootstrap",
        "bootstrap_parameters": {"n_iterations": n_bootstrap, "seed": seed},
        "model_results": results,
    }


def family_differences(agreement: Dict,
                       families: Optional[Dict] = None,
                       metrics: Sequence[str] = ("mae", "mse", "mape")) -> List[Dict]:
    """Per-family instruct − base differences per metric with the reference's
    quadrature-combined CI (analyze_model_family_differences.py:51-120):
    half-width = sqrt(base_range² + instruct_range²) / 2; significant when the
    CI excludes zero."""
    families = families or {
        k: v for k, v in MODEL_FAMILIES.items()
        if k in ("Falcon", "StableLM", "RedPajama")
    }
    by_model = {r["model"]: r for r in agreement["model_results"]}
    records = []
    for family, pair in families.items():
        base = by_model.get(pair["base"])
        inst = by_model.get(pair["instruct"])
        if base is None or inst is None:
            records.append({"family": family, "missing": True})
            continue
        for metric in metrics:
            diff = inst[f"{metric}_mean"] - base[f"{metric}_mean"]
            base_range = base[f"{metric}_ci_upper"] - base[f"{metric}_ci_lower"]
            inst_range = inst[f"{metric}_ci_upper"] - inst[f"{metric}_ci_lower"]
            half = float(np.sqrt(base_range ** 2 + inst_range ** 2)) / 2
            lo, hi = diff - half, diff + half
            records.append({
                "family": family, "metric": metric, "missing": False,
                "base_mean": base[f"{metric}_mean"],
                "base_ci": (base[f"{metric}_ci_lower"], base[f"{metric}_ci_upper"]),
                "instruct_mean": inst[f"{metric}_mean"],
                "instruct_ci": (inst[f"{metric}_ci_lower"], inst[f"{metric}_ci_upper"]),
                "diff": float(diff), "ci_lower": float(lo), "ci_upper": float(hi),
                "relative_change_pct": float(diff / base[f"{metric}_mean"] * 100)
                if base[f"{metric}_mean"] else float("nan"),
                "significant": bool(lo * hi > 0),
            })
    return records


def family_differences_text(records: List[Dict]) -> str:
    """The reference's printed per-family report + summary table."""
    lines = ["=== PER-FAMILY BASE vs INSTRUCT DIFFERENCES ===",
             "With 95% Confidence Intervals", "=" * 100]
    for rec in records:
        if rec.get("missing"):
            lines.append(f"\n{rec['family'].upper()}\nMissing data")
            continue
        if rec["metric"] == "mae":
            lines.append(f"\n{rec['family'].upper()}\n" + "-" * 60)
        pct = "%" if rec["metric"] == "mape" else ""
        fmt = ".1f" if rec["metric"] == "mape" else ".4f"
        lines += [
            f"\n{rec['metric'].upper()} Difference (Instruct - Base):",
            f"  Base:     {rec['base_mean']:{fmt}}{pct} "
            f"[{rec['base_ci'][0]:{fmt}}, {rec['base_ci'][1]:{fmt}}]",
            f"  Instruct: {rec['instruct_mean']:{fmt}}{pct} "
            f"[{rec['instruct_ci'][0]:{fmt}}, {rec['instruct_ci'][1]:{fmt}}]",
            f"  Absolute Difference: {rec['diff']:+{fmt}}{pct} "
            f"[{rec['ci_lower']:+{fmt}}, {rec['ci_upper']:+{fmt}}]",
            f"  Relative Change: {rec['relative_change_pct']:+.1f}%",
            ("  -> " + ("Significantly worse" if rec["diff"] > 0
                        else "Significantly better") + " (95% CI excludes 0)")
            if rec["significant"] else "  -> Not significant (95% CI includes 0)",
        ]
    lines += ["", "=== SUMMARY TABLE ===", "-" * 100,
              f"{'Family':<12} {'Metric':<6} {'Base':<12} {'Instruct':<12} "
              f"{'Difference':<14} {'Significant?':<14}", "-" * 100]
    for rec in records:
        if rec.get("missing"):
            continue
        fmt = ".1f" if rec["metric"] == "mape" else ".4f"
        lines.append(
            f"{rec['family']:<12} {rec['metric'].upper():<6} "
            f"{rec['base_mean']:<12{fmt}} {rec['instruct_mean']:<12{fmt}} "
            f"{rec['diff']:<+14{fmt}} "
            f"{'YES' if rec['significant'] else 'no':<14}"
        )
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Ground-truth distribution figures
# ---------------------------------------------------------------------------

def ground_truth_values(survey_df: List[Dict],
                        question_cols: Sequence[str]) -> np.ndarray:
    """Per-question human mean (0-1) — the 'ground truth' each model is scored
    against (visualize_ground_truth_distribution.py:22-76); delegates to the
    pipeline helper so the normalization convention has one home."""
    from .pipeline import human_responses_by_question

    present = survey_df[0] if survey_df else {}
    cols = [q for q in question_cols if q in present]
    stats = human_responses_by_question(survey_df, cols)
    return np.asarray([s["mean"] / 100.0 for s in stats.values()])


def ground_truth_figures(human_values: np.ndarray, output_dir: str) -> Dict:
    """Two-panel (histogram + fitted normal; random-baseline overlay) and
    simplified single-panel figures (reference :79-199)."""
    from ..viz import figures

    os.makedirs(output_dir, exist_ok=True)
    pct = human_values * 100
    mean_pct, std_pct = float(np.mean(pct)), float(np.std(pct))
    paths = figures.ground_truth_distribution(
        pct, mean_pct, std_pct, output_dir,
        lambda n, centers: _lowess(n, centers, frac=0.3))
    return {"two_panel": paths["two_panel"], "simple": paths["simple"],
            "mean": mean_pct / 100, "std": std_pct / 100,
            "n": int(human_values.size)}


def _lowess(y: np.ndarray, x: np.ndarray, frac: float = 0.3) -> np.ndarray:
    """Minimal tricube-weighted local linear smoother — the reference uses
    statsmodels' lowess (visualize_ground_truth_distribution.py:176-182),
    which is not in this image; same algorithm, one iteration."""
    order = np.argsort(x)
    x, y = np.asarray(x, float)[order], np.asarray(y, float)[order]
    n = len(x)
    span = max(2, int(np.ceil(frac * n)))
    out = np.empty(n)
    for i in range(n):
        d = np.abs(x - x[i])
        cutoff = np.sort(d)[span - 1]
        w = np.clip(1 - (d / max(cutoff, 1e-12)) ** 3, 0, 1) ** 3
        sw = w.sum()
        xm = (w * x).sum() / sw
        ym = (w * y).sum() / sw
        cov = (w * (x - xm) * (y - ym)).sum()
        var = (w * (x - xm) ** 2).sum()
        beta = cov / var if var > 0 else 0.0
        out[i] = ym + beta * (x[i] - xm)
    return np.column_stack([x, out])


def save_agreement_json(agreement: Dict, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(agreement, f, indent=2, default=float)
    return path


# ---------------------------------------------------------------------------
# Point-estimate + question-bootstrap agreement reports
# (analyze_llm_human_agreement.py, analyze_llm_agreement_simple_bootstrap.py)
# ---------------------------------------------------------------------------

def human_agreement_means(survey_filepaths, llm_df: List[Dict]) -> Dict[str, float]:
    """prompt → cleaned human mean on the 0-1 scale.

    Rebuilds the ``survey_analysis_detailed.json`` input both agreement
    scripts consume (results.by_question.*.mean_response / 100) from the raw
    Qualtrics export: preregistered exclusions, then per-question means for
    every survey column whose question text matches an LLM prompt
    (analyze_llm_human_agreement.py:14-96)."""
    from .pipeline import (
        apply_exclusion_criteria,
        load_and_clean_survey_data,
        match_survey_to_llm_questions,
    )

    df, cols = load_and_clean_survey_data(survey_filepaths)
    clean, _ = apply_exclusion_criteria(df, cols)
    matches, _ = match_survey_to_llm_questions(llm_df, survey_filepaths)
    out: Dict[str, float] = {}
    for prompt, qid in matches.items():
        vals = frame.dropna(frame.to_numeric(frame.column(clean, qid)))
        if len(vals):
            out[prompt] = float(np.mean(np.asarray(vals, dtype=float))) / 100.0
    return out


def _matched_probs(model_df: List[Dict], human_means: Dict[str, float]):
    """(prompt, human, model) triples; relative_prob preferred, yes/no
    fallback for CSVs without it (the base-model comparison CSV) — the
    scripts' column handling (analyze_llm_human_agreement.py:100-118)."""
    rows = []
    for row in model_df:
        prompt = row["prompt"]
        if prompt not in human_means:
            continue
        if "relative_prob" in row and not frame.is_na(row.get("relative_prob")):
            p = float(row["relative_prob"])
        elif not frame.is_na(row.get("yes_prob")) and not frame.is_na(row.get("no_prob")):
            total = float(row["yes_prob"]) + float(row["no_prob"])
            p = float(row["yes_prob"]) / total if total > 0 else 0.5
        else:
            continue
        rows.append((prompt, human_means[prompt], p))
    return rows


def _model_frames(instruct_df, base_df):
    frames = []
    for kind, df in (("base", base_df), ("instruct", instruct_df)):
        if df is None:
            continue
        frames.extend((m, kind, [r for r in df if r["model"] == m])
                      for m in frame.unique(frame.column(df, "model")))
    return frames


def human_agreement_report(
    instruct_df: List[Dict],
    base_df: Optional[List[Dict]],
    human_means: Dict[str, float],
    min_questions: int = 10,
) -> Dict:
    """Point-estimate agreement per model (analyze_llm_human_agreement.py):
    MAE, RMSE, MAPE, Pearson/Spearman vs the cleaned human means, ranked by
    MAE, plus cross-model per-question variance — the exact
    ``llm_human_agreement_analysis.json`` shape (ibid.:289-307).

    The returned dict carries a non-serialized ``detailed`` list with each
    model's matched rows and 5 worst-disagreement questions (printed, not
    saved, by the reference)."""
    from scipy.stats import pearsonr, spearmanr

    results, detailed = [], []
    for model, model_type, mdf in _model_frames(instruct_df, base_df):
        rows = _matched_probs(mdf, human_means)
        if len(rows) < min_questions:
            continue
        h = np.array([r[1] for r in rows])
        p = np.array([r[2] for r in rows])
        mae = float(np.mean(np.abs(h - p)))
        rmse = float(np.sqrt(np.mean((h - p) ** 2)))
        # The reference divides unconditionally
        # (analyze_llm_human_agreement.py:130), so a near-zero human mean
        # would blow its MAPE up to inf.  No real survey question has a mean
        # <= 0.01; assert that so data violating it fails LOUDLY here rather
        # than silently dropping terms the reference would have included.
        if not (h > 0.01).all():
            raise ValueError(
                f"{model}: human mean <= 0.01 would make the reference's "
                f"unconditional MAPE non-finite")
        mape = float(np.mean(np.abs((h - p) / h)) * 100)
        pr, pp = pearsonr(h, p)
        sr, sp = spearmanr(h, p)
        order = np.argsort(-np.abs(h - p))
        worst = [
            {"prompt": rows[i][0], "human_avg": float(h[i]),
             "model_prob": float(p[i]), "difference": float(abs(h[i] - p[i]))}
            for i in order[:5]
        ]
        results.append({
            "model": model, "model_type": model_type, "mae": mae,
            "rmse": rmse, "mape": mape, "pearson_r": float(pr),
            "n_questions": len(rows),
        })
        detailed.append({
            "model": model, "model_type": model_type,
            "pearson_p": float(pp), "spearman_r": float(sr),
            "spearman_p": float(sp), "worst_questions": worst,
            "matched": rows,
        })
    order = np.argsort([r["mae"] for r in results])
    results = [results[i] for i in order]
    detailed = [detailed[i] for i in order]

    question_variance = {}
    for prompt, human_avg in human_means.items():
        probs = [p for d in detailed for (q, _, p) in d["matched"] if q == prompt]
        if probs:
            question_variance[prompt] = {
                "human_avg": float(human_avg),
                "model_mean": float(np.mean(probs)),
                "model_std": float(np.std(probs)),
                "n_models": len(probs),
            }
    return {
        "analysis_type": "llm_human_agreement",
        "description": "Comparison of LLM outputs to human average ratings "
                       "per question",
        "model_results": results,
        "question_variance": question_variance,
        "detailed": detailed,
    }


def agreement_question_bootstrap(
    instruct_df: List[Dict],
    base_df: Optional[List[Dict]],
    human_means: Dict[str, float],
    n_bootstrap: int = 1000,
    confidence_level: float = 0.95,
    seed: int = 42,
    min_questions: int = 10,
    n_diff_bootstrap: int = 10000,
) -> Dict:
    """QUESTION-level bootstrap agreement
    (analyze_llm_agreement_simple_bootstrap.py): resample question indices
    with replacement, score each model on the sampled questions, report
    mean/95% CI/std per metric, then compare base vs instruct model groups
    with a bootstrap difference CI and a permutation p-value — the exact
    ``llm_human_agreement_bootstrap.json`` shape (ibid.:440-478).

    Faithfully reproduces the reference's membership-matching quirk: a
    question drawn twice still contributes ONCE per iteration (`prompt in
    sampled_questions`, ibid.:99-106), so each iteration is effectively a
    ~63% unique-question subsample.  The reference runs numpy's global
    unseeded RNG; ``seed`` makes ours reproducible."""
    alpha = 1 - confidence_level
    rng = np.random.default_rng(seed)
    all_questions = list(human_means.keys())
    n_q = len(all_questions)
    qindex = {q: j for j, q in enumerate(all_questions)}

    model_results = []
    base_count = instruct_count = 0
    for model, model_type, mdf in _model_frames(instruct_df, base_df):
        rows = _matched_probs(mdf, human_means)
        h_full = np.full(n_q, np.nan)
        p_full = np.full(n_q, np.nan)
        for prompt, h, p in rows:
            h_full[qindex[prompt]] = h
            p_full[qindex[prompt]] = p
        per_iter = {"mae": [], "mse": [], "mape": [], "pearson_r": []}
        ok = 0
        for _ in range(n_bootstrap):
            sampled = np.unique(rng.integers(0, n_q, size=n_q))
            mask = np.zeros(n_q, bool)
            mask[sampled] = True
            mask &= np.isfinite(p_full)
            if mask.sum() < min_questions:
                continue
            ok += 1
            h = h_full[mask]
            p = p_full[mask]
            err = h - p
            per_iter["mae"].append(np.mean(np.abs(err)))
            per_iter["mse"].append(np.mean(err ** 2))
            with np.errstate(divide="ignore", invalid="ignore"):
                ape = np.abs(err / h)
            ape = ape[np.isfinite(ape)]
            per_iter["mape"].append(np.mean(ape) * 100 if ape.size else np.nan)
            if h.std() > 0 and p.std() > 0:
                per_iter["pearson_r"].append(float(np.corrcoef(h, p)[0, 1]))
            else:
                per_iter["pearson_r"].append(np.nan)
        # the reference's "at least 100 successful bootstraps" floor, scaled
        # down when the caller requests fewer iterations overall (otherwise a
        # small --bootstrap run silently drops every model)
        if ok < min(100, n_bootstrap):
            continue
        rec = {"model": model, "model_type": model_type, "n_bootstrap": ok}
        for metric, vals in per_iter.items():
            rec.update(_metric_summary(metric, vals, alpha))
        model_results.append(rec)
        if model_type == "base":
            base_count += 1
        else:
            instruct_count += 1

    model_results.sort(key=lambda r: r["mae_mean"])

    overall = {"base_models_count": base_count,
               "instruct_models_count": instruct_count, "metrics": {}}
    base_recs = [r for r in model_results if r["model_type"] == "base"]
    inst_recs = [r for r in model_results if r["model_type"] == "instruct"]
    for metric in ("mae", "mse", "mape"):
        bv = np.array([r[f"{metric}_mean"] for r in base_recs
                       if np.isfinite(r[f"{metric}_mean"])])
        iv = np.array([r[f"{metric}_mean"] for r in inst_recs
                       if np.isfinite(r[f"{metric}_mean"])])
        if not (bv.size and iv.size):
            continue
        diff = float(bv.mean() - iv.mean())
        n1, n2 = len(bv), len(iv)
        boot = np.empty(n_diff_bootstrap)
        for b in range(n_diff_bootstrap):
            boot[b] = (rng.choice(bv, n1, replace=True).mean()
                       - rng.choice(iv, n2, replace=True).mean())
        pooled = np.concatenate([bv, iv])
        null = np.empty(n_diff_bootstrap)
        for b in range(n_diff_bootstrap):
            perm = rng.permutation(pooled)
            null[b] = perm[:n1].mean() - perm[n1:].mean()
        lo, hi = alpha / 2 * 100, (1 - alpha / 2) * 100
        overall["metrics"][metric] = {
            "base_mean": float(bv.mean()),
            "base_ci": [float(np.percentile(bv, lo)), float(np.percentile(bv, hi))],
            "instruct_mean": float(iv.mean()),
            "instruct_ci": [float(np.percentile(iv, lo)), float(np.percentile(iv, hi))],
            "difference": diff,
            "difference_ci": [float(np.percentile(boot, lo)),
                              float(np.percentile(boot, hi))],
            "p_value": float(np.mean(np.abs(null) >= abs(diff))),
        }
    return {
        "analysis_type": "llm_human_agreement_bootstrap_questions",
        "description": "Comparison of LLM outputs to human average ratings "
                       "with bootstrap confidence intervals (sampling "
                       "questions)",
        "bootstrap_parameters": {
            "n_iterations": n_bootstrap,
            "confidence_level": confidence_level,
            "bootstrap_method": "questions_with_replacement",
        },
        "model_results": model_results,
        "overall_comparison": overall,
    }
