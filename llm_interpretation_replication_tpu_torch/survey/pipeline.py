"""Human-survey analysis pipeline (reference: survey_analysis/, 4,727 LoC).

Behavioral replicas of survey_analysis_consolidated.py: Qualtrics loading with
S{n}_ prefixing, the three preregistered exclusions, header question-text
extraction and exact-string matching to LLM prompts, per-question stats,
human–LLM correlation with bootstrap, per-item pairwise agreement, and the
cross-prompt (within-group) correlation machinery with bootstrap-by-question.

A copy of the JAX package's module on row dicts (``utils.frame``): a survey
or a results file is the list of its rows, each holding every column (NaN
for an empty cell).  The all-pairs rater correlation is
``utils.frame.pairwise_corr`` (``DataFrame.corr``'s algorithm on small
matrices; exact integer sums with masked matrix products on the survey's
hundreds of respondents, a resample's repeated questions as row weights).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import pearsonr

from ..utils import frame

DURATION = "Duration (in seconds)"


# ---------------------------------------------------------------------------
# Loading / cleaning
# ---------------------------------------------------------------------------

def load_and_clean_survey_data(filepaths) -> Tuple[List[Dict], List[str]]:
    """Load Qualtrics exports (2 meta rows skipped), prefix question columns
    with S{survey}_ and coerce them (and Duration) to numeric."""
    if isinstance(filepaths, str):
        filepaths = [filepaths]
    columns: List[str] = []
    parts = []
    for survey_idx, filepath in enumerate(filepaths, start=1):
        cols, rows = frame.read_csv(filepath)
        rename = {}
        for group in range(1, 6):
            for question in range(1, 12):
                old = f"Q{group}_{question}"
                if old in cols:
                    rename[old] = f"S{survey_idx}_Q{group}_{question}"
        cols = [rename.get(c, c) for c in cols]
        columns += [c for c in cols if c not in columns]
        parts.append([{rename.get(k, k): v for k, v in r.items()}
                      for r in rows[2:]])
    df = [{c: r.get(c, frame.NAN) for c in columns} for part in parts
          for r in part]
    for r, v in zip(df, frame.to_numeric(frame.column(df, DURATION))):
        r[DURATION] = v
    question_cols = []
    for survey_idx in range(1, len(filepaths) + 1):
        for group in range(1, 6):
            for question in range(1, 12):
                col = f"S{survey_idx}_Q{group}_{question}"
                if col in columns:
                    question_cols.append(col)
                    for r, v in zip(df, frame.to_numeric(frame.column(df, col))):
                        r[col] = v
    return df, question_cols


def apply_exclusion_criteria(df: List[Dict], question_cols: Sequence[str]):
    """Preregistered exclusions: (1) duration < 20% of median, (2) identical
    substantive slider values, (3) any attention check (\\*_8) ≠ 100."""
    initial = len(df)
    stats: Dict = {}

    durations = frame.dropna(frame.column(df, DURATION))
    median_duration = frame.median(durations)
    min_duration = 0.2 * median_duration
    stats["median_duration"] = median_duration
    stats["min_duration_threshold"] = min_duration
    stats["duration_excluded"] = int(sum(
        1 for r in df if r[DURATION] < min_duration))
    df = [r for r in df if r[DURATION] >= min_duration]

    substantive = [q for q in question_cols if not q.endswith("_8")]
    identical = set()
    for i, row in enumerate(df):
        answered = [q for q in substantive if not frame.is_na(row[q])]
        if len(answered) > 1:
            values = {row[q] for q in answered}
            if len(values) == 1:
                identical.add(i)
    stats["identical_excluded"] = len(identical)
    df = [r for i, r in enumerate(df) if i not in identical]

    attention_cols = [q for q in question_cols if q.endswith("_8")]
    failed = set()
    for i, row in enumerate(df):
        for col in attention_cols:
            if not frame.is_na(row[col]) and row[col] != 100:
                failed.add(i)
                break
    stats["attention_failed"] = len(failed)
    df = [r for i, r in enumerate(df) if i not in failed]

    stats["final_count"] = len(df)
    stats["total_excluded"] = initial - len(df)
    return df, stats


def extract_question_text(filepaths) -> Dict[str, str]:
    """S{n}_Q{g}_{q} -> question text parsed from the Qualtrics header row
    (last ' - '-separated segment)."""
    if isinstance(filepaths, str):
        filepaths = [filepaths]
    mapping: Dict[str, str] = {}
    for survey_idx, filepath in enumerate(filepaths, start=1):
        columns, rows = frame.read_csv(filepath)
        headers = rows[0]
        for col in columns:
            if col.startswith("Q") and "_" in col:
                text = headers[col]
                if not frame.is_na(text) and isinstance(text, str) and " - " in text:
                    mapping[f"S{survey_idx}_{col}"] = text.split(" - ")[-1].strip()
    return mapping


def match_survey_to_llm_questions(llm_df: List[Dict], survey_filepaths) -> Tuple[Dict, Dict]:
    """Exact question-text join of LLM prompts onto survey columns."""
    mapping = extract_question_text(survey_filepaths)
    mapping = {k: v for k, v in mapping.items() if not k.endswith("_8")}
    prompt_to_question = {text: qid for qid, text in mapping.items()}
    matches = {
        prompt: prompt_to_question[prompt]
        for prompt in frame.unique(frame.column(llm_df, "prompt"))
        if prompt in prompt_to_question
    }
    return matches, mapping


# ---------------------------------------------------------------------------
# Per-question stats + correlation
# ---------------------------------------------------------------------------

def human_responses_by_question(df: List[Dict], question_cols: Sequence[str]) -> Dict:
    out = {}
    for q in question_cols:
        if q.endswith("_8"):
            continue
        responses = frame.dropna(frame.column(df, q))
        if len(responses):
            arr = np.asarray(responses, dtype=float)
            out[q] = {
                "mean": float(np.mean(arr)),
                "std": float(np.std(arr)),
                "n": int(len(responses)),
                "responses": list(responses),
            }
    return out


def llm_responses_by_question(llm_df: List[Dict]) -> Dict:
    out = {}
    for prompt in frame.unique(frame.column(llm_df, "prompt")):
        vals = np.asarray([r["relative_prob"] for r in llm_df
                           if r["prompt"] == prompt], dtype=float)
        out[prompt] = {
            "mean": float(_nanmean(vals)),
            "std": float(_nanstd(vals)),
            "n": int(len(vals)),
            "model_responses": vals.tolist(),
        }
    return out


def _nanmean(vals: np.ndarray) -> float:
    """``np.mean`` of a Series: NaNs are skipped (counted out, summed as
    0)."""
    ok = ~np.isnan(vals)
    if not ok.any():
        return float("nan")
    return np.where(ok, vals, 0.0).sum() / ok.sum()


def _nanstd(vals: np.ndarray) -> float:
    """``np.std`` of a Series (pandas' two-pass ``nanvar`` at ddof 0)."""
    ok = ~np.isnan(vals)
    count = ok.sum()
    if not count:
        return float("nan")
    filled = np.where(ok, vals, 0.0)
    avg = filled.sum(dtype=np.float64) / count
    sqr = np.where(ok, (avg - filled) ** 2, 0.0)
    return np.sqrt(sqr.sum(dtype=np.float64) / count)


def pearson_with_bootstrap(x, y, n_bootstrap: int = 1000, confidence_level: float = 0.95,
                           seed: int = 42) -> Dict:
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    corr, p_value = pearsonr(x, y)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(n_bootstrap, len(x)))
    boots = np.array([pearsonr(x[row], y[row])[0] for row in idx])
    alpha = 1 - confidence_level
    return {
        "correlation": float(corr),
        "p_value": float(p_value),
        "ci_lower": float(np.percentile(boots, 100 * alpha / 2)),
        "ci_upper": float(np.percentile(boots, 100 * (1 - alpha / 2))),
        "standard_error": float(np.std(boots)),
    }


def human_llm_correlation(human_stats: Dict, llm_stats: Dict, matches: Dict,
                          seed: int = 42) -> Optional[Dict]:
    human_means, llm_means, matched = [], [], []
    for llm_prompt, survey_q in matches.items():
        if survey_q in human_stats and llm_prompt in llm_stats:
            h = human_stats[survey_q]["mean"] / 100.0
            m = llm_stats[llm_prompt]["mean"]
            human_means.append(h)
            llm_means.append(m)
            matched.append(
                {"survey_question": survey_q, "llm_prompt": llm_prompt,
                 "human_mean": h, "llm_mean": m}
            )
    if len(human_means) < 2:
        return None
    result = pearson_with_bootstrap(human_means, llm_means, seed=seed)
    result["n_questions"] = len(human_means)
    result["matched_questions"] = matched
    return result


# ---------------------------------------------------------------------------
# Per-item agreement (1 − |Δ|)
# ---------------------------------------------------------------------------

def _pairwise_agreements(values: np.ndarray, scale: float) -> np.ndarray:
    """mean over pairs of (scale − |vi − vj|)/scale without the O(n²) loop."""
    diffs = np.abs(values[:, None] - values[None, :])
    iu = np.triu_indices(len(values), k=1)
    return (scale - diffs[iu]) / scale


def per_item_agreement_humans(df: List[Dict], question_cols: Sequence[str],
                              n_bootstrap: int = 1000, seed: int = 42) -> Dict:
    per_item, avgs = {}, []
    for q in question_cols:
        if q.endswith("_8"):
            continue
        responses = np.asarray(frame.dropna(frame.column(df, q)), dtype=float)
        if len(responses) >= 2:
            agreements = _pairwise_agreements(responses, 100.0)
            per_item[q] = {
                "mean_agreement": float(np.mean(agreements)),
                "std_agreement": float(np.std(agreements)),
                "n_pairs": int(len(agreements)),
                "response_variance": float(np.var(responses)),
                "n_responses": int(len(responses)),
            }
            avgs.append(float(np.mean(agreements)))
    return _agreement_summary(per_item, avgs, n_bootstrap, seed)


def per_item_agreement_llms(llm_df: List[Dict], n_bootstrap: int = 1000,
                            seed: int = 42) -> Dict:
    per_item, avgs = {}, []
    models = frame.unique(frame.column(llm_df, "model"))
    for prompt in frame.unique(frame.column(llm_df, "prompt")):
        sub = [r for r in llm_df if r["prompt"] == prompt]
        vals = []
        for model in models:
            v = [r["relative_prob"] for r in sub if r["model"] == model]
            if len(v) and not np.isnan(v[0]):
                vals.append(float(v[0]))
        if len(vals) >= 2:
            agreements = _pairwise_agreements(np.asarray(vals), 1.0)
            per_item[prompt] = {
                "mean_agreement": float(np.mean(agreements)),
                "std_agreement": float(np.std(agreements)),
                "n_pairs": int(len(agreements)),
                "response_variance": float(np.var(vals)),
                "n_models": len(vals),
            }
            avgs.append(float(np.mean(agreements)))
    return _agreement_summary(per_item, avgs, n_bootstrap, seed)


def _agreement_summary(per_item, avgs, n_bootstrap, seed):
    if avgs:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(avgs), size=(n_bootstrap, len(avgs)))
        boots = np.mean(np.asarray(avgs)[idx], axis=1)
        ci = (float(np.percentile(boots, 2.5)), float(np.percentile(boots, 97.5)))
    else:
        ci = (0.0, 0.0)
    return {
        "per_item": per_item,
        "overall_mean": float(np.mean(avgs)) if avgs else 0.0,
        "overall_std": float(np.std(avgs)) if avgs else 0.0,
        "n_items": len(avgs),
        "overall_mean_ci_lower": ci[0],
        "overall_mean_ci_upper": ci[1],
    }


# ---------------------------------------------------------------------------
# Cross-prompt (within-group) correlations
# ---------------------------------------------------------------------------

def _question_groups(question_cols: Sequence[str]) -> Dict[str, List[str]]:
    groups: Dict[str, List[str]] = {}
    for col in question_cols:
        if col.endswith("_8"):
            continue
        prefix = col.rsplit("_", 1)[0]  # S1_Q3
        groups.setdefault(prefix, []).append(col)
    return dict(sorted(groups.items()))


def _rater_matrix(df: List[Dict], group_questions: List[str], min_answered: int = 5):
    """questions × respondents matrix (0-1 scale) for raters who answered ≥5."""
    first = group_questions[0]
    sub = [r for r in df if not frame.is_na(r[first])]
    data = np.asarray([[r[q] for q in group_questions] for r in sub],
                      dtype=float).reshape(len(sub), len(group_questions)) / 100.0
    keep = np.sum(~np.isnan(data), axis=1) >= min_answered
    return data[keep].T


def _pairwise_rater_values(matrix: np.ndarray, rows=None) -> np.ndarray:
    """The non-NaN upper-triangle correlations of ``matrix``'s columns
    (over ``rows``, a resample's row draws) in row-major order."""
    corr = frame.pairwise_corr(matrix, rows=rows)
    vals = corr[np.triu_indices(corr.shape[0], k=1)]
    return vals[~np.isnan(vals)]


def _pairwise_rater_correlations(matrix: np.ndarray, rows=None) -> List[float]:
    return _pairwise_rater_values(matrix, rows).tolist()


def _cross_prompt_summary(all_corrs, group_results, boot_means) -> Dict:
    base_mean = float(np.mean(all_corrs)) if all_corrs else 0.0
    ci = (
        (float(np.percentile(boot_means, 2.5)), float(np.percentile(boot_means, 97.5)))
        if boot_means
        else (base_mean, base_mean)
    )
    return {
        "group_results": group_results,
        "pairwise_correlations": all_corrs,
        "mean_correlation": base_mean,
        "std_correlation": float(np.std(all_corrs)) if all_corrs else 0.0,
        "n_pairs": len(all_corrs),
        "ci_lower": ci[0],
        "ci_upper": ci[1],
    }


def human_cross_prompt_correlations(df: List[Dict], question_cols: Sequence[str],
                                    n_bootstrap: int = 100, seed: int = 42) -> Dict:
    """All-pairs rater correlations within each 10-question group; CI from
    resampling questions within groups."""
    groups = _question_groups(question_cols)
    all_corrs: List[float] = []
    group_results: Dict[str, Dict] = {}
    matrices: Dict[str, np.ndarray] = {}
    for group_id, questions in groups.items():
        if len(questions) < 2:
            continue
        matrix = _rater_matrix(df, questions)
        matrices[group_id] = matrix
        if matrix.shape[1] < 2:
            continue
        corrs = _pairwise_rater_correlations(matrix)
        all_corrs.extend(corrs)
        group_results[group_id] = {
            "n_respondents": matrix.shape[1],
            "n_pairs": len(corrs),
            "mean_correlation": float(np.mean(corrs)) if corrs else 0.0,
            "correlations": corrs,
        }
    rng = np.random.default_rng(seed)
    boot_means = []
    for _ in range(n_bootstrap):
        boot_corrs: List[float] = []
        for group_id, questions in groups.items():
            if group_id not in group_results or len(questions) < 2:
                continue
            sampled = rng.integers(0, len(questions), size=len(questions))
            matrix = matrices[group_id]
            if matrix.shape[1] < 2:
                continue
            boot_corrs.append(_pairwise_rater_values(matrix, sampled))
        if boot_corrs and sum(map(len, boot_corrs)):
            boot_means.append(np.mean(np.concatenate(boot_corrs)))
    return _cross_prompt_summary(all_corrs, group_results, boot_means)


def llm_cross_prompt_correlations(llm_df: List[Dict], question_mapping: Dict[str, str],
                                  n_bootstrap: int = 100, seed: int = 42) -> Dict:
    """Model-pair correlations within the human question groups: each model is
    a 'rater' over the group's questions."""
    text_to_qid = {}
    for qid, text in question_mapping.items():
        if not qid.endswith("_8"):
            text_to_qid[text] = qid
    llm = []
    for r in llm_df:
        qid = text_to_qid.get(r["prompt"])
        if qid is not None:
            llm.append(dict(r, question_id=qid, group=qid.rsplit("_", 1)[0]))

    all_corrs: List[float] = []
    group_results: Dict[str, Dict] = {}
    groups = sorted(frame.unique(frame.column(llm, "group")))
    pivots = {}
    for group_id in groups:
        sub = [r for r in llm if r["group"] == group_id]
        pivot = frame.Pivot(*frame.pivot_mean(sub, "question_id", "model",
                                              "relative_prob"))
        pivots[group_id] = pivot
        n_q, n_m = pivot.values.shape
        if n_q < 2 or n_m < 2:
            continue
        corrs = _pairwise_rater_correlations(pivot.values)
        all_corrs.extend(corrs)
        group_results[group_id] = {
            "n_models": n_m,
            "n_questions": n_q,
            "n_pairs": len(corrs),
            "mean_correlation": float(np.mean(corrs)) if corrs else 0.0,
            "correlations": corrs,
        }
    rng = np.random.default_rng(seed)
    boot_means = []
    for _ in range(n_bootstrap):
        boot_corrs: List[float] = []
        for group_id, pivot in pivots.items():
            n_q = pivot.values.shape[0]
            if group_id not in group_results or n_q < 2:
                continue
            sampled = pivot.values[rng.integers(0, n_q, size=n_q)]
            boot_corrs.extend(_pairwise_rater_correlations(sampled))
        if boot_corrs:
            boot_means.append(np.mean(boot_corrs))
    return _cross_prompt_summary(all_corrs, group_results, boot_means)


def _resampled_means(rng, pool: np.ndarray, n_bootstrap: int,
                     cells: int = 1 << 24) -> np.ndarray:
    """``np.mean(pool[rng.integers(0, len(pool), size=(n_bootstrap,
    len(pool)))], axis=1)`` a block of rows at a time: the same draws
    (the generator's stream does not depend on how its draws are split
    into calls) in at most ``cells`` indices at once, where the one draw
    takes 16 bytes a pair and resample (~14 GB at the study's 1,003
    respondents and 1,000 resamples)."""
    n = len(pool)
    step = max(1, cells // max(n, 1))
    out = np.empty(n_bootstrap)
    for start in range(0, n_bootstrap, step):
        m = min(step, n_bootstrap - start)
        out[start:start + m] = np.mean(pool[rng.integers(0, n, size=(m, n))],
                                       axis=1)
    return out


def cross_prompt_difference_ci(human_result: Dict, llm_result: Dict,
                               n_bootstrap: int = 1000, seed: int = 42) -> Dict:
    """CI for (human − LLM) mean cross-prompt correlation by resampling each
    side's pairwise-correlation pool (survey_analysis_consolidated.py:676-807)."""
    h = np.asarray(human_result["pairwise_correlations"], dtype=float)
    l = np.asarray(llm_result["pairwise_correlations"], dtype=float)
    observed = float(np.mean(h) - np.mean(l))
    rng = np.random.default_rng(seed)
    hb = _resampled_means(rng, h, n_bootstrap)
    lb = _resampled_means(rng, l, n_bootstrap)
    diffs = hb - lb
    if observed > 0:
        p = 2 * float(np.mean(diffs <= 0))
    else:
        p = 2 * float(np.mean(diffs >= 0))
    return {
        "difference": observed,
        "ci_lower": float(np.percentile(diffs, 2.5)),
        "ci_upper": float(np.percentile(diffs, 97.5)),
        "p_value": min(p, 1.0),
    }


def meta_correlation(human_agreements: Dict, llm_agreements: Dict,
                     matches: Dict, n_bootstrap: int = 1000,
                     seed: int = 42) -> Dict:
    """Correlation between per-item human and LLM agreement patterns
    (survey_analysis_consolidated.py:808-852): do humans and models find the
    SAME questions contentious?"""
    h_vals, l_vals = [], []
    for llm_prompt, survey_q in matches.items():
        h = human_agreements["per_item"].get(survey_q)
        l = llm_agreements["per_item"].get(llm_prompt)
        if h is not None and l is not None:
            h_vals.append(h["mean_agreement"])
            l_vals.append(l["mean_agreement"])
    base = {
        "n_matched_items": len(h_vals),
        "human_mean_agreement": human_agreements["overall_mean"],
        "human_std_agreement": human_agreements["overall_std"],
        "llm_mean_agreement": llm_agreements["overall_mean"],
        "llm_std_agreement": llm_agreements["overall_std"],
    }
    if len(h_vals) < 2:
        return {**base, "correlation": None,
                "interpretation": "Insufficient matched items for correlation"}
    result = pearson_with_bootstrap(h_vals, l_vals, n_bootstrap=n_bootstrap, seed=seed)
    return {**base, **result,
            "interpretation": "Correlation between human and LLM per-item "
                              "agreement patterns"}


def run_consolidated_analysis(
    survey_csvs: Sequence[str],
    llm_csv: str,
    output_dir: str,
    n_bootstrap: int = 1000,
    cross_prompt_bootstrap: int = 100,
    seed: int = 42,
    log=print,
) -> Dict:
    """The consolidated survey analysis end-to-end
    (survey_analysis_consolidated.py main(), :1028-1104): load + clean both
    survey parts, apply the preregistered exclusions, match LLM prompts,
    compute human/LLM stats, question-level correlation, per-item agreements,
    meta-correlation, cross-prompt correlations and their difference CI, then
    write ``report.txt`` + ``results.json``."""
    os.makedirs(output_dir, exist_ok=True)
    df, cols = load_and_clean_survey_data(survey_csvs)
    _, llm_df = frame.read_csv(llm_csv)
    clean, exclusions = apply_exclusion_criteria(df, cols)
    log(f"Exclusions: {exclusions}")
    matches, mapping = match_survey_to_llm_questions(llm_df, survey_csvs)
    human_stats = human_responses_by_question(clean, cols)
    llm_stats = llm_responses_by_question(llm_df)
    corr = human_llm_correlation(human_stats, llm_stats, matches, seed=seed)
    hum_item = per_item_agreement_humans(clean, cols, n_bootstrap=n_bootstrap, seed=seed)
    llm_item = per_item_agreement_llms(llm_df, n_bootstrap=n_bootstrap, seed=seed)
    meta = meta_correlation(hum_item, llm_item, matches, n_bootstrap=n_bootstrap, seed=seed)
    hum_cp = human_cross_prompt_correlations(clean, cols, n_bootstrap=cross_prompt_bootstrap, seed=seed)
    llm_cp = llm_cross_prompt_correlations(llm_df, mapping, n_bootstrap=cross_prompt_bootstrap, seed=seed)
    diff = cross_prompt_difference_ci(hum_cp, llm_cp, n_bootstrap=n_bootstrap, seed=seed)

    results = {
        "exclusions": exclusions,
        "n_survey_questions": len(human_stats),
        "n_llm_prompts": len(llm_stats),
        "n_matched": len(matches),
        "human_llm_correlation": (
            {k: v for k, v in corr.items() if k != "matched_questions"}
            if corr else None
        ),
        "human_agreement": {k: v for k, v in hum_item.items() if k != "per_item"},
        "llm_agreement": {k: v for k, v in llm_item.items() if k != "per_item"},
        "meta_correlation": meta,
        # per-pair pools are large; the report keeps the summary statistics
        "human_cross_prompt": {k: v for k, v in hum_cp.items()
                               if k not in ("group_results", "pairwise_correlations")},
        "llm_cross_prompt": {k: v for k, v in llm_cp.items()
                             if k not in ("group_results", "pairwise_correlations")},
        "cross_prompt_difference": diff,
    }
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)

    lines = [
        "=" * 80,
        "CONSOLIDATED SURVEY ANALYSIS - HUMAN vs LLM ORDINARY MEANING AGREEMENT",
        "=" * 80,
        "",
        "EXCLUSION STATISTICS:",
        f"  Initial respondents: {exclusions['final_count'] + exclusions['total_excluded']}",
        f"  Excluded for short duration: {exclusions['duration_excluded']}",
        f"  Excluded for identical responses: {exclusions['identical_excluded']}",
        f"  Excluded for attention check failure: {exclusions['attention_failed']}",
        f"  Final sample size: {exclusions['final_count']}",
        "",
        "QUESTION MATCHING:",
        f"  Survey questions: {len(human_stats)}; LLM prompts: {len(llm_stats)}; "
        f"matched: {len(matches)}",
        "",
    ]
    if corr:
        lines += [
            "HUMAN-LLM CORRELATION (question level):",
            f"  Pearson r = {corr['correlation']:.3f} "
            f"[{corr['ci_lower']:.3f}, {corr['ci_upper']:.3f}] "
            f"(n={corr['n_questions']})",
            "",
        ]
    lines += [
        "PER-ITEM AGREEMENT (1 - |delta|):",
        f"  Humans: {hum_item['overall_mean']:.3f} over {hum_item['n_items']} items",
        f"  LLMs:   {llm_item['overall_mean']:.3f} over {llm_item['n_items']} items",
        "",
        "CROSS-PROMPT CORRELATIONS (within 10-question groups):",
        f"  Humans: {hum_cp['mean_correlation']:.3f} "
        f"[{hum_cp['ci_lower']:.3f}, {hum_cp['ci_upper']:.3f}]",
        f"  LLMs:   {llm_cp['mean_correlation']:.3f} "
        f"[{llm_cp['ci_lower']:.3f}, {llm_cp['ci_upper']:.3f}]",
        f"  Difference: {diff['difference']:.3f} "
        f"[{diff['ci_lower']:.3f}, {diff['ci_upper']:.3f}], p={diff['p_value']:.4f}",
    ]
    with open(os.path.join(output_dir, "report.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    log("\n".join(lines))
    return results
